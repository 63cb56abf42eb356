// The gated family's survivor rescan (sm_90a): the full Teddy class filter
// over the 128-byte rows that the gate (teddy_gate.cu) flagged, with per-cell
// candidate compaction.
//
// Replaces stage 2 of the Pallas gated family: _make_kernel_fused_classes
// (hyperscan_tpu/ops/teddy.py:572) in plane mode over the packed survivor
// rows, the pallas_call at hyperscan_tpu/ops/teddy.py:1424, with the
// extraction that follows it.
//
// What it computes. For every 64 KiB cell, the exact number of candidates
// of the full filter (teddy_filter_compact.cu) that end inside the cell's
// flagged rows, and the first `capc` of them in ascending order; the count
// stays exact past capc. Because the gate is a superset of the filter, this
// equals kernel A's compact mode. With the gate's per-cell row counts
// (`row_counts`, the sums of the flags), a cell whose count is 0 gets
// count 0 and nothing else is read or written for it.
//
// What bounds it. The filter's table reads for the flagged rows only: M x W
// shared-memory words a byte of a flagged row against 132 SMs x 32 words a
// clock (a few percent of the corpus at iid); with few flagged rows, the
// row counts, the flags of the cells with rows and the counts written.
//
// Design. One warp a cell, not one block a cell: each block stages the
// replicated tables once (teddy_filter.cuh) and its 8 warps then take cells
// on their own (cell = global warp index, strided by the warps of the grid),
// with no block barrier inside a cell. A warp loads a cell's 512 flags as
// one 16-byte load a lane, lists the flagged rows in its slice of shared
// memory by a warp scan of per-lane popcounts, and filters 4
// rows a step (8 lanes a row, 16 bytes a lane; the row's first lane reloads
// the 16 bytes before the row for the look-back, the others take theirs
// from the lane to their left). The next cell's flags, and the next step's
// 16 bytes, are loaded before the current ones are used. Ranks come from a
// warp scan, so positions come out ascending. With row counts, the warps
// first read the counts of their cells, write 0 for the empty ones and skip
// them, and a block whose cells are all empty returns before it stages any
// table. A cell with more than kHot flagged rows (a row flood) would hold
// one warp for up to 128 steps: such cells go to a list in shared memory
// and, once the block's warps are done, the whole block filters them 32 rows
// a step with block-wide scans for the ranks (the grid is sized so that a
// warp takes at most 16 cells, so the list holds all of a block's). The TPU packed (predecessor, row) pairs of
// the survivors into a second rows array at a learned capacity; here each
// row and its look-back are read from the flat corpus, so no survivor list,
// capacity or packing exists.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

constexpr int kLanesPerRow = kRowBytes / kChunk;       // 8
constexpr int kWarpRows = 32 / kLanesPerRow;           // rows a warp a step
constexpr int kBlockRows = kThreads / kLanesPerRow;    // rows a block a step
constexpr int kHot = 32;  // flagged rows above which the block takes a cell
// cells a warp takes at most (the launch sizes the grid for it): one lane
// holds one of them, and the block's hot list holds all of the block's
constexpr int kWarpCells = 16;
constexpr int kBlockCells = kWarps * kWarpCells;
static_assert(kRowsPerCell == 32 * 16, "16 row flags a lane");
static_assert(kWarpCells <= 32, "a lane a cell");

// bit k set <=> flag byte k of the 16 is nonzero
__device__ __forceinline__ uint32_t flag_mask(const uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t t = __vcmpne4(w[i], 0u);  // 0xFF per nonzero byte
    m |= ((t >> 7) & 1u | (t >> 14) & 2u | (t >> 21) & 4u | (t >> 28) & 8u)
         << (4 * i);
  }
  return m;
}

__device__ __forceinline__ uint4 load_flags(const uint8_t* __restrict__ f,
                                            int cell, int lane) {
  return *reinterpret_cast<const uint4*>(f + (long long)cell * kRowsPerCell +
                                         lane * 16);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

struct Args {
  const uint8_t* corpus;
  long long n;
  const uint32_t* s_tab;
  const uint8_t* s_b2c;
  int H, R, capc;
  const uint8_t* flags;
  int32_t* out_pos;
  int32_t* counts;
};

// One cell by one warp; `f` is the lane's 16 flags of it. A hot cell goes
// to the block's hot list instead, and nothing is written for it here.
template <int M, int V>
__device__ __forceinline__ void warp_cell(const Args& a, int cell, uint4 f,
                                          int16_t* rows, int* s_hot,
                                          int* s_n_hot) {
  const int lane = threadIdx.x & 31;
  uint32_t m = flag_mask(f);
  const int c = __popc(m);
  const int incl = warp_incl_scan(c, lane);
  const int total = __shfl_sync(kFull, incl, 31);
  if (total > kHot) {
    if (lane == 0) s_hot[atomicAdd(s_n_hot, 1)] = cell;
    return;
  }
  for (int off = incl - c; m; m &= m - 1)
    rows[off++] = int16_t(16 * lane + __ffs(m) - 1);
  __syncwarp();

  const long long n = a.n;
  const long long cell0 = (long long)cell * kCell;
  int32_t* out = a.out_pos + (long long)cell * a.capc;
  const int sub = lane % kLanesPerRow;
  const bool reload = sub == 0;  // the lane to the left holds another row
  // an idle lane sits at n rounded up to 16 (aligned loads): no byte below
  // n, so no candidate
  const long long idle = (n + 15) & ~15ll;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto start = [&](int s) -> long long {
    const int slot = s + lane / kLanesPerRow;
    return slot < total
               ? cell0 + (long long)rows[slot] * kRowBytes + sub * kChunk
               : idle;
  };
  long long p0 = start(0);
  uint4 cur = load16(a.corpus, n, p0);
  uint4 prev = reload ? load16(a.corpus, n, p0 - 16) : zero;
  int running = 0;
  for (int s = 0; s < total; s += kWarpRows) {
    // the next step's bytes are loaded before this step's are used
    const long long p1 = start(s + kWarpRows);
    uint4 ncur = zero, nprev = zero;
    if (s + kWarpRows < total) {
      ncur = load16(a.corpus, n, p1);
      if (reload) nprev = load16(a.corpus, n, p1 - 16);
    }
    uint32_t pz = __shfl_up_sync(kFull, cur.z, 1);
    uint32_t pw = __shfl_up_sync(kFull, cur.w, 1);
    if (reload) {
      pz = prev.z;
      pw = prev.w;
    }
    const uint32_t win[6] = {pz, pw, cur.x, cur.y, cur.z, cur.w};
    uint32_t bits =
        cand_bits<M, true, V>(win, a.s_b2c, a.s_tab, a.H, a.R, p0, n);
    const int cnt = __popc(bits);
    const int inc = warp_incl_scan(cnt, lane);
    int r = running + inc - cnt;
    for (; bits; bits &= bits - 1, ++r)
      if (r < a.capc) out[r] = int32_t(p0 + __ffs(bits) - 1);
    running += __shfl_sync(kFull, inc, 31);
    p0 = p1;
    cur = ncur;
    prev = nprev;
  }
  if (lane == 0) a.counts[cell] = running;
  __syncwarp();  // the next cell rewrites the row list
}

// One cell by the whole block, 32 rows a step; `rows` holds 512 entries.
// Every thread of the block must call it.
template <int M, int V>
__device__ __forceinline__ void block_cell(const Args& a, int cell,
                                           int16_t* rows, int* s_warp) {
  const int tid = threadIdx.x;
  const uint8_t* f = a.flags + (long long)cell * kRowsPerCell;
  const int f0 = f[2 * tid] != 0;
  const int f1 = f[2 * tid + 1] != 0;
  int n_rows;
  // the scan's barriers also keep the previous cell's readers of `rows`
  // ahead of these writes
  const int off = block_scan(f0 + f1, s_warp, n_rows);
  if (f0) rows[off] = int16_t(2 * tid);
  if (f1) rows[off + f0] = int16_t(2 * tid + 1);
  __syncthreads();
  const long long n = a.n;
  const long long cell0 = (long long)cell * kCell;
  int32_t* out = a.out_pos + (long long)cell * a.capc;
  int running = 0;
  for (int s = 0; s < n_rows; s += kBlockRows) {
    const int slot = s + tid / kLanesPerRow;
    const long long p0 =
        slot < n_rows ? cell0 + (long long)rows[slot] * kRowBytes +
                            (tid % kLanesPerRow) * kChunk
                      : (n + 15) & ~15ll;
    uint32_t win[6];
    load_window(a.corpus, n, p0, tid % kLanesPerRow == 0, win);
    uint32_t bits =
        cand_bits<M, true, V>(win, a.s_b2c, a.s_tab, a.H, a.R, p0, n);
    int step_total;
    int r = running + block_scan(__popc(bits), s_warp, step_total);
    for (; bits; bits &= bits - 1, ++r)
      if (r < a.capc) out[r] = int32_t(p0 + __ffs(bits) - 1);
    running += step_total;
  }
  if (tid == 0) a.counts[cell] = running;
}

template <int M, int V>
__global__ void __launch_bounds__(kThreads)
rescan_kernel(const uint8_t* __restrict__ corpus, long long n,
              const uint8_t* __restrict__ b2c,
              const uint32_t* __restrict__ tabs, int H, int R, int capc,
              const uint8_t* __restrict__ row_flags,
              const int32_t* __restrict__ row_counts, int n_cells,
              int32_t* __restrict__ out_pos, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][128][R][V]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_warp[kWarps];
  __shared__ int16_t s_rows[kWarps][kRowsPerCell];
  __shared__ int s_hot[kBlockCells];
  __shared__ int s_n_hot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // lane k of a warp holds the warp's k-th cell (cells strided by the
  // warps of the grid)
  const int mine = blockIdx.x * kWarps + warp + lane * gridDim.x * kWarps;
  const bool valid = lane < kWarpCells && mine < n_cells;
  int rc = -1;  // flagged rows of the lane's cell, when the counts are given
  if (tid == 0) s_n_hot = 0;
  if (row_counts != nullptr) {
    // the empty cells are done here; a block with no other cell stages no
    // table
    if (valid) {
      rc = row_counts[mine];
      if (rc == 0) counts[mine] = 0;
    }
    if (!__syncthreads_or(valid && rc != 0)) return;
  }
  stage_tables<V>(s_tab, tabs, M, 128, H, R);
  s_b2c[tid] = b2c[tid];  // kThreads == 256
  __syncthreads();

  const Args a{corpus, n, s_tab, s_b2c, H, R, capc, row_flags, out_pos,
               counts};
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  bool todo = valid && rc != 0;
  if (todo && rc > kHot) {
    s_hot[atomicAdd(&s_n_hot, 1)] = mine;
    todo = false;
  }
  unsigned left = __ballot_sync(kFull, todo);
  int k = left ? __ffs(left) - 1 : -1;
  uint4 f = k >= 0 ? load_flags(row_flags, __shfl_sync(kFull, mine, k), lane)
                   : zero;
  while (k >= 0) {
    // the next cell's flags are loaded before this cell is filtered
    left &= left - 1;
    const int k2 = left ? __ffs(left) - 1 : -1;
    const int cell2 = __shfl_sync(kFull, mine, k2 >= 0 ? k2 : 0);
    const uint4 f2 = k2 >= 0 ? load_flags(row_flags, cell2, lane) : zero;
    warp_cell<M, V>(a, __shfl_sync(kFull, mine, k), f, s_rows[warp], s_hot,
                    &s_n_hot);
    k = k2;
    f = f2;
  }
  __syncthreads();
  for (int h = 0; h < s_n_hot; ++h)
    block_cell<M, V>(a, s_hot[h], &s_rows[0][0], s_warp);
}

template <int M, int V>
cudaError_t launch(const uint8_t* corpus, long long n, const uint8_t* b2c,
                   const uint32_t* tabs, int Wp, int capc,
                   const uint8_t* row_flags, const int32_t* row_counts,
                   int n_cells, int32_t* out_pos, int32_t* counts,
                   cudaStream_t stream) {
  const int R = table_copies(M, 128, Wp, V);
  const size_t smem = table_bytes(M, 128, Wp, R);
  auto kernel = rescan_kernel<M, V>;
  cudaError_t e;
  int grid = resident_grid(kernel, smem, (n_cells + kWarps - 1) / kWarps, e);
  if (e != cudaSuccess) return e;
  // no warp takes more than kWarpCells cells (past one resident wave, the
  // blocks run in turn: none waits on another)
  const int least = (n_cells + kBlockCells - 1) / kBlockCells;
  if (grid < least) grid = least;
  kernel<<<grid, kThreads, smem, stream>>>(corpus, n, b2c, tabs, Wp / V, R,
                                           capc, row_flags, row_counts,
                                           n_cells, out_pos, counts);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_v(const uint8_t* c, long long n, const uint8_t* b,
                     const uint32_t* t, int Wp, int capc, const uint8_t* rf,
                     const int32_t* rc, int n_cells, int32_t* o, int32_t* k,
                     cudaStream_t s) {
  switch (vector_width(Wp)) {
    case 1:
      return launch<M, 1>(c, n, b, t, Wp, capc, rf, rc, n_cells, o, k, s);
    case 4:
      return launch<M, 4>(c, n, b, t, Wp, capc, rf, rc, n_cells, o, k, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Class tables only (the gated family's): `b2c` [256], `tabs` [M][128][Wp]
// words with Wp = 1, 2, 4 or 8; `row_flags` [n_cells * 512], 16-byte
// aligned; `row_counts` [n_cells] (the flags' per-cell sums) or null.
extern "C" int hs_teddy_rescan_rows(const void* corpus, long long n,
                                    const void* b2c, const void* tabs, int M,
                                    int Wp, int capc, const void* row_flags,
                                    const void* row_counts, void* out_pos,
                                    void* counts, int n_cells, void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* b = static_cast<const uint8_t*>(b2c);
  const auto* t = static_cast<const uint32_t*>(tabs);
  const auto* rf = static_cast<const uint8_t*>(row_flags);
  const auto* rc = static_cast<const int32_t*>(row_counts);
  auto* o = static_cast<int32_t*>(out_pos);
  auto* k = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  if (capc < 1 || n_cells < 1) return int(cudaErrorInvalidValue);
#define HS_CASE(MM) \
  case MM:          \
    return int(launch_v<MM>(c, n, b, t, Wp, capc, rf, rc, n_cells, o, k, s));
  switch (M) {
    HS_CASE(1)
    HS_CASE(2)
    HS_CASE(3)
    HS_CASE(4)
    HS_CASE(5)
    HS_CASE(6)
    HS_CASE(7)
    HS_CASE(8)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef HS_CASE
}

extern "C" const char* hs_teddy_rescan_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
