// The standalone Teddy filter with separate bucket words (sm_90a), in two
// kernels: count mode and list mode.
//
// Replaces the Pallas TPU kernel _make_kernel, hyperscan_tpu/ops/teddy.py:37,
// in both places that launch it:
// - the pallas_call at hyperscan_tpu/ops/teddy.py:762 (_jit_filter, followed
//   by sparse_extract :793; reached through teddy_scan_rows :911 and
//   teddy_scan :958): count mode with segment counts, then list mode;
// - the pallas_call at hyperscan_tpu/parallel/sharded.py:237
//   (sharded_teddy_count, one launch per shard, the counts summed): count
//   mode.
//
// What it computes. For a position p of the tensor with start <= p < n and
// every bucket word w < W,
//   word_w(p) = AND_{m<M} masks[m][w][byte(p - m)],
// with a zero byte before offset 0 of the tensor; p is a candidate when the
// OR of its W words is nonzero. The first `start` bytes of the tensor are
// look-back only: a shard passes the bytes before its segment there, which
// is what the reference's halo row carried. Count mode writes, for every
// 64 KiB cell, its exact number of candidates and, when asked, the same for
// every 512-byte segment. List mode takes the segment counts and their
// exclusive prefix sum (each segment's first rank) and writes each
// candidate's position p - start and its W words at its rank, ascending,
// for every rank below `cap`; the words are the raw int32 bit patterns of the
// masks' AND, compared bitwise by the callers.
//
// Tables. The words are read either from the byte tables ([M][256][Wp]) or,
// where the 256 bytes fall into at most 128 classes of equal table columns,
// from the class tables ([M][128][Wp], keyed by b2c[byte]). A class's column
// is each of its bytes' column, so both give the same words bit for bit.
//
// What bounds it. Each corpus byte is read once (n bytes at 3.35 TB/s), and
// each costs M*W table words (plus the b2c remap with class tables): at
// M=5, W=4 that is 20 shared-memory words a byte against 132 SMs x 32 words
// a clock, so the table reads, not device memory, bound count mode. List
// mode does that work only for the segments that hold candidates, plus the
// candidates' outputs, (1 + W) words each.
//
// Design. The reference wrote W full int32 planes to device memory (at
// 512 MiB and W = 4, 8 GiB of writes) and extracted the nonzero positions
// from them. Here no plane exists. Both kernels run the filter loop of
// teddy_filter.cuh (tables replicated in shared memory so a quarter warp's
// 128-bit loads hit distinct banks: R = 8 copies of the 10 KiB class tables
// at M = 5, W = 4, where the 20 KiB byte tables fit only 4; a resident grid;
// 16 bytes a thread with the look-back from the left lane's registers). In
// count mode each thread sums the popcount of its candidate bits over the
// cell and the block adds the warps' sums once a cell (one barrier); a
// warp's 512 bytes of a step are one segment, whose count is one warp
// reduction. List mode gives each warp groups of 32 segments: it skips the
// empty ones with one ballot and re-filters only the others, ranking their
// candidates with a warp scan from the segment's first rank (no block
// barrier), and computes the W words of each candidate only. So the output
// is exact, in ascending order, with no per-cell capacity and no sort, and
// the corpus is filtered once in full (count mode) and again only where
// there are candidates.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

constexpr int kSeg = 32 * kChunk;  // bytes of a segment: a warp's step
static_assert(kStep == kWarps * kSeg, "a step is one segment a warp");

// byte p0 - 8 + k of a thread's window (k < 24, known only at run time):
// the word is picked by selects, so the window stays in registers
__device__ __forceinline__ uint32_t win_byte(const uint32_t win[6], int k) {
  const int q = k >> 2;
  uint32_t w = win[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) w = q == i ? win[i] : w;
  return (w >> ((k & 3) * 8)) & 0xFFu;
}

// Candidate bits of the thread's 16 bytes at p0, the look-back positions
// (p < start) cleared.
template <int M, bool kClasses, int V>
__device__ __forceinline__ uint32_t position_bits(
    const uint8_t* __restrict__ corpus, long long n, long long start,
    long long p0, bool reload, const uint8_t* s_b2c, const uint32_t* s_tab,
    int H, int R, uint32_t win[6]) {
  load_window(corpus, n, p0, reload, win);
  uint32_t bits = cand_bits<M, kClasses, V>(win, s_b2c, s_tab, H, R, p0, n);
  if (p0 < start) {
    const long long skip = start - p0;
    bits = skip >= kChunk ? 0u : bits & (0xFFFFFFFFu << skip);
  }
  return bits;
}

__device__ __forceinline__ uint32_t elem(uint32_t a, int) { return a; }
__device__ __forceinline__ uint32_t elem(uint4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// The W words of candidate j of the thread's window, written at rank r.
template <int M, bool kClasses, int V>
__device__ __forceinline__ void put_words(const uint32_t win[6], int j,
                                          const uint8_t* s_b2c,
                                          const uint32_t* lane_tab, int W,
                                          int H, int R, long long cap,
                                          long long r,
                                          int32_t* __restrict__ out_words) {
  using Vt = Vec<V>;
  constexpr int kTab = kClasses ? 128 : 256;
  const int stride = R * V;
  uint32_t key[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const uint32_t b = win_byte(win, 8 + j - m);
    key[m] = (kClasses ? uint32_t(s_b2c[b]) : b) * uint32_t(stride);
  }
  for (int h = 0; h < H; ++h) {
    typename Vt::T a = Vt::load(lane_tab + h * kTab * stride + key[0]);
#pragma unroll
    for (int m = 1; m < M; ++m)
      a = Vt::band(a, Vt::load(lane_tab + (m * H + h) * kTab * stride +
                               key[m]));
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int w = h * V + e;
      if (w < W) out_words[(long long)w * cap + r] = int32_t(elem(a, e));
    }
  }
}

template <int M, bool kClasses, int V>
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ corpus, long long n, long long start,
             const uint8_t* __restrict__ b2c,
             const uint32_t* __restrict__ tabs, int H, int R,
             int32_t* __restrict__ counts, int n_cells,
             int32_t* __restrict__ seg_counts, long long n_segs) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][kTab][R][V]
  __shared__ uint8_t s_b2c[256];
  // the warps' sums of a cell, two slots so that the next cell's writes
  // never meet this cell's reader (a barrier a cell separates them)
  __shared__ int s_sum[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage_tables<V>(s_tab, tabs, M, kTab, H, R);
  if (kClasses) s_b2c[tid] = b2c[tid];  // kThreads == 256
  __syncthreads();

  int slot = 0;
  for (int cell = blockIdx.x; cell < n_cells;
       cell += gridDim.x, slot ^= 1) {
    const long long cell0 = (long long)cell * kCell;
    int mine = 0;
    for (int step = 0; step < kSteps; ++step) {
      const long long base = cell0 + (long long)step * kStep;
      if (base >= n) break;  // uniform across the block
      uint32_t win[6];
      const int c = __popc(position_bits<M, kClasses, V>(
          corpus, n, start, base + tid * kChunk, lane == 0, s_b2c, s_tab, H,
          R, win));
      mine += c;
      if (seg_counts != nullptr) {  // uniform
        const int seg_total = __reduce_add_sync(kFull, c);
        const long long seg = base / kSeg + warp;
        if (lane == 0 && seg < n_segs) seg_counts[seg] = seg_total;
      }
    }
    mine = __reduce_add_sync(kFull, mine);
    if (lane == 0) s_sum[slot][warp] = mine;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) total += s_sum[slot][k];
      counts[cell] = total;
    }
  }
}

template <int M, bool kClasses, int V>
__global__ void __launch_bounds__(kThreads)
list_kernel(const uint8_t* __restrict__ corpus, long long n, long long start,
            const uint8_t* __restrict__ b2c,
            const uint32_t* __restrict__ tabs, int W, int H, int R,
            const int32_t* __restrict__ seg_counts,
            const long long* __restrict__ seg_first, long long n_segs,
            long long cap, int32_t* __restrict__ out_pos,
            int32_t* __restrict__ out_words) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][kTab][R][V]
  __shared__ uint8_t s_b2c[256];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  stage_tables<V>(s_tab, tabs, M, kTab, H, R);
  if (kClasses) s_b2c[tid] = b2c[tid];
  __syncthreads();
  // this lane's copy of the tables
  const uint32_t* lane_tab = s_tab + (lane & (R - 1)) * V;

  const long long n_groups = (n_segs + 31) / 32;
  const long long n_warps = (long long)gridDim.x * kWarps;
  for (long long g = (long long)blockIdx.x * kWarps + (tid >> 5);
       g < n_groups; g += n_warps) {
    // lane l looks at segment 32 g + l; the warp visits the nonempty ones
    const long long my_seg = g * 32 + lane;
    const bool busy = my_seg < n_segs && seg_counts[my_seg] != 0;
    const long long my_first = busy ? seg_first[my_seg] : 0;
    unsigned todo = __ballot_sync(kFull, busy);
    while (todo) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const long long seg0 = (g * 32 + k) * kSeg;
      const long long p0 = seg0 + lane * kChunk;
      uint32_t win[6];
      uint32_t bits = position_bits<M, kClasses, V>(
          corpus, n, start, p0, lane == 0, s_b2c, s_tab, H, R, win);
      // ranks: the segment's first rank plus a warp scan of the counts
      const int c = __popc(bits);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      long long r = __shfl_sync(kFull, my_first, k) + incl - c;
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        if (r < cap) {
          out_pos[r] = int32_t(p0 + j - start);
          put_words<M, kClasses, V>(win, j, s_b2c, lane_tab, W, H, R, cap, r,
                                    out_words);
        }
        ++r;
      }
    }
  }
}

struct Args {
  const uint8_t* corpus;
  long long n, start;
  const uint8_t* b2c;
  const uint32_t* tabs;
  int W, Wp;
  int32_t* counts;
  int n_cells;
  int32_t* seg_counts;
  const long long* seg_first;
  long long n_segs, cap;
  int32_t* out_pos;
  int32_t* out_words;
  cudaStream_t stream;
};

template <int M, bool kClasses, int V, bool kList>
cudaError_t launch(const Args& a) {
  constexpr int kTab = kClasses ? 128 : 256;
  const int R = table_copies(M, kTab, a.Wp, V);
  const size_t smem = table_bytes(M, kTab, a.Wp, R);
  const int H = a.Wp / V;
  cudaError_t e;
  if (kList) {
    auto kernel = list_kernel<M, kClasses, V>;
    const long long groups = (a.n_segs + 31) / 32;
    const long long blocks = (groups + kWarps - 1) / kWarps;
    if (blocks == 0) return cudaSuccess;
    const int grid = resident_grid(
        kernel, smem, int(blocks < (1 << 30) ? blocks : (1 << 30)), e);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        a.corpus, a.n, a.start, a.b2c, a.tabs, a.W, H, R, a.seg_counts,
        a.seg_first, a.n_segs, a.cap, a.out_pos, a.out_words);
  } else {
    auto kernel = count_kernel<M, kClasses, V>;
    const int grid = resident_grid(kernel, smem, a.n_cells, e);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        a.corpus, a.n, a.start, a.b2c, a.tabs, H, R, a.counts, a.n_cells,
        a.seg_counts, a.n_segs);
  }
  return cudaGetLastError();
}

template <bool kList>
int dispatch(const Args& a, int M, int classes) {
  const int V = vector_width(a.Wp);
  if (V == 0 || a.W < 1 || a.W > a.Wp) return int(cudaErrorInvalidValue);
  if (classes && a.b2c == nullptr) return int(cudaErrorInvalidValue);
#define HS_CASE(MM)                                                        \
  case MM:                                                                 \
    return int(classes ? (V == 1 ? launch<MM, true, 1, kList>(a)           \
                                 : launch<MM, true, 4, kList>(a))          \
                       : (V == 1 ? launch<MM, false, 1, kList>(a)          \
                                 : launch<MM, false, 4, kList>(a)));
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

}  // namespace

// `tabs`: the tables as [M][K][Wp] words (Wp = 1, 2, 4 or 8, the padded
// width of the W words), K = 128 classes keyed by `b2c` ([256] uint8) when
// `classes` is set, else K = 256 bytes (`b2c` unused). `seg_counts` may be
// null; else it gets the count of each of the n_segs = ceil(n / 512)
// segments.
extern "C" int hs_teddy_words_count(const void* corpus, long long n,
                                    long long start, const void* b2c,
                                    const void* tabs, int M, int W, int Wp,
                                    int classes, void* counts, int n_cells,
                                    void* seg_counts, long long n_segs,
                                    void* stream) {
  Args a{static_cast<const uint8_t*>(corpus),
         n,
         start,
         static_cast<const uint8_t*>(b2c),
         static_cast<const uint32_t*>(tabs),
         W,
         Wp,
         static_cast<int32_t*>(counts),
         n_cells,
         static_cast<int32_t*>(seg_counts),
         nullptr,
         n_segs,
         0,
         nullptr,
         nullptr,
         static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, M, classes);
}

// `seg_counts` [n_segs] int32 and `seg_first` [n_segs] int64: count mode's
// segment counts and their exclusive prefix sum.
extern "C" int hs_teddy_words_list(const void* corpus, long long n,
                                   long long start, const void* b2c,
                                   const void* tabs, int M, int W, int Wp,
                                   int classes, const void* seg_counts,
                                   const void* seg_first, long long n_segs,
                                   long long cap, void* out_pos,
                                   void* out_words, void* stream) {
  Args a{static_cast<const uint8_t*>(corpus),
         n,
         start,
         static_cast<const uint8_t*>(b2c),
         static_cast<const uint32_t*>(tabs),
         W,
         Wp,
         nullptr,
         0,
         const_cast<int32_t*>(static_cast<const int32_t*>(seg_counts)),
         static_cast<const long long*>(seg_first),
         n_segs,
         cap,
         static_cast<int32_t*>(out_pos),
         static_cast<int32_t*>(out_words),
         static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, M, classes);
}

extern "C" const char* hs_teddy_words_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
