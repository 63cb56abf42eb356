// Teddy multi-literal filter with per-cell candidate compaction (sm_90a), in
// two modes of one kernel.
//
// Replaces the Pallas TPU kernels _make_kernel_fused_classes (class tables)
// and _make_kernel_fused (byte tables), hyperscan_tpu/ops/teddy.py:572, :682:
// - compact mode: with _compact_epilogue (:175, _rank_select, _prefix_rows),
//   the pallas_call at hyperscan_tpu/ops/teddy.py:1103 (ungated compact
//   family);
// - plane mode: the uint8 candidacy plane of the pallas_call at :1116 (dense
//   family, capc = 0), which plane_extract.cu then extracts.
// The gated family's stage 2, the same filter over the rows that the gate
// flagged (the pallas_call at :1424), is teddy_rescan_rows.cu.
//
// What it computes. For every corpus position p < n,
//   cand(p) = OR_w AND_{m<M} tab[m][w][key(p - m)] != 0,
// key(q) = b2c[byte q] (class tables, 128 entries) or byte q (byte tables,
// 256 entries), with a zero byte for q < 0. Compact mode: for every 64 KiB
// cell, the exact number of candidates and the first `capc` candidate
// positions in ascending order; the count stays exact past capc (the caller
// reads it to size the next dispatch). Plane mode: plane[p] = cand(p) as one byte, for p below the plane's length
// (zero at and past n).
//
// What bounds it. Each corpus byte is read once (n bytes at 3.35 TB/s), but
// each byte costs 1 + M*W shared-memory words with class tables (M*W with
// byte tables): at M=5, W=4 that is 21 words a byte against 132 SMs x 32
// words a clock, so the table reads, not device memory, bound compact and
// plane mode.
//
// Design. The loop of teddy_filter.cuh: the tables in shared memory in the
// kernels' [M][K][Wp] layout, replicated so that the lanes of a warp read
// distinct banks, one vector load per (m, key); a resident grid whose
// blocks stage the tables once and walk the 64 KiB cells (one block a cell
// at a time, so blocks never talk to each other). Each thread reads 16
// bytes with one vector load and takes the up to 7 bytes of look-back it
// needs from its left neighbour's registers by a warp shuffle. Positions are
// ranked by a popcount, a warp shuffle scan and a shared-memory scan across
// warps, so they come out ascending with no sort. None of the TPU's layouts (128-lane rows, halo row, rank selection by matmul) are
// needed.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

enum Mode { kCompact = 0, kPlane = 1 };

template <int M, bool kClasses, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const uint8_t* __restrict__ corpus, long long n,
              const uint8_t* __restrict__ b2c,
              const uint32_t* __restrict__ tabs, int H, int R, int capc,
              int32_t* __restrict__ out_pos, int32_t* __restrict__ counts,
              uint8_t* __restrict__ plane, long long plane_len,
              int n_cells) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][kTab][R][V]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  stage_tables<V>(s_tab, tabs, M, kTab, H, R);
  if (kClasses) s_b2c[tid] = b2c[tid];  // kThreads == 256
  __syncthreads();

  for (int cell = blockIdx.x; cell < n_cells; cell += gridDim.x) {
    const long long cell0 = (long long)cell * kCell;
    int32_t* cell_out = out_pos + (long long)cell * capc;
    int running = 0;  // candidates of this cell before the current step
    for (int step = 0; step < kSteps; ++step) {
      const long long base = cell0 + (long long)step * kStep;
      if (base >= n) break;  // uniform across the block
      const long long p0 = base + tid * kChunk;
      uint32_t win[6];
      load_window(corpus, n, p0, lane == 0, win);
      uint32_t bits =
          cand_bits<M, kClasses, V>(win, s_b2c, s_tab, H, R, p0, n);
      if (kMode == kPlane) {
        if (p0 < plane_len) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t b = bits >> (4 * k);
            w[k] = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 |
                   ((b >> 3) & 1u) << 24;
          }
          *reinterpret_cast<uint4*>(plane + p0) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
        continue;
      }
      // block-wide exclusive scan of the per-thread candidate counts
      int step_total;
      int r = running + block_scan(__popc(bits), s_warp, step_total);
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        if (r < capc) cell_out[r] = int32_t(p0 + j);
        ++r;
      }
      running += step_total;
    }
    if (kMode != kPlane && tid == 0) counts[cell] = running;
  }
}

template <int M, bool kClasses, int V, int kMode>
cudaError_t launch(const uint8_t* corpus, long long n, const uint8_t* b2c,
                   const uint32_t* tabs, int Wp, int capc, int32_t* out_pos,
                   int32_t* counts, uint8_t* plane, long long plane_len,
                   int n_cells, cudaStream_t stream) {
  constexpr int kTab = kClasses ? 128 : 256;
  const int R = table_copies(M, kTab, Wp, V);
  const size_t smem = table_bytes(M, kTab, Wp, R);
  auto kernel = filter_kernel<M, kClasses, V, kMode>;
  cudaError_t e;
  const int grid = resident_grid(kernel, smem, n_cells, e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(corpus, n, b2c, tabs, Wp / V, R,
                                           capc, out_pos, counts, plane,
                                           plane_len, n_cells);
  return cudaGetLastError();
}

template <int M, bool kClasses, int kMode>
cudaError_t launch_v(const uint8_t* c, long long n, const uint8_t* b,
                     const uint32_t* t, int Wp, int capc, int32_t* o,
                     int32_t* k, uint8_t* pl, long long plane_len,
                     int n_cells, cudaStream_t s) {
  switch (vector_width(Wp)) {
    case 1:
      return launch<M, kClasses, 1, kMode>(c, n, b, t, Wp, capc, o, k, pl,
                                           plane_len, n_cells, s);
    case 4:
      return launch<M, kClasses, 4, kMode>(c, n, b, t, Wp, capc, o, k, pl,
                                           plane_len, n_cells, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kMode>
int dispatch(const void* corpus, long long n, const void* b2c,
             const void* tabs, int M, int Wp, int classes, int capc,
             void* out_pos, void* counts, void* plane, long long plane_len,
             int n_cells, void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* b = static_cast<const uint8_t*>(b2c);
  const auto* t = static_cast<const uint32_t*>(tabs);
  auto* o = static_cast<int32_t*>(out_pos);
  auto* k = static_cast<int32_t*>(counts);
  auto* pl = static_cast<uint8_t*>(plane);
  auto s = static_cast<cudaStream_t>(stream);
#define HS_CASE(MM)                                                          \
  case MM:                                                                   \
    return int(classes ? launch_v<MM, true, kMode>(c, n, b, t, Wp, capc, o,  \
                                                   k, pl, plane_len,         \
                                                   n_cells, s)               \
                       : launch_v<MM, false, kMode>(c, n, b, t, Wp, capc, o, \
                                                    k, pl, plane_len,        \
                                                    n_cells, s));
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

// `Wp`: the padded table width (1, 2, 4 or 8) of `tabs`, [M][K][Wp] words.
extern "C" int hs_teddy_filter_compact(const void* corpus, long long n,
                                       const void* b2c, const void* tabs,
                                       int M, int Wp, int classes, int capc,
                                       void* out_pos, void* counts,
                                       int n_cells, void* stream) {
  return dispatch<kCompact>(corpus, n, b2c, tabs, M, Wp, classes, capc,
                            out_pos, counts, nullptr, 0, n_cells, stream);
}

extern "C" int hs_teddy_filter_plane(const void* corpus, long long n,
                                     const void* b2c, const void* tabs, int M,
                                     int Wp, int classes, void* plane,
                                     long long plane_len, int n_cells,
                                     void* stream) {
  return dispatch<kPlane>(corpus, n, b2c, tabs, M, Wp, classes, 0, nullptr,
                          nullptr, plane, plane_len, n_cells, stream);
}

extern "C" const char* hs_teddy_filter_compact_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
