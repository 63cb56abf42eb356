// The standalone Teddy filter with separate bucket words (sm_90a), in two
// modes of one kernel: count and list.
//
// Replaces the Pallas TPU kernel _make_kernel, hyperscan_tpu/ops/teddy.py:37,
// in both places that launch it:
// - the pallas_call at hyperscan_tpu/ops/teddy.py:762 (_jit_filter, followed
//   by sparse_extract :793; reached through teddy_scan_rows :911 and
//   teddy_scan :958): list mode, after count mode;
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
// 64 KiB cell, its exact number of candidates. List mode takes, for every
// cell, the rank of its first candidate (the exclusive prefix sum of count
// mode's output) and writes each candidate's position p - start and its W
// words at its rank, ascending, for every rank below `cap`; the words are the
// raw int32 bit patterns of the masks' AND, compared bitwise by the callers.
//
// What bounds it. Each corpus byte is read once (n bytes at 3.35 TB/s), and
// each costs M*W words of the byte tables: at M=5, W=4 that is 20
// shared-memory words a byte against 132 SMs x 32 words a clock, so
// the table reads, not device memory, bound both modes. List mode adds the
// candidates' outputs, (1 + W) words each, and a second read of the corpus.
//
// Design. The reference wrote W full int32 planes to device memory (at
// 512 MiB and W = 4, 8 GiB of writes) and extracted the nonzero positions
// from them. Here no plane exists: the filter loop of teddy_filter.cuh (byte
// tables in the kernels' [M][256][Wp] layout, replicated in shared memory,
// one vector load per (m, byte); a resident grid walking the 64 KiB cells,
// one block a cell at a time; 16 bytes a thread with the look-back from the
// left lane's registers). Count mode keeps one running count per block. List
// mode runs the same filter again, ranks each step's candidates with a block
// scan on top of the cell's first rank, and recomputes the W words of each
// candidate only (a few percent of positions at most), so the output is
// exact, in ascending order, with no per-cell capacity and no sort: two
// launches around a torch cumsum of the per-cell counts, the way
// plane_extract.cu splits its passes.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

enum Mode { kCount = 0, kList = 1 };

// byte p0 - 8 + k of a thread's window (k < 24)
__device__ __forceinline__ uint32_t win_byte(const uint32_t win[6], int k) {
  return (win[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
}

template <int M, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
words_kernel(const uint8_t* __restrict__ corpus, long long n, long long start,
             const uint32_t* __restrict__ masks, int W, int H, int R,
             int32_t* __restrict__ counts,
             const long long* __restrict__ first_rank, long long cap,
             int32_t* __restrict__ out_pos, int32_t* __restrict__ out_words,
             int n_cells) {
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][256][R][V]
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  stage_tables<V>(s_tab, masks, M, 256, H, R);
  __syncthreads();
  // this lane's copy of the tables
  const uint32_t* lane_tab = s_tab + (lane & (R - 1)) * V;

  for (int cell = blockIdx.x; cell < n_cells; cell += gridDim.x) {
    const long long cell0 = (long long)cell * kCell;
    long long running = kMode == kList ? first_rank[cell] : 0;
    for (int step = 0; step < kSteps; ++step) {
      const long long base = cell0 + (long long)step * kStep;
      if (base >= n) break;  // uniform across the block
      const long long p0 = base + tid * kChunk;
      uint32_t win[6];
      load_window(corpus, n, p0, lane == 0, win);
      uint32_t bits = cand_bits<M, false, V>(win, nullptr, s_tab, H, R, p0, n);
      if (p0 < start) {  // look-back bytes are not positions
        const long long skip = start - p0;
        bits = skip >= kChunk ? 0u : bits & (0xFFFFFFFFu << skip);
      }
      int step_total;
      long long r = running + block_scan(__popc(bits), s_warp, step_total);
      running += step_total;
      if (kMode == kCount) continue;
      while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        if (r < cap) {
          out_pos[r] = int32_t(p0 + j - start);
          for (int w = 0; w < W; ++w) {
            // word w of (m, byte) is element w % V of vector w / V
            const uint32_t* t = lane_tab + (w / V) * 256 * R * V + w % V;
            uint32_t a = t[win_byte(win, 8 + j) * R * V];
            for (int m = 1; m < M; ++m)
              a &= t[(m * H * 256 + win_byte(win, 8 + j - m)) * R * V];
            out_words[(long long)w * cap + r] = int32_t(a);
          }
        }
        ++r;
      }
    }
    if (kMode == kCount && tid == 0) counts[cell] = int32_t(running);
  }
}

template <int M, int V, int kMode>
cudaError_t launch(const uint8_t* corpus, long long n, long long start,
                   const uint32_t* masks, int W, int Wp, int32_t* counts,
                   const long long* first_rank, long long cap,
                   int32_t* out_pos, int32_t* out_words, int n_cells,
                   cudaStream_t stream) {
  const int R = table_copies(M, 256, Wp, V);
  const size_t smem = table_bytes(M, 256, Wp, R);
  auto kernel = words_kernel<M, V, kMode>;
  cudaError_t e;
  const int grid = resident_grid(kernel, smem, n_cells, e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(corpus, n, start, masks, W,
                                           Wp / V, R, counts, first_rank,
                                           cap, out_pos, out_words, n_cells);
  return cudaGetLastError();
}

template <int kMode>
int dispatch(const void* corpus, long long n, long long start,
             const void* masks, int M, int W, int Wp, void* counts,
             const void* first_rank, long long cap, void* out_pos,
             void* out_words, int n_cells, void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* t = static_cast<const uint32_t*>(masks);
  auto* k = static_cast<int32_t*>(counts);
  const auto* f = static_cast<const long long*>(first_rank);
  auto* p = static_cast<int32_t*>(out_pos);
  auto* o = static_cast<int32_t*>(out_words);
  auto s = static_cast<cudaStream_t>(stream);
  const int V = vector_width(Wp);
  if (V == 0 || W < 1 || W > Wp) return int(cudaErrorInvalidValue);
#define HS_CASE(MM)                                                          \
  case MM:                                                                   \
    return int(V == 1 ? launch<MM, 1, kMode>(c, n, start, t, W, Wp, k, f,    \
                                             cap, p, o, n_cells, s)          \
                      : launch<MM, 4, kMode>(c, n, start, t, W, Wp, k, f,    \
                                             cap, p, o, n_cells, s));
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

// `masks`: the byte tables as [M][256][Wp] words (Wp = 1, 2, 4 or 8, the
// padded width of the W words).
extern "C" int hs_teddy_words_count(const void* corpus, long long n,
                                    long long start, const void* masks, int M,
                                    int W, int Wp, void* counts, int n_cells,
                                    void* stream) {
  return dispatch<kCount>(corpus, n, start, masks, M, W, Wp, counts, nullptr,
                          0, nullptr, nullptr, n_cells, stream);
}

extern "C" int hs_teddy_words_list(const void* corpus, long long n,
                                   long long start, const void* masks, int M,
                                   int W, int Wp, const void* first_rank,
                                   long long cap, void* out_pos,
                                   void* out_words, int n_cells,
                                   void* stream) {
  return dispatch<kList>(corpus, n, start, masks, M, W, Wp, nullptr,
                         first_rank, cap, out_pos, out_words, n_cells,
                         stream);
}

extern "C" const char* hs_teddy_words_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
