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
// each costs M*W lookups into the [M][W][256] byte tables: at M=5, W=4 that
// is 20 shared-memory lookups a byte against 132 SMs x 32 lookups a clock, so
// the lookups, not device memory, bound both modes. List mode adds the
// candidates' outputs, (1 + W) words each, and a second read of the corpus.
//
// Design. The reference wrote W full int32 planes to device memory (at
// 512 MiB and W = 4, 8 GiB of writes) and extracted the nonzero positions
// from them. Here no plane exists: the filter of kernel A
// (teddy_filter_compact.cu, byte tables) runs per 64 KiB cell, one block a
// cell, the tables in shared memory (M*W KiB), 16 bytes a thread with the
// look-back from the left lane's registers (teddy_filter.cuh). Count mode
// keeps one running count per block. List mode runs the same filter again,
// ranks each step's candidates with a block scan on top of the cell's first
// rank, and recomputes the W words of each candidate only (a few percent of
// positions at most), so the output is exact, in ascending order, with no
// per-cell capacity and no sort: two launches around a torch cumsum of the
// per-cell counts, the way plane_extract.cu splits its passes.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

enum Mode { kCount = 0, kList = 1 };

// byte p0 - 8 + k of a thread's window (k < 24)
__device__ __forceinline__ uint32_t win_byte(const uint32_t win[6], int k) {
  return (win[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
}

template <int M, int kMode>
__global__ void __launch_bounds__(kThreads)
words_kernel(const uint8_t* __restrict__ corpus, long long n, long long start,
             const uint32_t* __restrict__ masks, int W,
             int32_t* __restrict__ counts,
             const long long* __restrict__ first_rank, long long cap,
             int32_t* __restrict__ out_pos, int32_t* __restrict__ out_words) {
  extern __shared__ uint32_t s_tab[];  // [M][W][256]
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < M * W * 256; i += kThreads) s_tab[i] = masks[i];
  __syncthreads();

  const long long cell0 = (long long)blockIdx.x * kCell;
  long long running = kMode == kList ? first_rank[blockIdx.x] : 0;
  for (int step = 0; step < kCell / kStep; ++step) {
    const long long base = cell0 + (long long)step * kStep;
    if (base >= n) break;  // uniform across the block
    const long long p0 = base + tid * kChunk;
    uint32_t win[6];
    load_window(corpus, n, p0, lane == 0, win);
    uint32_t bits = cand_bits<M, false>(win, nullptr, s_tab, W, p0, n);
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
          uint32_t a = s_tab[w * 256 + win_byte(win, 8 + j)];
          for (int m = 1; m < M; ++m)
            a &= s_tab[(m * W + w) * 256 + win_byte(win, 8 + j - m)];
          out_words[(long long)w * cap + r] = int32_t(a);
        }
      }
      ++r;
    }
  }
  if (kMode == kCount && tid == 0) counts[blockIdx.x] = int32_t(running);
}

template <int M, int kMode>
cudaError_t launch(const uint8_t* corpus, long long n, long long start,
                   const uint32_t* masks, int W, int32_t* counts,
                   const long long* first_rank, long long cap,
                   int32_t* out_pos, int32_t* out_words, int n_cells,
                   cudaStream_t stream) {
  const size_t smem = table_bytes(M, W, false);
  auto kernel = words_kernel<M, kMode>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_cells, kThreads, smem, stream>>>(corpus, n, start, masks, W,
                                              counts, first_rank, cap,
                                              out_pos, out_words);
  return cudaGetLastError();
}

template <int kMode>
int dispatch(const void* corpus, long long n, long long start,
             const void* masks, int M, int W, void* counts,
             const void* first_rank, long long cap, void* out_pos,
             void* out_words, int n_cells, void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* t = static_cast<const uint32_t*>(masks);
  auto* k = static_cast<int32_t*>(counts);
  const auto* f = static_cast<const long long*>(first_rank);
  auto* p = static_cast<int32_t*>(out_pos);
  auto* o = static_cast<int32_t*>(out_words);
  auto s = static_cast<cudaStream_t>(stream);
#define HS_CASE(MM)                                                      \
  case MM:                                                               \
    return int(launch<MM, kMode>(c, n, start, t, W, k, f, cap, p, o,     \
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

extern "C" int hs_teddy_words_count(const void* corpus, long long n,
                                    long long start, const void* masks, int M,
                                    int W, void* counts, int n_cells,
                                    void* stream) {
  return dispatch<kCount>(corpus, n, start, masks, M, W, counts, nullptr, 0,
                          nullptr, nullptr, n_cells, stream);
}

extern "C" int hs_teddy_words_list(const void* corpus, long long n,
                                   long long start, const void* masks, int M,
                                   int W, const void* first_rank,
                                   long long cap, void* out_pos,
                                   void* out_words, int n_cells,
                                   void* stream) {
  return dispatch<kList>(corpus, n, start, masks, M, W, nullptr, first_rank,
                         cap, out_pos, out_words, n_cells, stream);
}

extern "C" const char* hs_teddy_words_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
