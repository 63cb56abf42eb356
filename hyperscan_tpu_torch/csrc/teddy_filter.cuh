// Shared pieces of the Teddy filter kernels (sm_90a): the corpus window of
// one thread and the candidate test over its 16 bytes.
//
// Included by teddy_filter_compact.cu (compaction, plane and survivor-row
// modes), teddy_gate.cu (the single-word gate) and teddy_kconfirm.cuh (the
// filter with the hash confirm inside). See teddy_filter_compact.cu for the
// filter's definition and its design.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace teddy {

constexpr int kCell = 65536;
constexpr int kThreads = 256;
constexpr int kChunk = 16;                  // bytes per thread per step
constexpr int kStep = kThreads * kChunk;    // bytes per block per step
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;              // the gate's survivor unit
constexpr int kRowsPerCell = kCell / kRowBytes;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "one thread loads one b2c entry");
static_assert(kCell % kStep == 0, "a cell is a whole number of steps");
static_assert(kRowsPerCell == 2 * kThreads, "two row flags a thread");

// 16 bytes at p (a multiple of 16); zero for bytes before 0 or at/after n.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ corpus,
                                        long long n, long long p) {
  if (p >= 0 && p + 16 <= n)
    return *reinterpret_cast<const uint4*>(corpus + p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long q = p + k;
    if (q >= 0 && q < n) w[k >> 2] |= uint32_t(corpus[q]) << ((k & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// win[0..5] = bytes p0-8 .. p0+15. The 8 bytes before p0 come from the left
// neighbouring lane's registers by a warp shuffle, or, where `reload` is set
// (the lane whose left neighbour holds other bytes), from memory (an L1/L2
// hit). Every lane of the warp must call it.
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ corpus,
                                            long long n, long long p0,
                                            bool reload, uint32_t win[6]) {
  const uint4 cur = load16(corpus, n, p0);
  uint32_t pz = __shfl_up_sync(kFull, cur.z, 1);
  uint32_t pw = __shfl_up_sync(kFull, cur.w, 1);
  if (reload) {
    const uint4 prev = load16(corpus, n, p0 - 16);
    pz = prev.z;
    pw = prev.w;
  }
  win[0] = pz;
  win[1] = pw;
  win[2] = cur.x;
  win[3] = cur.y;
  win[4] = cur.z;
  win[5] = cur.w;
}

// Bit j set <=> byte p0 + j (< n) is a candidate:
//   OR_{w<W} AND_{m<M} tab[m][w][key(p0 + j - m)] != 0,
// key = b2c[byte] (kClasses, 128-entry tables) or the byte (256 entries).
template <int M, bool kClasses>
__device__ __forceinline__ uint32_t cand_bits(const uint32_t win[6],
                                              const uint8_t* s_b2c,
                                              const uint32_t* s_tab, int W,
                                              long long p0, long long n) {
  constexpr int kTab = kClasses ? 128 : 256;
  // key[k] belongs to byte p0 - 8 + k
  uint32_t key[24];
#pragma unroll
  for (int k = 8 - (M - 1); k < 24; ++k) {
    const uint32_t b = (win[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
    key[k] = kClasses ? uint32_t(s_b2c[b]) : b;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    uint32_t any = 0;
    for (int w = 0; w < W; ++w) {
      const uint32_t* t = s_tab + w * kTab;
      uint32_t a = t[key[8 + j]];
#pragma unroll
      for (int m = 1; m < M; ++m) a &= t[m * W * kTab + key[8 + j - m]];
      any |= a;
    }
    if (any != 0u && p0 + j < n) bits |= 1u << j;
  }
  return bits;
}

// Block-wide exclusive scan of one int a thread; `s_warp` holds kWarps
// ints. Returns the exclusive prefix and sets `total`. Ends with a barrier,
// so `s_warp` may be reused right after.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int u = s_warp[k];
    if (k < warp) base += u;
    total += u;
  }
  __syncthreads();
  return base + incl - v;
}

// Shared-memory bytes of M x W tables of the given width (32-bit words).
inline size_t table_bytes(int M, int W, bool classes) {
  return size_t(M) * W * (classes ? 128 : 256) * 4;
}

}  // namespace teddy
