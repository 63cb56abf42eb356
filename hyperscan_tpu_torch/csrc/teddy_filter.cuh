// Shared pieces of the Teddy filter kernels (sm_90a): the corpus window of
// one thread, the filter tables in shared memory, the candidate test over a
// thread's 16 bytes, and the resident grid the kernels run on.
//
// Included by teddy_filter_compact.cu (compaction and plane modes),
// teddy_rescan_rows.cu (the filter over the gate's rows), teddy_gate.cu (the single-word gate), teddy_words.cu (the
// standalone filter) and teddy_kconfirm.cu (the filter with the hash confirm
// inside). See teddy_filter_compact.cu for the filter's definition.
//
// Design of the loop. The host hands every kernel its tables as
// [M][K][Wp] 32-bit words: the W words of one (suffix offset m, key) side by
// side, zero-padded to Wp = 1, 2, 4 or 8 (ops/teddy.py pack_tables). A block
// keeps them in shared memory as [M][H][K][R][V]: each (m, key) is H vectors
// of V = 1 or 4 words (Wp = 1: one word; 2: two words; 4: one 128-bit vector;
// 8: two), and each vector is held R times side by side. Lane l reads copy
// l % R, so with R = 32 / V the lanes of a warp (of a quarter warp, for
// 128-bit loads) read distinct banks whatever their keys: no bank conflicts,
// and one instruction for V words. R is the largest power of two up to 32 / V
// whose copies fit kTableBudget (2 blocks an SM). The per-(m, h) base
// pointers are hoisted out of the position loop, the key offsets computed once
// per byte, and M and V are template parameters, so the M lookups of a
// position are unrolled vector loads at register offsets. Each block stages
// its tables once and then walks the cells blockIdx.x, blockIdx.x +
// gridDim.x, ... (a resident grid: as many blocks as fit on the card), so the
// replicated tables cost one copy per block, not per cell.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace teddy {

constexpr int kCell = 65536;
constexpr int kThreads = 256;
constexpr int kChunk = 16;                  // bytes per thread per step
constexpr int kStep = kThreads * kChunk;    // bytes per block per step
constexpr int kSteps = kCell / kStep;       // steps a cell
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 128;              // the gate's survivor unit
constexpr int kRowsPerCell = kCell / kRowBytes;
constexpr unsigned kFull = 0xffffffffu;
// shared-memory bytes of one block's replicated tables: two blocks an SM
constexpr int kTableBudget = 96 * 1024;
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

// Copies of each table vector in shared memory (a power of two): 32 / V, or
// fewer until the copies fit kTableBudget.
inline int table_copies(int M, int K, int Wp, int V) {
  int R = 32 / V;
  while (R > 1 && size_t(M) * K * Wp * R * 4 > size_t(kTableBudget)) R >>= 1;
  return R;
}

// Shared-memory bytes of the replicated tables.
inline size_t table_bytes(int M, int K, int Wp, int R) {
  return size_t(M) * K * Wp * R * 4;
}

// Stage the host's [M][K][Wp] tables (Wp = V * H) into shared memory as
// [M][H][K][R][V]. Every thread of the block must call it; the caller
// synchronises before the tables are read.
template <int V>
__device__ __forceinline__ void stage_tables(uint32_t* __restrict__ s_tab,
                                             const uint32_t* __restrict__ tabs,
                                             int M, int K, int H, int R) {
  const int Wp = V * H;
  const int n_vec = M * H * K * R;
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const int v = i / R;  // vector (m, h, key) in shared order
    const int key = v % K;
    const int mh = v / K;
    const int h = mh % H;
    const int m = mh / H;
    const uint32_t* src = tabs + (m * K + key) * Wp + h * V;
#pragma unroll
    for (int e = 0; e < V; ++e) s_tab[i * V + e] = src[e];
  }
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T load(const uint32_t* p) { return *p; }
  static __device__ __forceinline__ T band(T a, T b) { return a & b; }
  static __device__ __forceinline__ bool any(T a) { return a != 0u; }
};
template <>
struct Vec<4> {
  using T = uint4;
  static __device__ __forceinline__ T load(const uint32_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ T band(T a, T b) {
    return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
  }
  static __device__ __forceinline__ bool any(T a) {
    return (a.x | a.y | a.z | a.w) != 0u;
  }
};

// The keys of a thread's window: koff[k] is the word offset, within one
// (m, h) table, of the vectors of byte p0 - 8 + k (k = 8 - (M-1) .. 23):
// key * R * V, key = b2c[byte] (kClasses) or the byte.
template <int M, bool kClasses>
__device__ __forceinline__ void window_keys(const uint32_t win[6],
                                            const uint8_t* s_b2c, int stride,
                                            uint32_t koff[24]) {
#pragma unroll
  for (int k = 8 - (M - 1); k < 24; ++k) {
    const uint32_t b = (win[k >> 2] >> ((k & 3) * 8)) & 0xFFu;
    koff[k] = (kClasses ? uint32_t(s_b2c[b]) : b) * uint32_t(stride);
  }
}

// Bit j set <=> byte p0 + j (< n) is a candidate:
//   OR_{w<W} AND_{m<M} tab[m][key(p0 + j - m)][w] != 0,
// key = b2c[byte] (kClasses, 128-entry tables) or the byte (256 entries),
// over the shared tables staged by stage_tables<V> with H vectors a key and
// R copies.
template <int M, bool kClasses, int V>
__device__ __forceinline__ uint32_t cand_bits(const uint32_t win[6],
                                              const uint8_t* s_b2c,
                                              const uint32_t* s_tab, int H,
                                              int R, long long p0,
                                              long long n) {
  using Vt = Vec<V>;
  constexpr int kTab = kClasses ? 128 : 256;
  const int stride = R * V;  // words from one key's vectors to the next's
  uint32_t koff[24];
  window_keys<M, kClasses>(win, s_b2c, stride, koff);
  const uint32_t* lane_tab = s_tab + (threadIdx.x & 31 & (R - 1)) * V;
  uint32_t bits = 0;
#pragma unroll 1
  for (int h = 0; h < H; ++h) {
    const uint32_t* base[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
      base[m] = lane_tab + (m * H + h) * kTab * stride;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      typename Vt::T a = Vt::load(base[0] + koff[8 + j]);
#pragma unroll
      for (int m = 1; m < M; ++m)
        a = Vt::band(a, Vt::load(base[m] + koff[8 + j - m]));
      bits |= uint32_t(Vt::any(a)) << j;
    }
  }
  const long long left = n - p0;  // bytes of the chunk below n
  if (left < kChunk) bits &= left <= 0 ? 0u : (1u << left) - 1u;
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

// Allow `smem` bytes of dynamic shared memory, then return the grid of a
// resident launch: as many blocks of kThreads as fit on the current card at
// once, and no more than `n_cells`. 0 and an error in `err` on failure.
template <typename Kernel>
inline int resident_grid(Kernel kernel, size_t smem, int n_cells,
                         cudaError_t& err) {
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return 0;
  if (per_sm < 1) {
    err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const long long fit = (long long)per_sm * sms;
  return int(fit < n_cells ? fit : n_cells);
}

// Vector width of a padded table width Wp (1, 2, 4 or 8): V = 4 from Wp = 4;
// 0 for any other Wp.
inline int vector_width(int Wp) {
  return Wp == 1 || Wp == 2 ? 1 : Wp == 4 || Wp == 8 ? 4 : 0;
}

}  // namespace teddy
