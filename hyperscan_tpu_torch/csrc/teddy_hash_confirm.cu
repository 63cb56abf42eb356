// Hash confirm of compacted Teddy candidates (sm_90a), kernel B.
//
// Computes what _hash_confirm_stage computes in the JAX package
// (hyperscan_tpu/ops/teddy.py:1281-1339, XLA glue after the filter kernel
// of the pallas_call at :1103), and what the in-kernel _confirm_epilogue
// (:258, pallas_call at :1081) computes for the kconfirm family.
//
// What it computes. For every candidate position p of the list (-1 = empty
// slot): the 8 bytes
// ending at p (zero before offset 0) as two words, lo = bytes p-7..p-4 and
// hi = bytes p-3..p with the newest byte on top; for every (tail length,
// tail mask) group the masked words are hashed as
// (lo * 0x9E3779B1) ^ (hi * 0x85EBCA6B) with the avalanche of
// runtime/lit_runtime.py _avalanche32, and `probes` slots of the group's
// open-addressed table (sig12 << 20 | class + 1) are compared with the
// hash's top 12 bits, for positions p >= tail length - 1. Every match is
// emitted as (class + 1, p) into a cap2 buffer through one counter, which
// keeps the exact total past cap2. The order of the pairs is arbitrary;
// the caller sorts.
//
// What bounds it. Per candidate: 8 corpus bytes from a corpus far larger
// than the L2 (scattered DRAM sectors), and per group one hash and
// `probes` 4-byte reads of tables of up to a few MiB (L2-resident). The
// candidates are a few per 64 KiB cell on the main path, so the byte
// bound is about a microsecond: the kernel is bound by its launch and by
// the latency of its dependent loads, not by bandwidth or arithmetic.
//
// Design. Two first designs (every group's and probe's loads unrolled
// over fixed maxima with a warp scan a chunk; then a group's probes as
// that many predicated 4-byte loads) measured slower than the kernel
// they replaced at 512 MiB iid: there the time goes to the instructions
// per candidate as much as to the loads' latency, so this one cuts both.
// - The entry point zeroes the counter with a memset on the caller's
//   stream, so the wrapper runs no fill kernel of its own.
// - A grid of as many threads as can be resident walks the list
//   grid-stride; the next slot's position is loaded while the current
//   one is confirmed, and a -1 slot costs a load and a compare (a list
//   of -1s costs what an empty launch does).
// - The tail is read as two aligned 8-byte words and a funnel shift;
//   byte loads only where those words would cross offset 0 or n (the
//   corpus tensor may end at n).
// - The group records are staged in shared memory once a block, two
//   16-byte words a group, up to kMaxStaged groups (48 KiB); past that
//   every thread reads them from the caller's [G, 6] records instead.
// - A group's probes are consecutive slots: they are read as the two
//   aligned 16-byte words that hold them (one gather a word, not one a
//   probe) and all eight slots compared at once; a mask keeps the
//   probes' window. A window that leaves those words (past their eighth
//   slot or the table's end) is probed slot by slot.
// - Hits are appended warp-aggregated: the lanes that append together
//   take one atomicAdd and write at their rank, so a warp whose every
//   candidate hits serialises on the counter once, not once a lane.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;  // resident blocks an SM the registers allow
constexpr int kWords = 8;      // slots read at once (two 16-byte words)

struct Group {  // a group's record, as staged in shared memory
  int4 a;       // tail length - 1, lo mask, hi mask, T - 1
  int4 b;       // probes, slot offset, -, -
};

constexpr int kMaxStaged = 48 * 1024 / int(sizeof(Group));  // 1,536 groups
constexpr int kMaxDevices = 64;

// Group g's record from the caller's (cl, mlo, mhi, T, probes, offset).
__device__ __forceinline__ Group load_group(const int32_t* __restrict__ gmeta,
                                            int g) {
  const int32_t* m = gmeta + 6 * g;
  Group r;
  r.a = make_int4(__ldg(m) - 1, __ldg(m + 1), __ldg(m + 2), __ldg(m + 3) - 1);
  r.b = make_int4(__ldg(m + 4), __ldg(m + 5), 0, 0);
  return r;
}

__device__ __forceinline__ uint32_t avalanche_hash(uint32_t lo, uint32_t hi) {
  uint32_t h = (lo * 0x9E3779B1u) ^ (hi * 0x85EBCA6Bu);
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 13;
  return h;
}

// The 8 bytes ending at p as (lo, hi); zero before offset 0.
__device__ __forceinline__ void tail_words(const uint8_t* __restrict__ corpus,
                                           long long n, int p, uint32_t& lo,
                                           uint32_t& hi) {
  const uintptr_t beg = reinterpret_cast<uintptr_t>(corpus);
  const uintptr_t a = beg + uintptr_t(p);
  const uintptr_t w1 = a & ~uintptr_t(7);
  if (w1 >= beg + 8 && w1 + 8 <= beg + uintptr_t(n)) {
    // both aligned words lie inside the corpus: the window p-7..p is
    // bytes (a & 7) + 1 .. (a & 7) + 8 of the 16 bytes from w1 - 8
    const unsigned long long x0 =
        __ldg(reinterpret_cast<const unsigned long long*>(w1 - 8));
    const unsigned long long x1 =
        __ldg(reinterpret_cast<const unsigned long long*>(w1));
    const unsigned s = 8u * unsigned((a & 7) + 1);  // 8..64
    const unsigned long long v = s == 64 ? x1 : (x0 >> s) | (x1 << (64 - s));
    lo = uint32_t(v);
    hi = uint32_t(v >> 32);
    return;
  }
  lo = hi = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long q = (long long)p - k;
    const uint32_t b = (q >= 0 && q < n) ? uint32_t(__ldg(corpus + q)) : 0u;
    if (k < 4)
      hi |= b << (8 * (3 - k));
    else
      lo |= b << (8 * (7 - k));
  }
}

__device__ __forceinline__ bool slot_hit(uint32_t sl, uint32_t sig) {
  return sl != 0u && (sl >> 20) == sig;
}

// One pair, appended by every lane that calls it at once: one atomicAdd
// for the lanes together, each writing at its rank.
__device__ __forceinline__ void append(int32_t cls, int p,
                                       int32_t* __restrict__ out, int cap2,
                                       int32_t* __restrict__ total) {
  const cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(total, int(g.size()));
  const int r = g.shfl(base, 0) + int(g.thread_rank());
  if (r < cap2) {
    out[2 * r] = cls;
    out[2 * r + 1] = p;
  }
}

template <bool kStaged>
__device__ __forceinline__ void confirm_one(
    const uint8_t* __restrict__ corpus, long long n, int p,
    const Group* groups, const int32_t* __restrict__ gmeta, int G,
    const uint32_t* __restrict__ slots, bool vec, int32_t* __restrict__ out,
    int cap2, int32_t* __restrict__ total) {
  uint32_t lo, hi;
  tail_words(corpus, n, p, lo, hi);
  for (int g = 0; g < G; ++g) {
    const Group r = kStaged ? groups[g] : load_group(gmeta, g);
    const int4 a = r.a;
    if (p < a.x) continue;
    const int4 b = r.b;
    const uint32_t h = avalanche_hash(lo & uint32_t(a.y), hi & uint32_t(a.z));
    const uint32_t sig = h >> 20;
    const uint32_t tmask = uint32_t(a.w);
    const uint32_t* tab = slots + b.y;
    const uint32_t first = h & tmask;
    const uint32_t skew = first & 3u;
    const int probes = b.x;
    if (vec && ((b.y | int(tmask + 1u)) & 3) == 0 && skew + probes <= kWords &&
        (first & ~3u) + kWords <= tmask + 1u) {
      const uint4* w = reinterpret_cast<const uint4*>(tab + (first & ~3u));
      const uint4 w0 = __ldg(w);
      const uint4 w1 = __ldg(w + 1);
      uint32_t hits =
          uint32_t(slot_hit(w0.x, sig)) | uint32_t(slot_hit(w0.y, sig)) << 1 |
          uint32_t(slot_hit(w0.z, sig)) << 2 |
          uint32_t(slot_hit(w0.w, sig)) << 3 |
          uint32_t(slot_hit(w1.x, sig)) << 4 |
          uint32_t(slot_hit(w1.y, sig)) << 5 |
          uint32_t(slot_hit(w1.z, sig)) << 6 |
          uint32_t(slot_hit(w1.w, sig)) << 7;
      hits = (hits >> skew) & ((1u << probes) - 1u);
      while (hits) {
        const int k = __ffs(hits) - 1;
        hits &= hits - 1u;
        const uint32_t sl = __ldg(tab + first + uint32_t(k));
        append(int32_t(sl & 0xFFFFFu), p, out, cap2, total);
      }
      continue;
    }
    for (int k = 0; k < probes; ++k) {
      const uint32_t sl = __ldg(tab + ((h + uint32_t(k)) & tmask));
      if (slot_hit(sl, sig)) append(int32_t(sl & 0xFFFFFu), p, out, cap2,
                                    total);
    }
  }
}

// kStaged: the group records are staged in shared memory (G <=
// kMaxStaged); else read from gmeta where they are used.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
hash_confirm_kernel(const uint8_t* __restrict__ corpus, long long n,
                    const int32_t* __restrict__ pos, int n_pos,
                    const int32_t* __restrict__ gmeta, int G,
                    const uint32_t* __restrict__ slots, bool vec,
                    int32_t* __restrict__ out, int cap2,
                    int32_t* __restrict__ total) {
  extern __shared__ Group groups[];  // [G] when staged
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the first slot's position and the staging in flight together
  int p = i < n_pos ? __ldg(pos + i) : -1;
  if (kStaged) {
    for (int g = threadIdx.x; g < G; g += kThreads)
      groups[g] = load_group(gmeta, g);
    __syncthreads();
  }
  for (; i < n_pos; i += stride) {
    const int cur = p;
    p = i + stride < n_pos ? __ldg(pos + i + stride) : -1;
    if (cur >= 0)
      confirm_one<kStaged>(corpus, n, cur, groups, gmeta, G, slots, vec, out,
                           cap2, total);
  }
}

// Blocks of the resident grid on the current device, cached per device
// and per variant.
template <bool kStaged>
int resident_blocks() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hash_confirm_kernel<kStaged>, kThreads, 0);
  const int blocks = (sms > 0 ? sms : 132) * (per_sm > 0 ? per_sm : 1);
  if (dev >= 0 && dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

template <bool kStaged>
cudaError_t launch(const void* corpus, long long n, const void* pos,
                   int n_pos, const void* gmeta, int G, const void* slots,
                   void* out, int cap2, void* total, cudaStream_t stream) {
  const size_t smem = kStaged ? size_t(G) * sizeof(Group) : 0;
  long long blocks = (n_pos + kThreads - 1) / kThreads;
  if (blocks > resident_blocks<kStaged>()) blocks = resident_blocks<kStaged>();
  hash_confirm_kernel<kStaged><<<int(blocks), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(corpus), n,
      static_cast<const int32_t*>(pos), n_pos,
      static_cast<const int32_t*>(gmeta), G,
      static_cast<const uint32_t*>(slots),
      (reinterpret_cast<uintptr_t>(slots) & 15) == 0,  // 16-byte reads
      static_cast<int32_t*>(out), cap2, static_cast<int32_t*>(total));
  return cudaGetLastError();
}

}  // namespace

// The kernel alone, on a counter the caller has zeroed.
extern "C" int hs_teddy_hash_confirm_launch(
    const void* corpus, long long n, const void* pos, int n_pos,
    const void* gmeta, int G, const void* slots, void* out, int cap2,
    void* total, void* stream) {
  if (n_pos <= 0 || G <= 0) return int(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return int(G <= kMaxStaged
                 ? launch<true>(corpus, n, pos, n_pos, gmeta, G, slots, out,
                                cap2, total, s)
                 : launch<false>(corpus, n, pos, n_pos, gmeta, G, slots, out,
                                 cap2, total, s));
}

// Zero the counter on the caller's stream, then the kernel.
extern "C" int hs_teddy_hash_confirm(
    const void* corpus, long long n, const void* pos, int n_pos,
    const void* gmeta, int G, const void* slots, void* out, int cap2,
    void* total, void* stream) {
  const cudaError_t rc = cudaMemsetAsync(total, 0, sizeof(int32_t),
                                         static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return int(rc);
  return hs_teddy_hash_confirm_launch(corpus, n, pos, n_pos, gmeta, G, slots,
                                      out, cap2, total, stream);
}

extern "C" const char* hs_teddy_hash_confirm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
