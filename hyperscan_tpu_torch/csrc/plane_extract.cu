// One-pass extraction of the nonzero positions of a uint8 plane (sm_90a):
// the dense family's candidate list.
//
// Replaces sparse_extract (hyperscan_tpu/ops/teddy.py:793, XLA glue after the
// plane-mode pallas_call at :1116; EXTRACT_CHUNK = 256 at :997).
//
// What it computes. The plane is cut into 256-byte chunks; chunk c counts
// when 256 c < n_valid (so nonzero bytes inside the chunk that holds n_valid
// count, as in the reference: its callers bound-check them). Out: pos[k] =
// the position of the k-th nonzero byte of the counted chunks for k < cap1,
// ascending, -1 at and past the total; meta = (total nonzero bytes of the
// counted chunks, counted chunks holding one).
//
// What bounds it. Bytes: the plane is read once (n bytes at 3.35 TB/s,
// 0.160 ms for 512 MiB) and cap1 positions of 4 bytes are written.
//
// Design. One launch reads the plane once. A block takes a 64 KiB range by
// an atomic ticket (so a range waits only on ranges whose blocks already
// run, whatever order the card schedules blocks in) and walks it in eight
// 8 KiB steps: its 8 load warps start the next step's two 16-byte loads a
// thread (thread t takes bytes 16 t .. 16 t + 15 of each 4 KiB segment, so
// a warp's loads are contiguous) before they rank the current step's
// nonzero bytes (a byte compare and a popcount; the two counts of a thread
// packed as 16-bit fields, so one warp shuffle scan and one shared-memory
// pass rank both segments; a ballot a segment counts the hit chunks, 16
// lanes a chunk) into a shared buffer of the range's first 4,096 positions
// (1/16 of its bytes). Meanwhile a ninth warp learns the candidates before
// the range by a decoupled look-back: it reads the 64-bit status words
// (flag, hit chunks, count) of the 32 ranges before it, sums aggregates
// back to the nearest inclusive prefix, pausing 1 us before it reads a word
// that is not ready. Once the range is counted the block publishes its
// aggregate, and then, with the prefix, its inclusive prefix; it copies the
// buffer to pos coalesced (a range with more positions reads its bytes
// again for the rest), and the last range writes meta. The last 128 ranges
// fill pos past the total with -1, each a part, once the total is out, so
// the host clears only the status words and the ticket (one memset of 0xFF:
// all ones reads "not ready"). Measured on an H100 (700 W) with
// tools_torch_kernel_variants.py: one 16 KiB tile a ticket with its
// look-back by warp 0 after the count read 0.275 ms at the iid share
// against 0.173 with the look-back taken out; a ticket a range of tiles,
// the look-back beside the count and the pause cut the difference to
// about a third. The reference's two-level gather at a learned chunk
// capacity, and the chunk counts, cumsum and second pass of the previous
// port, are gone.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLoadWarps = 8;                     // warps that read bytes
constexpr int kLoadThreads = kLoadWarps * 32;
constexpr int kThreads = kLoadThreads + 32;       // and the look-back warp
constexpr int kLoads = 2;                         // 16-byte loads a thread
constexpr int kSegment = kLoadThreads * 16;       // bytes of one load round
constexpr int kTile = kSegment * kLoads;          // bytes a block step
constexpr int kSteps = 8;                         // steps a range
constexpr int kRange = kTile * kSteps;            // bytes a ticket
constexpr int kBuf = kRange / 16;  // positions a block holds in shared
constexpr int kChunkBytes = 256;
constexpr int kPacked = kLoads / 2;  // words of a thread's packed counts
constexpr unsigned kBackoffNs = 1000;  // pause before a status is read again
constexpr int kFillRanges = 128;  // the last ranges, which write the -1s
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSegment % kChunkBytes == 0, "a segment holds whole chunks");
static_assert(kLoads % 2 == 0 && kSegment < 65536,
              "two 16-bit counts a word, no field carries");

// Status word of a range: bits 0-30 candidates (the plane is < 2^31
// bytes), bits 31-53 hit chunks (< 2^23 chunks), bits 62-63 the flag. All
// ones (the host's memset) reads "not ready".
using u64 = unsigned long long;
constexpr u64 kValue = (u64(1) << 54) - 1;
constexpr u64 kAggregate = 0;
constexpr u64 kInclusive = u64(1) << 62;
constexpr u64 kFlags = u64(3) << 62;
constexpr int kChunkShift = 31;
constexpr u64 kCountMask = (u64(1) << kChunkShift) - 1;

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// a barrier of the load warps only (the look-back warp runs on)
__device__ __forceinline__ void load_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(kLoadThreads) : "memory");
}

// bit k set <=> byte k of the 16 is nonzero
__device__ __forceinline__ uint32_t nonzero_mask(const uint4 v) {
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

// A load thread's bytes of the tile at byte t0: bytes 16 tid .. 16 tid + 15
// of each segment; zero past n and in chunks at or past n_valid (those do
// not count, so their bytes are not read).
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ plane,
                                          long long n, long long n_valid,
                                          long long t0, uint4 v[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const long long p = t0 + (long long)i * kSegment + threadIdx.x * 16;
    v[i] = p < n && (p & ~(long long)(kChunkBytes - 1)) < n_valid
               ? __ldcs(reinterpret_cast<const uint4*>(plane + p))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Ranks of a load thread's nonzero bytes within one tile: mask[i] holds
// them for load i, rank[i] the rank of its first; returns the tile's count
// and adds the warp's hit chunks to `hits`. All load threads call it;
// `s_warp` alternates between calls (one barrier orders a call's reads
// before the second-next call's writes).
__device__ __forceinline__ int rank_tile(const uint4 v[kLoads],
                                         uint32_t mask[kLoads],
                                         uint32_t rank[kLoads],
                                         uint32_t (*s_warp)[kLoadWarps],
                                         uint32_t& hits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t packed[kPacked] = {};  // 16-bit fields: the loads' counts
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    mask[i] = nonzero_mask(v[i]);
    const uint32_t c = __popc(mask[i]);
    packed[i >> 1] |= c << (16 * (i & 1));
    const uint32_t b = __ballot_sync(kFull, c != 0);  // 16 lanes a chunk
    hits += ((b & 0xFFFFu) != 0u) + ((b >> 16) != 0u);
  }
  // warp inclusive scan of the packed counts (fields never carry: a
  // segment holds fewer than 65,536 bytes)
  uint32_t incl[kPacked];
#pragma unroll
  for (int h = 0; h < kPacked; ++h) incl[h] = packed[h];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int h = 0; h < kPacked; ++h) {
      const uint32_t u = __shfl_up_sync(kFull, incl[h], d);
      if (lane >= d) incl[h] += u;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int h = 0; h < kPacked; ++h) s_warp[h][warp] = incl[h];
  }
  load_barrier();
  uint32_t before[kPacked] = {}, total[kPacked] = {};
#pragma unroll
  for (int k = 0; k < kLoadWarps; ++k) {
#pragma unroll
    for (int h = 0; h < kPacked; ++h) {
      const uint32_t u = s_warp[h][k];
      if (k < warp) before[h] += u;
      total[h] += u;
    }
  }
  int first = 0;  // the tile's bytes before segment i
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int h = i >> 1, s = 16 * (i & 1);
    rank[i] = first + (((before[h] + incl[h] - packed[h]) >> s) & 0xFFFFu);
    first += (total[h] >> s) & 0xFFFFu;
  }
  return first;
}

__global__ void __launch_bounds__(kThreads)
extract_kernel(const uint8_t* __restrict__ plane, long long n,
               long long n_valid, int cap1, int n_ranges,
               int32_t* __restrict__ pos, u64* __restrict__ status,
               unsigned* __restrict__ ticket, long long* __restrict__ meta) {
  __shared__ int32_t s_buf[kBuf];  // the range's first kBuf positions
  __shared__ uint32_t s_warp[2][kPacked][kLoadWarps];
  __shared__ uint32_t s_hits[kLoadWarps];
  __shared__ int s_range;
  __shared__ u64 s_aggregate, s_prefix;
  __shared__ long long s_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_range = int(atomicAdd(ticket, 1u) + 1u);  // from all ones
  __syncthreads();
  const int range = s_range;
  const long long r0 = (long long)range * kRange;

  int count = 0;  // the range's candidates (every load thread holds it)
  if (warp < kLoadWarps) {
    uint32_t hits = 0;
    uint4 v[2][kLoads];  // this step's bytes and the next step's
    load_tile(plane, n, n_valid, r0, v[0]);
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      if (st + 1 < kSteps)
        load_tile(plane, n, n_valid, r0 + (long long)(st + 1) * kTile,
                  v[(st + 1) & 1]);
      uint32_t mask[kLoads], rank[kLoads];
      const int c = rank_tile(v[st & 1], mask, rank, s_warp[st & 1], hits);
      const long long t0 = r0 + (long long)st * kTile + tid * 16;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        int r = count + int(rank[i]);
        const int p = int(t0 + (long long)i * kSegment);
        for (uint32_t m = mask[i]; m && r < kBuf; m &= m - 1)
          s_buf[r++] = p + __ffs(m) - 1;
      }
      count += c;
    }
    if (lane == 31) s_hits[warp] = hits;
    load_barrier();
    if (tid == 0) {
      u64 all_hits = 0;
#pragma unroll
      for (int k = 0; k < kLoadWarps; ++k) all_hits += s_hits[k];
      const u64 aggregate = u64(count) | (all_hits << kChunkShift);
      s_aggregate = aggregate;
      // range 0's aggregate is its inclusive prefix
      store_status(&status[range],
                   (range ? kAggregate : kInclusive) | aggregate);
    }
  } else if (range > 0) {
    // the look-back warp, while the load warps count this range: the
    // candidates and hit chunks of the ranges before it, summed back to
    // the nearest inclusive prefix, 32 status words a step
    u64 prefix = 0;
    for (int end = range - 1;; end -= 32) {  // end: the step's nearest
      const int idx = end - lane;
      u64 s = kInclusive;  // past range 0: an empty inclusive prefix
      if (idx >= 0) {
        s = load_status(&status[idx]);
        while ((s & kFlags) == kFlags) {
          __nanosleep(kBackoffNs);
          s = load_status(&status[idx]);
        }
      }
      const unsigned inc = __ballot_sync(kFull, (s & kFlags) == kInclusive);
      const bool take = lane <= (inc ? __ffs(inc) - 1 : 31);
      // the two fields summed apart, one warp reduction each
      const uint32_t cnt = __reduce_add_sync(
          kFull, take ? uint32_t(s & kCountMask) : 0u);
      const uint32_t hit = __reduce_add_sync(
          kFull, take ? uint32_t((s & kValue) >> kChunkShift) : 0u);
      prefix += cnt | (u64(hit) << kChunkShift);
      if (inc) break;
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const u64 prefix = range ? s_prefix : 0;
  if (warp == kLoadWarps) {
    if (lane == 0) {
      const u64 all = prefix + s_aggregate;
      if (range) store_status(&status[range], kInclusive | all);
      if (range == n_ranges - 1) {
        meta[0] = (long long)(all & kCountMask);
        meta[1] = (long long)(all >> kChunkShift);
      }
    }
    return;
  }
  const long long first = (long long)(prefix & kCountMask);
  if (first < cap1) {
    // the buffered positions, coalesced
    const int held = count < kBuf ? count : kBuf;
    for (int k = tid; k < held && first + k < cap1; k += kLoadThreads)
      pos[first + k] = s_buf[k];
    if (count > kBuf) {
      // a range with more than kBuf candidates: its bytes read again, the
      // ranks past kBuf written from registers
      uint32_t hits = 0;
      int before = 0;
      for (int st = 0; st < kSteps; ++st) {
        uint4 v[kLoads];
        uint32_t mask[kLoads], rank[kLoads];
        load_tile(plane, n, n_valid, r0 + (long long)st * kTile, v);
        const int c = rank_tile(v, mask, rank, s_warp[st & 1], hits);
        const long long t0 = r0 + (long long)st * kTile + tid * 16;
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          long long r = first + before + rank[i];
          const long long p = t0 + (long long)i * kSegment;
          for (uint32_t m = mask[i]; m && r < cap1; m &= m - 1, ++r)
            if (r - first >= kBuf) pos[r] = int32_t(p + __ffs(m) - 1);
        }
        before += c;
      }
    }
  }
  // the last kFillRanges ranges fill pos past the total with -1, each a
  // part, once the last range's inclusive prefix (the total) is out
  const int fillers = n_ranges < kFillRanges ? n_ranges : kFillRanges;
  if (range < n_ranges - fillers) return;
  if (tid == 0) {
    u64 s = load_status(&status[n_ranges - 1]);
    while ((s & kFlags) != kInclusive) {
      __nanosleep(kBackoffNs);
      s = load_status(&status[n_ranges - 1]);
    }
    s_total = (long long)(s & kCountMask);
  }
  load_barrier();
  const long long total = s_total;
  if (total >= cap1) return;
  const long long part = (cap1 - total + fillers - 1) / fillers;
  const long long lo = total + (range - (n_ranges - fillers)) * part;
  const long long hi = lo + part < cap1 ? lo + part : cap1;
  for (long long k = lo + tid; k < hi; k += kLoadThreads) pos[k] = -1;
}

}  // namespace

// `buf` holds, in order: pos (cap1 int32, padded to 8 bytes), the status
// words (one a range of kRange bytes, uint64), the ticket (8 bytes) and meta
// (2 int64). One memset of 0xFF over the status words and the ticket, then
// one launch.
extern "C" int hs_plane_extract(const void* plane, long long n,
                                long long n_valid, int cap1, void* buf,
                                void* stream) {
  if (n < 0 || cap1 < 1) return int(cudaErrorInvalidValue);
  const long long ranges = n > 0 ? (n + kRange - 1) / kRange : 1;
  if (ranges >= (1ll << 31)) return int(cudaErrorInvalidValue);
  const int n_ranges = int(ranges);
  auto s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(buf);
  const size_t pos_bytes = (size_t(cap1) * 4 + 7) & ~size_t(7);
  auto* status = reinterpret_cast<u64*>(base + pos_bytes);
  auto* ticket = reinterpret_cast<unsigned*>(status + n_ranges);
  auto* meta = reinterpret_cast<long long*>(status + n_ranges + 1);
  cudaError_t e =
      cudaMemsetAsync(status, 0xFF, size_t(n_ranges + 1) * 8, s);
  if (e != cudaSuccess) return int(e);
  extract_kernel<<<n_ranges, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(plane), n, n_valid, cap1, n_ranges,
      reinterpret_cast<int32_t*>(base), status, ticket, meta);
  return int(cudaGetLastError());
}

// Bytes of the buffer hs_plane_extract takes for a plane of n bytes.
extern "C" long long hs_plane_extract_buffer_bytes(long long n, int cap1) {
  const long long ranges = n > 0 ? (n + kRange - 1) / kRange : 1;
  return (((long long)cap1 * 4 + 7) & ~7ll) + (ranges + 1 + 2) * 8;
}

extern "C" const char* hs_plane_extract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
