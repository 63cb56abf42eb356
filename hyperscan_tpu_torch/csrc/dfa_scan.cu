// Chunk-parallel DFA scan (sm_90a).
//
// Replaces the Pallas TPU kernel _make_kernel (with its select-tree table
// lookup _lookup) and the sparse_extract that follows it:
// hyperscan_tpu/ops/dfa_kernel.py:92, :77, launched by the pallas_call at
// hyperscan_tpu/ops/dfa_kernel.py:132, with hyperscan_tpu/ops/teddy.py:793.
//
// What it computes. Every chunk c has a row (start, vfrom, vto, entry)
// and steps through positions t = 0..511 of the flat corpus at start + t.
// Position t is live for vfrom <= t < vto; on a live position the state
// steps, s = trans[s * C + b2c[byte]], and for t >= H a nonzero
// accept[s] (read on the state after the step) is a record
// (c, t, accept id). The chunk's final state is the state after its last
// live position, its entry when none is live. Records go out through one
// atomic counter into a `cap` buffer; the counter keeps the exact total
// past cap. In plane mode (a non-null `plane`, an int32 array as long as the
// corpus) a record is written instead as plane[start + t] = accept id, which
// is the dense accept plane of the lockstep batch scan
// (hyperscan_tpu/ops/dfa.py:27 dfa_scan_batch, an XLA lax.scan in the
// reference): ops/dfa.py launches this kernel once per 512 bytes of its rows
// with H = 0, each launch entering in the finals of the one before.
//
// What bounds it. Each chunk step is a chain of two dependent lookups
// (b2c, then trans) plus the accept lookup, and the halo of H bytes is
// re-read by every chunk but a block's first. The bytes are read once
// (n bytes at 3.35 TB/s); the lookups bound the kernel: at shared-memory
// rate, 132 SMs x 32 lookups a clock; with tables in global memory, the
// L2's rate for random 4-byte reads, which is lower.
//
// Design. One thread per chunk, so the only serial dependence is the DFA
// recurrence itself and latency is hidden by the number of chunks in
// flight (a 256 MiB corpus has half a million). Neighbouring threads read
// bytes ~512 apart, so the bytes are not read from global memory by each
// thread: a block stages 128 positions of all its 128 chunks at a time
// into shared memory with coalesced 16-byte loads (9 per chunk row, to
// cover any alignment), and each row has an odd stride of 37 words so a
// warp's byte reads spread over the banks. b2c always lives in shared
// memory; trans and accept too when they fit (the `kShared` variant),
// otherwise they are read through the read-only path from global memory,
// where a table of a few MiB stays in the 50 MB L2. None of the TPU's
// select tree (O(rows) selects per lookup) is needed. Records are emitted
// with one atomic per warp and step (ballot, popcount), not per record.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;                   // H + CS positions a chunk
constexpr int kThreads = 128;                 // chunks per block
constexpr int kTile = 128;                    // positions staged per round
constexpr int kVecs = kTile / 16 + 1;         // 16-byte loads per row
constexpr int kRowWords = kVecs * 4 + 1;      // odd stride: 37 words
constexpr int kStageWords = kThreads * kRowWords;

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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
dfa_scan_kernel(const uint8_t* __restrict__ corpus, long long n,
                const int4* __restrict__ meta, int nch,
                const int32_t* __restrict__ trans,
                const int32_t* __restrict__ b2c,
                const int32_t* __restrict__ accept, int S, int C, int H,
                int32_t* __restrict__ recs, int cap,
                int32_t* __restrict__ total, int32_t* __restrict__ finals,
                int32_t* __restrict__ plane) {
  extern __shared__ int32_t smem[];
  uint32_t* s_stage = reinterpret_cast<uint32_t*>(smem);  // [kThreads][37]
  int32_t* s_b2c = smem + kStageWords;                    // [256]
  int32_t* s_trans = s_b2c + 256;                         // [S * C]
  int32_t* s_acc = s_trans + (kShared ? S * C : 0);       // [S]
  __shared__ long long s_base[kThreads];

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  for (int i = tid; i < 256; i += kThreads) s_b2c[i] = b2c[i];
  if (kShared) {
    for (int i = tid; i < S * C; i += kThreads) s_trans[i] = trans[i];
    for (int i = tid; i < S; i += kThreads) s_acc[i] = accept[i];
  }
  const int c = blockIdx.x * kThreads + tid;
  // padding threads (c >= nch) have no live position but take part in
  // the staging and the warp-wide emission
  const int4 m = c < nch ? meta[c] : make_int4(0, 0, 0, 0);
  const long long start = m.x;
  const long long base = start & ~15LL;  // floor to 16 (start may be < 0)
  const int off = int(start - base);
  const int vfrom = m.y, vto = m.z;
  int state = m.w;
  s_base[tid] = base;

  for (int t0 = 0; t0 < kChunk; t0 += kTile) {
    // also the barrier that keeps the previous round's readers ahead of
    // this round's stores
    if (!__syncthreads_or(vfrom < t0 + kTile && vto > t0)) continue;
    for (int i = tid; i < kThreads * kVecs; i += kThreads) {
      const int row = i / kVecs;
      const int v = i - row * kVecs;
      const uint4 q = load16(corpus, n, s_base[row] + t0 + 16 * v);
      uint32_t* dst = s_stage + row * kRowWords + 4 * v;
      dst[0] = q.x;
      dst[1] = q.y;
      dst[2] = q.z;
      dst[3] = q.w;
    }
    __syncthreads();
    const uint8_t* row =
        reinterpret_cast<const uint8_t*>(s_stage + tid * kRowWords) + off;
#pragma unroll 4
    for (int tau = 0; tau < kTile; ++tau) {
      const int t = t0 + tau;
      int aid = 0;
      if (t >= vfrom && t < vto) {
        const int idx = state * C + s_b2c[row[tau]];
        state = kShared ? s_trans[idx] : __ldg(trans + idx);
        if (t >= H) aid = kShared ? s_acc[state] : __ldg(accept + state);
      }
      if (plane != nullptr) {  // uniform across the grid
        if (aid != 0) plane[start + t] = aid;
        continue;
      }
      const unsigned hits = __ballot_sync(0xffffffffu, aid != 0);
      if (hits) {
        int r0 = 0;
        if (lane == 0) r0 = atomicAdd(total, __popc(hits));
        r0 = __shfl_sync(0xffffffffu, r0, 0);
        if (aid != 0) {
          const int r = r0 + __popc(hits & ((1u << lane) - 1u));
          if (r < cap) {
            recs[3 * r] = c;
            recs[3 * r + 1] = t;
            recs[3 * r + 2] = aid;
          }
        }
      }
    }
  }
  if (c < nch) finals[c] = state;
}

template <bool kShared>
cudaError_t launch(const uint8_t* corpus, long long n, const int4* meta,
                   int nch, const int32_t* trans, const int32_t* b2c,
                   const int32_t* accept, int S, int C, int H, int32_t* recs,
                   int cap, int32_t* total, int32_t* finals,
                   int32_t* plane, cudaStream_t stream) {
  const size_t smem =
      size_t(kStageWords + 256) * 4 +
      (kShared ? (size_t(S) * C + size_t(S)) * 4 : 0);
  auto kernel = dfa_scan_kernel<kShared>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (nch + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(corpus, n, meta, nch, trans,
                                             b2c, accept, S, C, H, recs, cap,
                                             total, finals, plane);
  return cudaGetLastError();
}

}  // namespace

// `plane` null: records mode; otherwise plane mode (recs, cap and total are
// not used).
extern "C" int hs_dfa_scan(const void* corpus, long long n, const void* meta,
                           int nch, const void* trans, const void* b2c,
                           const void* accept, int S, int C, int H,
                           int shared_tables, void* recs, int cap,
                           void* total, void* finals, void* plane,
                           void* stream) {
  if (nch <= 0) return int(cudaSuccess);
  const auto* cp = static_cast<const uint8_t*>(corpus);
  const auto* mp = static_cast<const int4*>(meta);
  const auto* tp = static_cast<const int32_t*>(trans);
  const auto* bp = static_cast<const int32_t*>(b2c);
  const auto* ap = static_cast<const int32_t*>(accept);
  auto* rp = static_cast<int32_t*>(recs);
  auto* np = static_cast<int32_t*>(total);
  auto* fp = static_cast<int32_t*>(finals);
  auto* pp = static_cast<int32_t*>(plane);
  auto s = static_cast<cudaStream_t>(stream);
  return int(shared_tables
                 ? launch<true>(cp, n, mp, nch, tp, bp, ap, S, C, H, rp, cap,
                                np, fp, pp, s)
                 : launch<false>(cp, n, mp, nch, tp, bp, ap, S, C, H, rp,
                                 cap, np, fp, pp, s));
}

extern "C" const char* hs_dfa_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
