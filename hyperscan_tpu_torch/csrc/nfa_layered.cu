// Layered acyclic bit-NFA sweep (sm_90a).
//
// Replaces the Pallas TPU kernel _make_layered_kernel
// (hyperscan_tpu/ops/nfa_kernel.py:390, launched by the pallas_call at
// :476, which serves P <= 48) and the XLA sweep _make_scan_fn (:107, the
// rest up to P = 512), each followed by sparse_extract
// (hyperscan_tpu/ops/teddy.py:793).
//
// What it computes. Over the bytes of the given blocks (ascending,
// disjoint intervals [bstart, bend) of the flat corpus; every other byte
// is dead), for every position r in topological order:
//   A_r[t] = cls_r(x[t]) & valid[t] & (float_r | anch_r & anch[t]
//            | cont[t] & OR_{u -> r} A_u[t-1])
// with cont[t] = 0 at a block's first byte (no activation crosses a block
// boundary) and anch[t] = 1 only at the first byte of an anchored block.
// Every byte t with an accepting position active is a record
// (t, OR of 1 << (g-1) over the accept sets g of its active positions);
// every block's EOD bits are the same OR over EOD accept sets at its last
// byte. Records go out through one atomic counter into a `cap` buffer; the
// counter keeps the exact total past cap.
//
// What bounds it. Per 32-byte word: one shift-or per edge, a handful of
// bitwise operations per position and 32 bit tests per class (byte ->
// class membership), so word operations grow as (P + edges + 32 K) / 32
// a byte, plus the halo (max_depth rounded to a word) re-read before each
// thread's segment. The corpus is read about once; the operations bound
// the kernel for any engine of more than a few positions.
//
// Design. Bit-slicing along the corpus: one uint32 holds one position's
// activity over 32 consecutive bytes, so each bitwise operation advances
// 32 bytes. One thread owns one segment of the span and walks it word by
// word from a halo before it; the shift by one byte is (w << 1) | (bit 31
// of the previous word), so each thread keeps two words per position (the
// current and the previous one, alternating) and one word per class, in
// shared memory laid out [slot][thread] so that a warp's accesses fall in
// distinct banks. One kernel serves every eligible engine: the plan
// (packed per-position info, predecessors in CSR form, 256-bit class
// bitmaps) is data, read through the read-only path (uniform across a warp)
// and, for the bitmaps, from shared memory; the block count per launch is
// chosen so the per-thread words fit the shared memory of a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 32;
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr size_t kSmemTarget = 96 * 1024;  // two blocks per SM
constexpr int kClassMask = 0x3FF;
constexpr int kFloat = 1 << 10;
constexpr int kAnch = 1 << 11;
constexpr int kGidShift = 12;
constexpr int kEodShift = 17;

__device__ __forceinline__ uint32_t bit_range(long long a, long long b) {
  // bits [a, b) of a word, 0 <= a < b <= 32
  const uint32_t hi = b >= 32 ? 0xFFFFFFFFu : ((1u << b) - 1u);
  return hi & ~((1u << a) - 1u);
}

// OR of 1 << (g - 1) over the positions active at bit j whose field at
// `shift` names accept set g (0 = none).
__device__ __forceinline__ int32_t set_bits(const int32_t* __restrict__ info,
                                            const uint32_t* cur, int T,
                                            int P, int j, int shift) {
  int32_t v = 0;
  for (int r = 0; r < P; ++r) {
    const int g = (__ldg(info + r) >> shift) & 31;
    if (g && ((cur[r * T] >> j) & 1u)) v |= 1 << (g - 1);
  }
  return v;
}

__global__ void __launch_bounds__(kMaxThreads)
nfa_layered_kernel(const uint8_t* __restrict__ corpus, long long n,
                   const int32_t* __restrict__ info,
                   const int32_t* __restrict__ pred_ptr,
                   const int32_t* __restrict__ pred_idx,
                   const uint32_t* __restrict__ cbits, int P, int K,
                   const long long* __restrict__ bstart,
                   const long long* __restrict__ bend,
                   const uint8_t* __restrict__ banch, int nb,
                   long long span_lo, long long span_len, int halo, int seg,
                   int32_t* __restrict__ recs, int cap,
                   int32_t* __restrict__ total,
                   int32_t* __restrict__ eod_out) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  uint32_t* s_cbits = smem;                           // [K][8]
  uint32_t* s_words = s_cbits + 8 * K + tid;          // [2][P][T]
  uint32_t* s_cls = s_cbits + 8 * K + 2 * P * T + tid;  // [K][T]
  for (int i = tid; i < 8 * K; i += T) s_cbits[i] = cbits[i];
  __syncthreads();

  const long long g = (long long)blockIdx.x * T + tid;
  const long long span_hi = span_lo + span_len;
  const long long lo = span_lo + g * seg;
  if (lo >= span_hi) return;
  const long long hi = lo + seg < span_hi ? lo + seg : span_hi;
  long long w0 = lo - halo;
  if (w0 < span_lo) w0 = span_lo;

  // the "previous" words of the first word are zero: nothing before w0
  for (int r = 0; r < P; ++r) s_words[(P + r) * T] = 0u;
  // first block still open at w0
  int k;
  {
    int a = 0, b = nb;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (bend[mid] <= w0) a = mid + 1; else b = mid;
    }
    k = a;
  }
  int par = 0;
  for (long long wlo = w0; wlo < hi; wlo += kWord, par ^= 1) {
    uint32_t* cur = s_words + par * P * T;
    const uint32_t* prv = s_words + (par ^ 1) * P * T;
    const long long whi = wlo + kWord;
    // validity, block starts and anchors of this word's bytes
    uint32_t valid = 0u, startb = 0u, anchb = 0u;
    for (int kk = k; kk < nb && bstart[kk] < whi; ++kk) {
      const long long a = bstart[kk] > wlo ? bstart[kk] : wlo;
      const long long b = bend[kk] < whi ? bend[kk] : whi;
      if (a < b) valid |= bit_range(a - wlo, b - wlo);
      if (bstart[kk] >= wlo) {
        const uint32_t bit = 1u << (bstart[kk] - wlo);
        startb |= bit;
        if (banch[kk]) anchb |= bit;
      }
    }
    const int k0 = k;  // blocks ending in this word start here
    while (k < nb && bend[k] <= whi) ++k;
    if (valid == 0u) {
      for (int r = 0; r < P; ++r) cur[r * T] = 0u;
      continue;
    }
    uint32_t x[8];
    if (wlo + kWord <= n) {
      const uint4 q0 = *reinterpret_cast<const uint4*>(corpus + wlo);
      const uint4 q1 = *reinterpret_cast<const uint4*>(corpus + wlo + 16);
      x[0] = q0.x; x[1] = q0.y; x[2] = q0.z; x[3] = q0.w;
      x[4] = q1.x; x[5] = q1.y; x[6] = q1.z; x[7] = q1.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0u;
      for (int j = 0; j < kWord && wlo + j < n; ++j)
        x[j >> 2] |= uint32_t(corpus[wlo + j]) << ((j & 3) * 8);
    }
    // class words: bit j of class c = byte j in class c
    for (int c = 0; c < K; ++c) {
      const uint32_t* bm = s_cbits + 8 * c;
      uint32_t w = 0u;
#pragma unroll
      for (int j = 0; j < kWord; ++j) {
        const uint32_t b = (x[j >> 2] >> ((j & 3) * 8)) & 0xFFu;
        w |= ((bm[b >> 5] >> (b & 31u)) & 1u) << j;
      }
      s_cls[c * T] = w;
    }
    // the sweep, in topological order
    const uint32_t cont = valid & ~startb;
    uint32_t acc_any = 0u, eod_any = 0u;
    for (int r = 0; r < P; ++r) {
      const int v = __ldg(info + r);
      uint32_t pred = 0u;
      const int e1 = __ldg(pred_ptr + r + 1);
      for (int e = __ldg(pred_ptr + r); e < e1; ++e) {
        const int u = __ldg(pred_idx + e);
        pred |= (cur[u * T] << 1) | (prv[u * T] >> 31);
      }
      uint32_t in = pred & cont;
      if (v & kFloat) in |= valid;
      if (v & kAnch) in |= anchb;
      const uint32_t a = in & s_cls[(v & kClassMask) * T] & valid;
      cur[r * T] = a;
      if ((v >> kGidShift) & 31) acc_any |= a;
      if ((v >> kEodShift) & 31) eod_any |= a;
    }
    if (wlo < lo) continue;  // halo: no output
    if (acc_any) {
      int r = atomicAdd(total, __popc(acc_any));
      for (uint32_t m = acc_any; m; m &= m - 1u, ++r) {
        const int j = __ffs(m) - 1;
        if (r < cap) {
          recs[2 * r] = int32_t(wlo + j);
          recs[2 * r + 1] = set_bits(info, cur, T, P, j, kGidShift);
        }
      }
    }
    for (int kk = k0; kk < nb && bend[kk] <= whi; ++kk) {
      const int j = int(bend[kk] - 1 - wlo);  // the block's last byte
      eod_out[kk] = ((eod_any >> j) & 1u)
                        ? set_bits(info, cur, T, P, j, kEodShift)
                        : 0;
    }
  }
}

}  // namespace

extern "C" int hs_nfa_layered(const void* corpus, long long n,
                              const void* info, const void* pred_ptr,
                              const void* pred_idx, const void* cbits, int P,
                              int K, const void* bstart, const void* bend,
                              const void* banch, int nb, long long span_lo,
                              long long span_len, int halo, int seg,
                              void* recs, int cap, void* total,
                              void* eod_out, void* stream) {
  if (nb <= 0 || span_len <= 0) return int(cudaSuccess);
  if (P <= 0 || K < 0 || seg <= 0 || seg % kWord || halo % kWord ||
      span_lo % kWord)
    return int(cudaErrorInvalidValue);
  // the widest block whose per-thread words fit the target, at least 32
  const size_t per_thread = (2 * size_t(P) + size_t(K)) * 4;
  int T = kMaxThreads;
  while (T > kMinThreads && per_thread * T + 32 * size_t(K) > kSmemTarget)
    T >>= 1;
  const size_t smem = per_thread * T + 32 * size_t(K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nfa_layered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const long long threads = (span_len + seg - 1) / seg;
  const long long blocks = (threads + T - 1) / T;
  nfa_layered_kernel<<<unsigned(blocks), T, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(corpus), n,
      static_cast<const int32_t*>(info), static_cast<const int32_t*>(pred_ptr),
      static_cast<const int32_t*>(pred_idx),
      static_cast<const uint32_t*>(cbits), P, K,
      static_cast<const long long*>(bstart),
      static_cast<const long long*>(bend),
      static_cast<const uint8_t*>(banch), nb, span_lo, span_len, halo, seg,
      static_cast<int32_t*>(recs), cap, static_cast<int32_t*>(total),
      static_cast<int32_t*>(eod_out));
  return int(cudaGetLastError());
}

extern "C" const char* hs_nfa_layered_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
