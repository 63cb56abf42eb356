// DFA scans (sm_90a): the chunk scan of kernel C, and its row mode, the
// lockstep scan of a batch of rows.
//
// Replaces the Pallas TPU kernel _make_kernel (with its select-tree table
// lookup _lookup) and the sparse_extract that follows it:
// hyperscan_tpu/ops/dfa_kernel.py:92, :77, launched by the pallas_call at
// hyperscan_tpu/ops/dfa_kernel.py:132, with hyperscan_tpu/ops/teddy.py:793;
// and, in row mode, the XLA lax.scan of the lockstep batch scan
// (hyperscan_tpu/ops/dfa.py:27 dfa_scan_batch).
//
// What the chunk scan computes. Every chunk c has a row (start, vfrom, vto,
// entry) and steps through positions t = 0..511 of the flat corpus at
// start + t. Position t is live for vfrom <= t < vto; on a live position the
// state steps, s = trans[s * C + b2c[byte]], and for t >= H a nonzero
// accept[s] (read on the state after the step) is a record (c, t, accept
// id). The chunk's final state is the state after its last live position,
// its entry when none is live. Records go out through one atomic counter
// into a `cap` buffer; the counter keeps the exact total past cap.
//
// What the row mode computes. For B rows of L bytes (row r at data + r * L)
// with a valid length len_r and an entry state s_r: the same step over
// positions t < len_r of the row from s_r, plane[r * L + t] = accept[s] on
// the state after the step for t < len_r and 0 for len_r <= t < L (the
// whole [B, L] int32 accept plane is written, zeros included), and
// finals[r] = the state after position len_r - 1 (s_r when len_r = 0). This
// is exact for any DFA: nothing is speculative.
//
// What bounds them. The chunk scan reads the bytes once (n bytes at 3.35
// TB/s, plus the H-byte halos) and does one class map and one transition a
// live position: at shared-memory rate, 132 SMs x 32 lookups a clock, the
// lookups bound it (with tables in global memory, the L2's rate for random
// reads, which is lower). The row mode reads n bytes and writes the 4n
// bytes of the plane: device memory bounds it, and below that the serial
// chain of one row (L dependent lookups) where the rows are few.
//
// Design of the chunk scan. One thread per chunk, so the only serial
// dependence is the DFA recurrence itself and latency is hidden by the
// number of chunks in flight (a 256 MiB corpus has half a million). Each
// thread streams its own chunk's bytes from global memory in 16-byte
// loads, two ahead of the vector it steps through; a chunk's 128-byte lines
// are read by one thread over eight loads and stay in L1/L2 meanwhile, so
// nothing is staged in shared memory and no barrier follows the tables'
// build (staging a block's tiles through shared memory, the first design,
// cost a barrier pair and the staging's latency every 128 positions, and
// its shared footprint capped the warps an SM: PERF.md). The class map is
// held as 32 copies (byte b * 32 + lane), so a warp's 32 lookups of random
// bytes spread over the banks. With shared tables the block builds a step
// table whose (state, class) entry packs 4 (next state * C) in 16 bits and
// the next state's accept id in the other 16, and a thread carries 4
// (state * C): the chain from one position to the next is an add, one
// 32-bit shared load and a mask, and the accept id comes with it (a scanning
// DFA's states cluster, so a warp's entries mostly lie in one row of the
// table: distinct banks). Tables too large for shared memory (or accept ids
// past 16 bits) are read through the read-only path (the chain is then a
// multiply and two L1/L2 loads). The live window is tested only on a
// chunk's first and last vectors, the halo only where an accept id is
// nonzero; a record, rare, is written by a warp-aggregated atomic of the
// lanes that hold one. Blocks walk the chunks of a resident grid, so the
// tables are built once a block. None of the TPU's select tree (O(rows)
// selects per lookup) is needed.
//
// Design of the row mode. One launch for the whole batch, one thread a row
// over its whole length, so no host work between chunks (the batch scan was
// once 32 launches of the chunk scan, each prepared by the host). The
// serial chain of a row sets its time, so the chain is cut to one add and
// one 8-byte shared load a byte: each block builds, from trans and accept, a
// step table whose (state, class) entry holds (next state * C, accept id of
// the next state), and a thread carries its state times C; the byte's class
// (a shared b2c lookup) and the 16-byte load of its bytes do not depend on
// the state and run ahead of the chain (two loads in flight a thread; the
// rest of a row's 128-byte line comes from L1). Each thread stores its
// row's accept ids 16 bytes at a time, zeros past the row's length
// included, so the plane needs no memset. A block is one warp of 32 rows
// and needs no barrier; blocks walk the row groups of a resident grid.
// Tables too large for shared memory are read through the read-only path
// (the chain is then a multiply and an L1/L2 load). Rows whose length is
// not a multiple of 16 (or unaligned data) take 1-byte loads and 4-byte
// stores.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;                 // chunks in flight a block
constexpr int kMapBytes = 256 * 32;           // the class map's 32 copies

// 16 bytes at p (a multiple of 16); zero for bytes before 0 or at/after n.
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ corpus,
                                        long long n, long long p) {
  if (p >= 0 && p + 16 <= n)
    return __ldg(reinterpret_cast<const uint4*>(corpus + p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long q = p + k;
    if (q >= 0 && q < n) w[k >> 2] |= uint32_t(corpus[q]) << ((k & 3) * 8);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Allow `smem` bytes of dynamic shared memory, then return the grid of a
// resident launch: as many blocks of `threads` as fit on the current card
// at once, and no more than `want`. 0 and an error in `err` on failure.
template <typename Kernel>
int resident_grid(Kernel kernel, int threads, size_t smem, int want,
                  cudaError_t& err) {
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return 0;
  if (per_sm < 1) {
    err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const long long fit = (long long)per_sm * sms;
  return int(fit < want ? fit : want);
}

// One record (c, t, aid): the lanes that hold a record now take one slot
// range with one atomic; the counter keeps the exact total past cap.
__device__ __forceinline__ void emit(int32_t* __restrict__ recs, int cap,
                                     int32_t* __restrict__ total, int c,
                                     int t, int aid) {
  const cg::coalesced_group g = cg::coalesced_threads();
  int r0 = 0;
  if (g.thread_rank() == 0) r0 = atomicAdd(total, int(g.size()));
  const int r = g.shfl(r0, 0) + int(g.thread_rank());
  if (r < cap) {
    recs[3 * r] = c;
    recs[3 * r + 1] = t;
    recs[3 * r + 2] = aid;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
dfa_scan_kernel(const uint8_t* __restrict__ corpus, long long n,
                const int4* __restrict__ meta, int nch,
                const int32_t* __restrict__ trans,
                const int32_t* __restrict__ b2c,
                const int32_t* __restrict__ accept, int S, int C, int H,
                int32_t* __restrict__ recs, int cap,
                int32_t* __restrict__ total, int32_t* __restrict__ finals) {
  extern __shared__ __align__(16) int32_t smem[];
  uint32_t* s_step = reinterpret_cast<uint32_t*>(smem);  // [S * C], kShared
  uint8_t* s_map =
      reinterpret_cast<uint8_t*>(s_step + (kShared ? S * C : 0));
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the class map: byte b * 32 + l is copy l of b2c[b], so lane l's
  // lookups fall in the bank of word 8 b + l / 4 (four lanes a word)
  for (int i = tid; i < kMapBytes; i += kThreads)
    s_map[i] = uint8_t(b2c[i >> 5]);
  if (kShared) {
    // the step table: (state, class) -> 4 (next state * C) in the low 16
    // bits, the next state's accept id in the high 16 (the wrapper keeps
    // both in range), so a thread carrying 4 (state * C) finds the entry
    // of class c at byte offset st + 4 c
    for (int i = tid; i < S * C; i += kThreads) {
      const int nx = trans[i];
      s_step[i] = uint32_t(nx * C * 4) | uint32_t(accept[nx]) << 16;
    }
  }
  __syncthreads();
  const uint8_t* my_map = s_map + lane;

  for (int c = blockIdx.x * kThreads + tid; c < nch;
       c += gridDim.x * kThreads) {
    const int4 m = meta[c];
    const int vfrom = m.y, vto = m.z;
    uint32_t st = kShared ? uint32_t(m.w * C * 4) : uint32_t(m.w);
    // one live position of byte b; returns the accept id after the step
    auto step = [&](uint32_t b) -> int {
      const uint32_t cls = my_map[b << 5];
      if constexpr (kShared) {
        const uint32_t e = *reinterpret_cast<const uint32_t*>(
            reinterpret_cast<const uint8_t*>(s_step) + st + (cls << 2));
        st = e & 0xFFFFu;
        return int(e >> 16);
      } else {
        st = uint32_t(__ldg(trans + st * C + cls));
        return __ldg(accept + st);
      }
    };
    if (vfrom < vto) {
      // the live bytes start + vfrom .. start + vto - 1, in the 16-byte
      // vectors that cover them, two loads ahead of the one being stepped
      const long long p0 = (long long)m.x + vfrom;
      const long long a0 = p0 & ~15LL;  // floor to 16 (p0 may be < 0)
      const int nvec = int(((long long)m.x + vto - a0 + 15) >> 4);
      int t = vfrom - int(p0 - a0);  // the position of byte a0
      uint4 cur = load16(corpus, n, a0);
      uint4 nxt = nvec > 1 ? load16(corpus, n, a0 + 16)
                           : make_uint4(0u, 0u, 0u, 0u);
      for (int k = 0; k < nvec; ++k, t += 16) {
        const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
        cur = nxt;
        if (k + 2 < nvec) nxt = load16(corpus, n, a0 + 16 * (k + 2));
        if (t >= vfrom && t + 16 <= vto) {  // the whole vector live
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int aid = step((w[e >> 2] >> (8 * (e & 3))) & 0xFFu);
            if (aid != 0 && t + e >= H) emit(recs, cap, total, c, t + e, aid);
          }
        } else {  // a chunk's first or last vector
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int te = t + e;
            if (te >= vfrom && te < vto) {
              const int aid = step((w[e >> 2] >> (8 * (e & 3))) & 0xFFu);
              if (aid != 0 && te >= H) emit(recs, cap, total, c, te, aid);
            }
          }
        }
      }
    }
    finals[c] = kShared ? int(st / 4) / C : int(st);
  }
}

template <bool kShared>
cudaError_t launch(const uint8_t* corpus, long long n, const int4* meta,
                   int nch, const int32_t* trans, const int32_t* b2c,
                   const int32_t* accept, int S, int C, int H, int32_t* recs,
                   int cap, int32_t* total, int32_t* finals,
                   cudaStream_t stream) {
  const size_t smem = kMapBytes + (kShared ? size_t(S) * C * 4 : 0);
  auto kernel = dfa_scan_kernel<kShared>;
  cudaError_t e;
  const int grid = resident_grid(kernel, kThreads, smem,
                                 (nch + kThreads - 1) / kThreads, e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(corpus, n, meta, nch, trans, b2c,
                                           accept, S, C, H, recs, cap, total,
                                           finals);
  return cudaGetLastError();
}

constexpr int kRowThreads = 32;  // rows a block: one warp
constexpr int kAhead = 2;        // 16-byte loads a row keeps in flight

// One step of a row in shared-table mode: `st` is the state times C, and
// the entry of (state, class) holds (next state * C, accept id of the next
// state), so the chain from byte to byte is one add and one 8-byte load.
__device__ __forceinline__ int step_shared(const int2* s_step, int& st,
                                           int cls) {
  const int2 e = s_step[st + cls];
  st = e.x;
  return e.y;
}

// One step in global-table mode: `st` is the state.
__device__ __forceinline__ int step_global(const int32_t* trans,
                                           const int32_t* accept, int C,
                                           int& st, int cls) {
  st = __ldg(trans + st * C + cls);
  return __ldg(accept + st);
}

template <bool kShared>
__global__ void __launch_bounds__(kRowThreads)
dfa_rows_kernel(const uint8_t* __restrict__ data, int B, int L, bool vec,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ states0,
                const int32_t* __restrict__ trans,
                const int32_t* __restrict__ b2c,
                const int32_t* __restrict__ accept, int S, int C,
                int32_t* __restrict__ plane, int32_t* __restrict__ finals) {
  extern __shared__ __align__(16) int32_t smem[];
  int2* s_step = reinterpret_cast<int2*>(smem);  // [S * C], kShared
  __shared__ uint8_t s_b2c[256];
  const int lane = threadIdx.x;
  for (int i = lane; i < 256; i += kRowThreads) s_b2c[i] = uint8_t(b2c[i]);
  if (kShared) {
    for (int i = lane; i < S * C; i += kRowThreads) {
      const int nx = trans[i];
      s_step[i] = make_int2(nx * C, accept[nx]);
    }
  }
  __syncwarp();
  auto step = [&](int& st, uint32_t byte) {
    const int cls = s_b2c[byte];
    return kShared ? step_shared(s_step, st, cls)
                   : step_global(trans, accept, C, st, cls);
  };

  for (int g0 = blockIdx.x * kRowThreads; g0 < B;
       g0 += gridDim.x * kRowThreads) {
    const int row = g0 + lane;
    if (row >= B) continue;
    const int len = min(max(lengths[row], 0), L);
    int st = kShared ? states0[row] * C : states0[row];
    const uint8_t* src = data + (long long)row * L;
    int32_t* dst = plane + (long long)row * L;
    int t = 0;
    if (vec) {
      // 16 bytes a load, kAhead loads in flight (the row's 128-byte lines
      // stay in L1 for the loads after the first), 4 ids a 16-byte store
      const uint4* src16 = reinterpret_cast<const uint4*>(src);
      int4* dst4 = reinterpret_cast<int4*>(dst);
      const int n16 = len >> 4;
      uint4 buf[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        buf[k] = k < n16 ? __ldg(src16 + k) : make_uint4(0u, 0u, 0u, 0u);
      for (int k = 0; k < n16; ++k) {
        const uint4 cur = buf[0];
#pragma unroll
        for (int j = 0; j + 1 < kAhead; ++j) buf[j] = buf[j + 1];
        buf[kAhead - 1] = k + kAhead < n16 ? __ldg(src16 + k + kAhead)
                                           : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t w[4] = {cur.x, cur.y, cur.z, cur.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int4 out;
          out.x = step(st, w[e] & 0xFFu);
          out.y = step(st, (w[e] >> 8) & 0xFFu);
          out.z = step(st, (w[e] >> 16) & 0xFFu);
          out.w = step(st, w[e] >> 24);
          dst4[4 * k + e] = out;
        }
      }
      t = n16 << 4;
    }
    for (; t < len; ++t) dst[t] = step(st, __ldg(src + t));
    // zeros past the row's length, 16 bytes a store once aligned
    for (; t < L && (!vec || (t & 3)); ++t) dst[t] = 0;
    for (; t + 4 <= L; t += 4)
      *reinterpret_cast<int4*>(dst + t) = make_int4(0, 0, 0, 0);
    for (; t < L; ++t) dst[t] = 0;
    finals[row] = kShared ? st / C : st;
  }
}

template <bool kShared>
cudaError_t launch_rows(const uint8_t* data, int B, int L, bool vec,
                        const int32_t* lengths, const int32_t* states0,
                        const int32_t* trans, const int32_t* b2c,
                        const int32_t* accept, int S, int C, int32_t* plane,
                        int32_t* finals, cudaStream_t stream) {
  const size_t smem = kShared ? size_t(S) * C * 8 : 0;
  auto kernel = dfa_rows_kernel<kShared>;
  cudaError_t e;
  const int grid = resident_grid(kernel, kRowThreads, smem,
                                 (B + kRowThreads - 1) / kRowThreads, e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kRowThreads, smem, stream>>>(data, B, L, vec, lengths,
                                              states0, trans, b2c, accept, S,
                                              C, plane, finals);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hs_dfa_scan(const void* corpus, long long n, const void* meta,
                           int nch, const void* trans, const void* b2c,
                           const void* accept, int S, int C, int H,
                           int shared_tables, void* recs, int cap,
                           void* total, void* finals, void* stream) {
  if (nch <= 0) return int(cudaSuccess);
  // the class map holds class ids as bytes
  if (C < 1 || C > 256 || S < 1) return int(cudaErrorInvalidValue);
  const auto* cp = static_cast<const uint8_t*>(corpus);
  const auto* mp = static_cast<const int4*>(meta);
  const auto* tp = static_cast<const int32_t*>(trans);
  const auto* bp = static_cast<const int32_t*>(b2c);
  const auto* ap = static_cast<const int32_t*>(accept);
  auto* rp = static_cast<int32_t*>(recs);
  auto* np = static_cast<int32_t*>(total);
  auto* fp = static_cast<int32_t*>(finals);
  auto s = static_cast<cudaStream_t>(stream);
  return int(shared_tables
                 ? launch<true>(cp, n, mp, nch, tp, bp, ap, S, C, H, rp, cap,
                                np, fp, s)
                 : launch<false>(cp, n, mp, nch, tp, bp, ap, S, C, H, rp,
                                 cap, np, fp, s));
}

// Row mode: `data` [B, L] uint8, `lengths`/`states0`/`finals` [B] int32,
// `plane` [B, L] int32 (every entry written).
extern "C" int hs_dfa_scan_rows(const void* data, int B, int L,
                                const void* lengths, const void* states0,
                                const void* trans, const void* b2c,
                                const void* accept, int S, int C,
                                int shared_tables, void* plane, void* finals,
                                void* stream) {
  if (B <= 0 || L < 0 || C < 1 || C > 256) return int(cudaErrorInvalidValue);
  const auto* dp = static_cast<const uint8_t*>(data);
  const auto* lp = static_cast<const int32_t*>(lengths);
  const auto* sp = static_cast<const int32_t*>(states0);
  const auto* tp = static_cast<const int32_t*>(trans);
  const auto* bp = static_cast<const int32_t*>(b2c);
  const auto* ap = static_cast<const int32_t*>(accept);
  auto* pp = static_cast<int32_t*>(plane);
  auto* fp = static_cast<int32_t*>(finals);
  auto s = static_cast<cudaStream_t>(stream);
  // 16-byte loads and stores need every row 16-byte aligned
  const bool vec = L % 16 == 0 && reinterpret_cast<uintptr_t>(dp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pp) % 16 == 0;
  return int(shared_tables
                 ? launch_rows<true>(dp, B, L, vec, lp, sp, tp, bp, ap, S, C,
                                     pp, fp, s)
                 : launch_rows<false>(dp, B, L, vec, lp, sp, tp, bp, ap, S, C,
                                      pp, fp, s));
}

extern "C" const char* hs_dfa_scan_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
