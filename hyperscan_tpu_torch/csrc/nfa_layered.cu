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
// What bounds it. Per 32-byte word of the corpus, a position with k
// predecessors needs k integer operations (k - 1 ORs, then a funnel shift
// that takes the OR a byte on with its carry) and one three-input AND
// with its class word and the bytes that continue a block: E + P in all.
// Each byte needs one membership word for each 32 classes from shared
// memory. The two pipes run side by side. On an H100, at 64 integer
// results a clock an SM, the bench engine (.*a.{18}b: P 20, E 19) needs
// 0.02 ms of integer work a 256 MiB pass, under the 0.08 ms that reading
// the corpus takes; .*a.{500}b needs 0.50 ms, over it.
//
// Design. Bit-slicing along the corpus: one uint32 holds one position's
// activity over 32 consecutive bytes, so each bitwise operation advances
// 32 bytes. One thread owns one segment of the span and walks it word by
// word after a halo (max_depth rounded up to a word), the next word's 32
// bytes loaded while this one is swept. Per word:
// - Class words at a cost that does not grow with the classes within a
//   group: each byte is looked up once in a byte -> membership table (one
//   32-bit word per 32 classes, R copies in shared memory, lane l reading
//   copy l % R, so a warp's random bytes hit distinct banks). For K <= 4
//   the table holds class c at bit 8 c, so the 8 entries of bytes
//   8 h .. 8 h + 7 shifted by 0..7 and added give byte c of a word = class
//   c's bits of those bytes; four such words give every class word by byte
//   permutes. For K > 4, the membership bytes of each group of 8 classes
//   over 8 bytes are bit-transposed (8 x 8) into the group's class bits.
// - The sweep reads a program staged once a block in shared memory: one
//   16-byte record a position, a class word offset a position, and bit
//   masks of the positions' kinds. Four positions go at a time: their class
//   words are loaded together, and PLAIN positions (the only predecessor
//   the position before, at most an accept of the only accept set) cost a
//   funnel shift, an AND, a funnel shift and a shift each; a group of 32
//   PLAIN positions without an accept runs a loop with no test at all.
//   Other positions read their record: predecessors other than the one
//   before in slots the host allotted by liveness, entry flags, slot
//   writes, accept groups.
//   The one-byte shift needs bit 31 of the predecessors' OR a word before:
//   one carry bit a position, P / 32 words a thread, consumed and refilled
//   by funnel shifts. So a thread keeps K class words, the live slots and
//   P / 32 carry words, [slot][thread] in shared memory (a warp's accesses
//   fall in distinct banks), in place of two words a position.
// - A resident grid: as many blocks as fit, the span cut into as many
//   segments as the grid has threads (at least four halos each), so the
//   card runs one wave.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 32;
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 32;
constexpr size_t kSmemTarget = 100 * 1024;   // two blocks an SM at least
constexpr size_t kTableBudget = 32 * 1024;   // the membership table
constexpr int kMaxSets = 31;                 // accept sets a kind
constexpr int kClassMask = 0x3FF;
constexpr int kFloat = 1 << 10;
constexpr int kAnch = 1 << 11;
constexpr int kPrev = 1 << 12;
constexpr int kOut = 1 << 13;
constexpr int kAccShift = 14;
constexpr int kEodShift = 19;
constexpr int kPlain = 1 << 24;  // PREV alone: no slot, flag or accept

__device__ __forceinline__ uint32_t bit_range(int a, int b) {
  // bits [a, b) of a word, 0 <= a < b <= 32
  const uint32_t hi = b >= 32 ? 0xFFFFFFFFu : ((1u << b) - 1u);
  return hi & ~((1u << a) - 1u);
}

// 8 x 8 bit transpose: bit 8 i + c <-> bit 8 c + i.
__device__ __forceinline__ unsigned long long transpose8(unsigned long long x) {
  unsigned long long t;
  t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x = x ^ t ^ (t << 28);
  return x;
}

// The 32 bytes at w (a multiple of 32), zero at and past n.
__device__ __forceinline__ void load_word(const uint8_t* __restrict__ corpus,
                                          long long n, long long w,
                                          uint32_t x[8]) {
  if (w + kWord <= n) {
    const uint4 q0 = *reinterpret_cast<const uint4*>(corpus + w);
    const uint4 q1 = *reinterpret_cast<const uint4*>(corpus + w + 16);
    x[0] = q0.x; x[1] = q0.y; x[2] = q0.z; x[3] = q0.w;
    x[4] = q1.x; x[5] = q1.y; x[6] = q1.z; x[7] = q1.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 0u;
#pragma unroll
    for (int j = 0; j < kWord; ++j)  // unrolled: x stays in registers
      if (w + j < n) x[j >> 2] |= uint32_t(corpus[w + j]) << ((j & 3) * 8);
  }
}

// Pp: the positions padded to a multiple of 4 (the sweep takes four at a
// time; a padding position reads class 0 and feeds nothing), PW = Pp / 32
// rounded up.
struct Shape {
  int P, Pp, K, KW, R, L, PW, GA, GE, n_extra;
};

// Shared-memory words of a block of T threads.
__host__ __device__ inline size_t block_words(const Shape& s, int T) {
  const int per_thread = s.K + s.L + s.PW + (s.GA > 1 ? s.GA : 0) +
                         (s.GE > 1 ? s.GE : 0);
  return size_t(4) * s.P + s.Pp + 2 * s.PW + size_t(s.KW) * 256 * s.R +
         s.n_extra + 2 * kMaxSets + size_t(per_thread) * T;
}

// Membership word -> the spread form of classes 0-3: class c at bit 8 c.
__device__ __forceinline__ uint32_t spread4(uint32_t m) {
  return (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
}

// Byte b of each of four words -> the four bytes of one word.
__device__ __forceinline__ uint32_t gather4(uint32_t v0, uint32_t v1,
                                            uint32_t v2, uint32_t v3,
                                            uint32_t b) {
  const uint32_t sel = b | ((b + 4) << 4);
  return __byte_perm(__byte_perm(v0, v1, sel), __byte_perm(v2, v3, sel),
                     0x5410);
}

// OR of the group values of the groups whose words have bit j set; one
// group needs no words.
__device__ __forceinline__ int32_t group_bits(const uint32_t* w, int T,
                                              const int32_t* gval, int G,
                                              int j) {
  if (G == 1) return gval[0];
  int32_t v = 0;
  for (int q = 0; q < G; ++q)
    if ((w[q * T] >> j) & 1u) v |= gval[q];
  return v;
}

// kSmall: K <= 4, one membership word a byte in 32 copies, the class
// words by shifts (no transpose).
template <bool kSmall>
__global__ void __launch_bounds__(kMaxThreads, 3)
nfa_layered_kernel(const uint8_t* __restrict__ corpus, long long n,
                   const int4* __restrict__ prog,
                   const int32_t* __restrict__ extra,
                   const int32_t* __restrict__ gvals,
                   const uint32_t* __restrict__ mem, Shape sh,
                   const long long* __restrict__ bstart,
                   const long long* __restrict__ bend,
                   const uint8_t* __restrict__ banch, int nb,
                   long long span_lo, long long span_len, int halo,
                   long long seg, int32_t* __restrict__ recs, int cap,
                   int32_t* __restrict__ total,
                   int32_t* __restrict__ eod_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int P = sh.P, K = sh.K, R = kSmall ? 32 : sh.R;
  int4* s_prog = reinterpret_cast<int4*>(smem);                 // [P]
  uint32_t* s_step = smem + 4 * P;                              // [Pp]
  uint32_t* s_plain = s_step + sh.Pp;                           // [PW]
  uint32_t* s_accm = s_plain + sh.PW;                           // [PW]
  uint32_t* s_tab = s_accm + sh.PW;                             // [KW][256][R]
  int32_t* s_extra = reinterpret_cast<int32_t*>(s_tab + sh.KW * 256 * R);
  int32_t* s_gval = s_extra + sh.n_extra;                       // [2][31]
  uint32_t* mine = reinterpret_cast<uint32_t*>(s_gval + 2 * kMaxSets) + tid;
  uint32_t* cls = mine;                                         // [K][T]
  uint32_t* slot = cls + K * T;                                 // [L][T]
  uint32_t* carry = slot + sh.L * T;                            // [PW][T]
  uint32_t* accw = carry + sh.PW * T;                           // [GA][T]
  uint32_t* eodw = accw + (sh.GA > 1 ? sh.GA : 0) * T;          // [GE][T]
  for (int i = tid; i < P; i += T) s_prog[i] = prog[i];
  // each position's class word offset, and bit masks of its kind: PLAIN
  // (padding too) and PLAIN with an accept
  for (int i = tid; i < sh.Pp; i += T)
    s_step[i] = i < P ? uint32_t((prog[i].x & kClassMask) * T) : 0u;
  for (int i = tid; i < sh.PW; i += T) {
    uint32_t pw = 0u, aw = 0u;
    for (int j = 0; j < 32 && 32 * i + j < sh.Pp; ++j) {
      const int r = 32 * i + j;
      const int x = r < P ? prog[r].x : kPlain;
      const bool acc = (x >> kAccShift) & 31;
      if (x & kPlain) {
        pw |= 1u << j;
        if (acc) aw |= 1u << j;
      }
    }
    s_plain[i] = pw;
    s_accm[i] = aw;
  }
  // kSmall: the table in spread form (class c of byte b at bit 8 c)
  for (int i = tid; i < sh.KW * 256 * R; i += T)
    s_tab[i] = kSmall ? spread4(mem[i / R]) : mem[i / R];
  for (int i = tid; i < sh.n_extra; i += T) s_extra[i] = extra[i];
  for (int i = tid; i < 2 * kMaxSets; i += T) s_gval[i] = gvals[i];
  __syncthreads();
  const uint32_t* my_tab = s_tab + ((tid & 31) & (R - 1));
  const int KB = (K + 7) / 8;  // groups of 8 classes

  const long long span_hi = span_lo + span_len;
  const long long n_segs = (span_len + seg - 1) / seg;
  for (long long gseg = (long long)blockIdx.x * T + tid; gseg < n_segs;
       gseg += (long long)gridDim.x * T) {
    const long long lo = span_lo + gseg * seg;
    const long long hi = lo + seg < span_hi ? lo + seg : span_hi;
    long long w0 = lo - halo;
    if (w0 < span_lo) w0 = span_lo;
    for (int i = 0; i < sh.PW; ++i) carry[i * T] = 0u;
    // the first block still open at w0, cached in registers
    int k;
    {
      int a = 0, b = nb;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (bend[mid] <= w0) a = mid + 1; else b = mid;
      }
      k = a;
    }
    long long kb = 0, ke = 0;
    bool ka = false;
    if (k < nb) { kb = bstart[k]; ke = bend[k]; ka = banch[k] != 0; }
    uint32_t nx[8];  // the next word's bytes, loaded a word ahead
    load_word(corpus, n, w0, nx);
    for (long long wlo = w0; wlo < hi && k < nb; wlo += kWord) {
      const long long whi = wlo + kWord;
      uint32_t x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = nx[i];
      if (whi < hi) load_word(corpus, n, whi, nx);
      if (kb >= whi) {  // no block byte in this word: every word is 0
        for (int i = 0; i < sh.PW; ++i) carry[i * T] = 0u;
        continue;
      }
      // validity, block starts and anchors of this word's bytes
      uint32_t valid, startb = 0u, anchb = 0u;
      if (kb <= wlo && whi <= ke) {
        valid = 0xFFFFFFFFu;
        if (kb == wlo) { startb = 1u; anchb = ka ? 1u : 0u; }
      } else {
        valid = 0u;
        for (int kk = k; kk < nb && bstart[kk] < whi; ++kk) {
          const long long s0 = bstart[kk], e0 = bend[kk];
          const long long a = s0 > wlo ? s0 : wlo;
          const long long b = e0 < whi ? e0 : whi;
          if (a < b) valid |= bit_range(int(a - wlo), int(b - wlo));
          if (s0 >= wlo) {
            const uint32_t bit = 1u << int(s0 - wlo);
            startb |= bit;
            if (banch[kk]) anchb |= bit;
          }
        }
      }
      // class words: bit j of class c = byte j in class c
      if (kSmall) {
        // m << i for the 8 bytes 8 h + i puts class c of byte 8 h + i at
        // bit 8 c + i of M[h]
        uint32_t M[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t acc = 0u;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int j = 8 * h + i;
            const uint32_t b =
                __byte_perm(x[j >> 2], 0u, 0x4440u | uint32_t(j & 3));
            // R = 32: byte b's copies are 128 bytes apart
            acc += *reinterpret_cast<const uint32_t*>(
                       reinterpret_cast<const char*>(my_tab) + (b << 7))
                   << i;
          }
          M[h] = acc;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < K) cls[c * T] = gather4(M[0], M[1], M[2], M[3], c);
      } else {
        // a group of 8 classes at a time: the group's membership bytes of
        // 8 bytes, transposed, give the 8 classes' bits of those bytes
        for (int gi = 0; gi < KB; ++gi) {
          const uint32_t* tab = my_tab + (gi >> 2) * 256 * R;
          const uint32_t sb = uint32_t(gi & 3);  // the group's byte
          uint32_t lo8[4], hi8[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            uint32_t m[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int j = 8 * h + i;
              m[i] = tab[((x[j >> 2] >> ((j & 3) * 8)) & 0xFFu) * R];
            }
            const uint32_t lo4 = gather4(m[0], m[1], m[2], m[3], sb);
            const uint32_t hi4 = gather4(m[4], m[5], m[6], m[7], sb);
            const unsigned long long u =
                transpose8((unsigned long long)hi4 << 32 | lo4);
            lo8[h] = uint32_t(u);        // classes 0-3 of the group
            hi8[h] = uint32_t(u >> 32);  // classes 4-7
          }
          const int c0 = 8 * gi;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c0 + c < K)
              cls[(c0 + c) * T] = gather4(lo8[0], lo8[1], lo8[2], lo8[3], c);
            if (c0 + 4 + c < K)
              cls[(c0 + 4 + c) * T] =
                  gather4(hi8[0], hi8[1], hi8[2], hi8[3], c);
          }
        }
      }
      // the sweep, in topological order, four positions at a time: their
      // class words are loaded together, and four PLAIN positions (the
      // only predecessor the position before; at most an accept of the
      // only accept set) take the short path. The one-byte shift takes
      // the carry (bit 31 of the same predecessor OR a word before) from
      // bit 31 of cin by a funnel shift; cin gives up a bit a position
      // and cout takes one, so position 32 g + i sits at bit 31 - i of
      // carry word g.
      const uint32_t cont = valid & ~startb;
      uint32_t acc_any = 0u, eod_any = 0u, prev_a = 0u;
      if (sh.GA > 1)
        for (int q = 0; q < sh.GA; ++q) accw[q * T] = 0u;
      if (sh.GE > 1)
        for (int q = 0; q < sh.GE; ++q) eodw[q * T] = 0u;
      for (int g = 0; g < sh.PW; ++g) {
        uint32_t cin = carry[g * T];
        uint32_t cout = 0u;
        const uint32_t plain = s_plain[g], accm = s_accm[g];
        const int r1 = 32 * g + 32 < sh.Pp ? 32 * g + 32 : sh.Pp;
        const uint32_t all = r1 - 32 * g == 32 ? 0xFFFFFFFFu
                                               : (1u << (r1 - 32 * g)) - 1u;
        if (plain == all && !accm) {  // a group of PLAIN positions alone
          for (int r = 32 * g; r < r1; r += 4) {
            const uint4 st = *reinterpret_cast<const uint4*>(s_step + r);
            const uint32_t cw[4] = {cls[st.x], cls[st.y], cls[st.z],
                                    cls[st.w]};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint32_t a =
                  __funnelshift_l(cin, prev_a, 1) & cont & cw[i];
              cout = __funnelshift_l(prev_a, cout, 1);
              cin <<= 1;
              prev_a = a;
            }
          }
          carry[g * T] = cout << (32 - (r1 - 32 * g));
          continue;
        }
        for (int r = 32 * g; r < r1; r += 4) {
          const uint4 st = *reinterpret_cast<const uint4*>(s_step + r);
          const uint32_t cw[4] = {cls[st.x], cls[st.y], cls[st.z],
                                  cls[st.w]};
          const uint32_t pl = (plain >> (r & 31)) & 0xFu;
          const uint32_t am = (accm >> (r & 31)) & 0xFu;
          if (pl == 0xFu) {  // the common case: a run of a chain
            uint32_t a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[i] = __funnelshift_l(cin, prev_a, 1) & cont & cw[i];
              cout = __funnelshift_l(prev_a, cout, 1);
              cin <<= 1;
              prev_a = a[i];
            }
            if (am)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if ((am >> i) & 1u) acc_any |= a[i];
            continue;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t a;
            if ((pl >> i) & 1u) {
              a = __funnelshift_l(cin, prev_a, 1) & cont & cw[i];
              cout = __funnelshift_l(prev_a, cout, 1);
              if ((am >> i) & 1u) acc_any |= a;
            } else {
              const int4 op = s_prog[r + i];
              uint32_t p = (op.x & kPrev) ? prev_a : 0u;
              const int ns = int(uint32_t(op.y) >> 16);
              if (ns > 0) p |= slot[(op.z & 0xFFFF) * T];
              if (ns > 1) p |= slot[(int(uint32_t(op.z) >> 16)) * T];
              for (int e = 2; e < ns; ++e)
                p |= slot[s_extra[op.w + e - 2] * T];
              uint32_t in = __funnelshift_l(cin, p, 1) & cont;
              cout = __funnelshift_l(p, cout, 1);
              if (op.x & kFloat) in |= valid;
              if (op.x & kAnch) in |= anchb;
              a = in & cw[i] & valid;
              if (op.x & kOut) slot[(op.y & 0xFFFF) * T] = a;
              const int qa = (op.x >> kAccShift) & 31;
              if (qa) {
                acc_any |= a;
                if (sh.GA > 1) accw[(qa - 1) * T] |= a;
              }
              const int qe = (op.x >> kEodShift) & 31;
              if (qe) {
                eod_any |= a;
                if (sh.GE > 1) eodw[(qe - 1) * T] |= a;
              }
            }
            cin <<= 1;
            prev_a = a;
          }
        }
        carry[g * T] = cout << (32 - (r1 - 32 * g));
      }
      const bool body = wlo >= lo;  // halo words give no output
      if (body && acc_any) {
        int r = atomicAdd(total, __popc(acc_any));
        for (uint32_t mm = acc_any; mm; mm &= mm - 1u, ++r) {
          const int j = __ffs(mm) - 1;
          if (r < cap) {
            recs[2 * r] = int32_t(wlo + j);
            recs[2 * r + 1] = group_bits(accw, T, s_gval, sh.GA, j);
          }
        }
      }
      // the blocks that end in this word
      while (k < nb && ke <= whi) {
        if (body) {
          const int j = int(ke - 1 - wlo);  // the block's last byte
          eod_out[k] = ((eod_any >> j) & 1u)
                           ? group_bits(eodw, T, s_gval + kMaxSets, sh.GE, j)
                           : 0;
        }
        ++k;
        if (k < nb) { kb = bstart[k]; ke = bend[k]; ka = banch[k] != 0; }
      }
    }
  }
}

}  // namespace

// seg_min: the least body bytes a thread (a multiple of 32); the launch
// raises it until the span fits one resident wave.
extern "C" int hs_nfa_layered(const void* corpus, long long n,
                              const void* prog, const void* extra,
                              const void* gvals, const void* mem, int P,
                              int K, int L, int GA, int GE, int n_extra,
                              const void* bstart, const void* bend,
                              const void* banch, int nb, long long span_lo,
                              long long span_len, int halo, int seg_min,
                              void* recs, int cap, void* total,
                              void* eod_out, void* stream) {
  if (nb <= 0 || span_len <= 0) return int(cudaSuccess);
  if (P <= 0 || K <= 0 || L < 0 || GA < 0 || GE < 0 || GA > kMaxSets ||
      GE > kMaxSets || n_extra < 1 || seg_min <= 0 || seg_min % kWord ||
      halo % kWord || span_lo % kWord)
    return int(cudaErrorInvalidValue);
  const int Pp = (P + 3) / 4 * 4;
  Shape sh{P, Pp, K, (K + 31) / 32, 32, L, (Pp + 31) / 32, GA, GE, n_extra};
  while (sh.R > 1 && size_t(sh.KW) * 256 * sh.R * 4 > kTableBudget)
    sh.R >>= 1;
  // the widest block that fits the target, at least 32 threads
  int T = kMaxThreads;
  while (T > kMinThreads && block_words(sh, T) * 4 > kSmemTarget) T >>= 1;
  const size_t smem = block_words(sh, T) * 4;
  const bool small = K <= 4;  // then KW = 1 and R = 32
  void (*kernel)(const uint8_t*, long long, const int4*, const int32_t*,
                 const int32_t*, const uint32_t*, Shape, const long long*,
                 const long long*, const uint8_t*, int, long long, long long,
                 int, long long, int32_t*, int, int32_t*, int32_t*) =
      small ? nfa_layered_kernel<true> : nfa_layered_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T,
                                                      smem);
  if (e != cudaSuccess) return int(e);
  if (per_sm < 1) return int(cudaErrorInvalidConfiguration);
  const long long resident = (long long)per_sm * sms;
  // one segment a resident thread, whole words, at least seg_min
  long long seg = (span_len + resident * T - 1) / (resident * T);
  seg = (seg + kWord - 1) / kWord * kWord;
  if (seg < seg_min) seg = seg_min;
  const long long n_segs = (span_len + seg - 1) / seg;
  long long blocks = (n_segs + T - 1) / T;
  if (blocks > resident) blocks = resident;
  kernel<<<unsigned(blocks), T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(corpus), n,
      static_cast<const int4*>(prog), static_cast<const int32_t*>(extra),
      static_cast<const int32_t*>(gvals), static_cast<const uint32_t*>(mem),
      sh, static_cast<const long long*>(bstart),
      static_cast<const long long*>(bend),
      static_cast<const uint8_t*>(banch), nb, span_lo, span_len, halo, seg,
      static_cast<int32_t*>(recs), cap, static_cast<int32_t*>(total),
      static_cast<int32_t*>(eod_out));
  return int(cudaGetLastError());
}

extern "C" const char* hs_nfa_layered_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
