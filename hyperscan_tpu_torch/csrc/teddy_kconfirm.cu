// Teddy filter with the hash confirm inside the kernel (sm_90a): the
// kconfirm family, and the stage modes that time it in parts.
//
// Replaces the Pallas TPU kernels _make_kernel_fused_classes /
// _make_kernel_fused run with _confirm_epilogue (hyperscan_tpu/ops/
// teddy.py:572, :682, :258), launched by the pallas_call at :1081, and the
// reference's stage-bisect probes that re-wrap it
// (tools_probe_kconf_split.py:128, :164, tools_probe_rank_bisect.py:163).
//
// What it computes. The filter of teddy_filter_compact.cu; then, for every
// candidate p of a 64 KiB cell, its 8 tail bytes (p-7 .. p, zero before
// offset 0) as lo = bytes p-7..p-4 and hi = bytes p-3..p (newest on top),
// and for every confirm group g = (cl, mlo, mhi, t_rows, base) with
// p >= cl - 1:
//   h = avalanche((lo & mlo) * 0x9E3779B1 ^ (hi & mhi) * 0x85EBCA6B)
// (runtime/lit_runtime.py _avalanche32), bucket row base/128 + (h & (t_rows
// - 1)), signature h >> 16. Every occupied slot of that row whose 16-bit
// signature equals it is a hash match, emitted as (class id + 1, p). These
// are the bucket-row tables of dev_confirm_planes (:1506), one uint16
// signature and one class per slot and a fill count per row, so the
// hash-matched set equals the reference kconfirm's. Per cell: the exact
// candidate count, the exact match count, and the first CAPC2 = 128 matches
// in (p, slot) order.
//
// Where it departs from the TPU kernel. The TPU epilogue confirms at most
// `capc` candidates a cell and keeps at most two matches per row probe, so
// the reference needs an XLA sidecar (kconf_combine, :1206) for cells past
// capc and demotes the family on a third match. Here every candidate of the
// cell is confirmed as it is found, with every match of the row, so there is
// no capc, no sidecar and no per-row limit; a cell with more than CAPC2
// matches still demotes the family (the caller's rule), since its buffer
// keeps only the first CAPC2.
//
// Stages. `stage` cuts the kernel after each part of the confirm, for
// timing each part on its own (the counterpart of the reference's probes and
// of teddy.py's _KCONF_STAGE). Stages 0-2 write three counts a cell,
// (candidates, checksum, matches), and no pairs:
//   0: the filter and the exact candidate count (checksum, matches 0);
//   1: + each candidate's 8 tail bytes and every group's avalanche hash h,
//      folded into the checksum sum(h) mod 2^32 over the candidates and the
//      groups they reach (p >= cl - 1), so the work cannot be dropped;
//   2: + the bucket-row reads and signature compares: the exact match count
//      (the checksum as at stage 1);
//   3: the full kernel (the pairs; its outputs are described above).
// The stage is a kernel argument, so the stage modes run the scan path's
// own code (one library, one set of instances); only the stage probe and
// the tests pass a stage below 3.
//
// What bounds it. The filter: 1 + M*W shared-memory words a byte (see
// teddy_filter_compact.cu). The confirm adds per candidate and group one
// 256-byte row read (L2: the tables are up to a few MiB, read from global
// memory) and a few dozen integer operations, which at the main path's
// ~22 candidates a cell is small beside the filter.
//
// Design.
// - The filter loop of teddy_filter.cuh: the [M][K][Wp] tables replicated in
//   shared memory, one conflict-free vector load per (m, key), on a resident
//   grid (two blocks an SM) whose blocks stage the tables once.
// - The confirm spreads (candidate, group) work over the lanes: the warp
//   takes its candidates one by one (a ballot over the lanes with
//   candidates; the candidate's two tail words by shuffle from the lane that
//   holds its window), and lane l takes group l / 4 (8 groups a round) and a
//   quarter of that group's bucket row, slots 32 (l % 4) .. +31: one hash,
//   four 16-byte loads and 16 packed 16-bit compares a lane. The 10k bench
//   ruleset's rows hold 0-75 slots (PERF.md), so the four lanes of a group
//   share a row's compares; a candidate is one round for up to 8 groups
//   where the whole warp once took one round a group. Lane order is
//   (group, slot) order, so a ballot over the lanes walks a candidate's
//   matches in slot order.
// - Matches go to a per-warp buffer of CAPC2 pairs in shared memory in the
//   warp's (step, position, slot) order, with a per-(step, warp) count; a
//   warp's k-th match has cell rank >= k, so CAPC2 slots a warp suffice.
//   Candidate counts stay in registers. Once a cell, one warp scans the 16 x
//   8 counts in (step, warp) order and each warp copies its buffer to the
//   cell's pairs at those offsets: two barriers a cell where a block scan a
//   step took four, and the output does not depend on warp timing.
// None of the TPU's one-hot matmuls, bf16 signature halves or
// identity-matmul transposes are needed.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

constexpr int kCapc2 = 128;
constexpr int kMaxGroups = 64;
constexpr int kParts = 4;                       // lanes a bucket row
constexpr int kPartSlots = 128 / kParts;        // slots a lane compares
constexpr int kGroupsPerRound = 32 / kParts;    // groups a candidate round
static_assert(kPartSlots == 32, "one match bit a slot in a 32-bit mask");

struct Args {
  const uint8_t* corpus;
  long long n;
  const uint8_t* b2c;
  const uint32_t* tabs;  // [M][K][Wp]
  int H, R;              // vectors a key, copies a vector (teddy_filter.cuh)
  const int32_t* gmeta;  // [G][5]: cl, mlo, mhi, t_rows, base
  int G;
  const uint16_t* sigs;
  const uint8_t* fills;
  const int32_t* slot_cls;
  int stage;
  int n_cells;
  int32_t* cand_counts;
  int32_t* conf_counts;
  int32_t* out_pos;     // stage 3
  int32_t* out_cls;     // stage 3
  uint32_t* checksums;  // stages 0-2
};

// 8 bytes at window byte 1 + j .. 8 + j (= bytes p-7 .. p for p = p0 + j)
__device__ __forceinline__ uint64_t tail8(const uint32_t w[6], int j) {
  const uint64_t a = uint64_t(w[1]) << 32 | w[0];
  const uint64_t b = uint64_t(w[3]) << 32 | w[2];
  const uint64_t c = uint64_t(w[5]) << 32 | w[4];
  const int s = 1 + j;  // 1 .. 16
  if (s < 8) return (a >> (8 * s)) | (b << (64 - 8 * s));
  if (s == 8) return b;
  if (s < 16) return (b >> (8 * (s - 8))) | (c << (64 - 8 * (s - 8)));
  return c;
}

// Bit k set <=> slot k of the 32 at `q` holds signature `sig`.
__device__ __forceinline__ uint32_t sig_matches(const uint16_t* q,
                                                uint32_t sig) {
  const uint32_t sig2 = sig * 0x10001u;
  const uint4* v = reinterpret_cast<const uint4*>(q);
  uint4 s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = __ldg(v + i);
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w[4] = {s[i].x, s[i].y, s[i].z, s[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t eq = __vcmpeq2(w[k], sig2);  // 0xFFFF per equal half
      m |= ((eq & 1u) | ((eq >> 15) & 2u)) << (8 * i + 2 * k);
    }
  }
  return m;
}

template <int M, bool kClasses, int V>
__global__ void __launch_bounds__(kThreads, 2) kconfirm_kernel(const Args a) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][H][kTab][R][V]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_gm[kMaxGroups * 5];
  __shared__ int32_t s_bpos[kWarps][kCapc2];
  __shared__ int32_t s_bcls[kWarps][kCapc2];
  __shared__ int s_cnt[kSteps * kWarps];  // matches of (step, warp)
  __shared__ int s_pre[kSteps * kWarps];  // their exclusive prefix
  __shared__ int s_cand[kWarps];
  __shared__ uint32_t s_chk[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int part = lane % kParts;  // this lane's quarter of a bucket row
  const int gsub = lane / kParts;  // this lane's group within a round
  stage_tables<V>(s_tab, a.tabs, M, kTab, a.H, a.R);
  if (kClasses) s_b2c[tid] = a.b2c[tid];  // kThreads == 256
  for (int i = tid; i < a.G * 5; i += kThreads) s_gm[i] = a.gmeta[i];
  __syncthreads();

  for (int cell = blockIdx.x; cell < a.n_cells; cell += gridDim.x) {
    const long long cell0 = (long long)cell * kCell;
    int n_cand = 0;    // this thread's candidates in the cell
    int wbuf = 0;      // this warp's matches in the cell so far
    uint32_t chk = 0;  // stages 1-2: this lane's sum of h
    for (int step = 0; step < kSteps; ++step) {
      const long long base = cell0 + (long long)step * kStep;
      int wcnt = 0;  // this warp's matches this step (uniform in the warp)
      if (base < a.n) {  // uniform across the block
        const long long p0 = base + tid * kChunk;
        uint32_t win[6];
        load_window(a.corpus, a.n, p0, lane == 0, win);
        const uint32_t bits =
            cand_bits<M, kClasses, V>(win, s_b2c, s_tab, a.H, a.R, p0, a.n);
        n_cand += __popc(bits);
        const long long wp0 = base + (long long)warp * 32 * kChunk;
        unsigned pend = a.stage >= 1 ? __ballot_sync(kFull, bits != 0u) : 0u;
        while (pend) {
          const int src = __ffs(pend) - 1;
          pend &= pend - 1;
          uint32_t sb = __shfl_sync(kFull, bits, src);
          while (sb) {
            const int j = __ffs(sb) - 1;
            sb &= sb - 1;
            const uint64_t v = tail8(win, j);
            const uint32_t lo = __shfl_sync(kFull, uint32_t(v), src);
            const uint32_t hi = __shfl_sync(kFull, uint32_t(v >> 32), src);
            const long long p = wp0 + src * kChunk + j;
            for (int g0 = 0; g0 < a.G; g0 += kGroupsPerRound) {
              const int g = g0 + gsub;
              const int* gm = s_gm + 5 * g;  // cl, mlo, mhi, t_rows, base
              const bool act = g < a.G && p >= gm[0] - 1;
              uint32_t h = 0;
              if (act) {
                h = ((lo & uint32_t(gm[1])) * 0x9E3779B1u) ^
                    ((hi & uint32_t(gm[2])) * 0x85EBCA6Bu);
                h ^= h >> 15;
                h *= 0x2C1B3C6Du;
                h ^= h >> 13;
              }
              if (a.stage <= 2 && part == 0) chk += h;
              if (a.stage == 1) continue;
              uint32_t m = 0;
              int row = 0;
              if (act) {
                row = (gm[4] >> 7) + int(h & uint32_t(gm[3] - 1));
                const int lim = int(__ldg(a.fills + row)) - part * kPartSlots;
                m = sig_matches(
                    a.sigs + (long long)row * 128 + part * kPartSlots,
                    h >> 16);
                m &= lim >= 32 ? kFull : lim <= 0 ? 0u : (1u << lim) - 1u;
              }
              if (a.stage == 2) {
                wcnt += int(__reduce_add_sync(kFull, __popc(m)));
                continue;
              }
              unsigned bal = __ballot_sync(kFull, m != 0u);
              while (bal) {
                const int l = __ffs(bal) - 1;
                bal &= bal - 1;
                uint32_t mm = __shfl_sync(kFull, m, l);
                const int rl = __shfl_sync(kFull, row, l);
                while (mm) {
                  const int e = __ffs(mm) - 1;
                  mm &= mm - 1;
                  const int k = wbuf + wcnt;
                  if (lane == 0 && k < kCapc2) {
                    s_bpos[warp][k] = int32_t(p);
                    s_bcls[warp][k] = __ldg(a.slot_cls + (long long)rl * 128 +
                                            (l % kParts) * kPartSlots + e);
                  }
                  ++wcnt;
                }
              }
            }
          }
        }
      }
      if (lane == 0) s_cnt[step * kWarps + warp] = wcnt;
      wbuf += wcnt;
    }
    // once a cell: the counts, the checksum, and the pairs in cell order
    n_cand = int(__reduce_add_sync(kFull, unsigned(n_cand)));
    chk = __reduce_add_sync(kFull, chk);
    if (lane == 0) {
      s_cand[warp] = n_cand;
      s_chk[warp] = chk;
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive prefix of the kSteps x kWarps counts, 4 a lane
      static_assert(kSteps * kWarps == 4 * 32, "four counts a lane");
      int c[4], sum = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        c[k] = s_cnt[4 * lane + k];
        sum += c[k];
      }
      int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      int run = incl - sum;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s_pre[4 * lane + k] = run;
        run += c[k];
      }
      const int total = __shfl_sync(kFull, incl, 31);
      if (lane == 0) {
        int cand = 0;
        uint32_t ck = 0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
          cand += s_cand[k];
          ck += s_chk[k];
        }
        a.cand_counts[cell] = cand;
        a.conf_counts[cell] = total;
        if (a.stage <= 2) a.checksums[cell] = ck;
      }
    }
    __syncthreads();
    if (a.stage == 3) {
      int32_t* cell_pos = a.out_pos + (long long)cell * kCapc2;
      int32_t* cell_cls = a.out_cls + (long long)cell * kCapc2;
      int own = 0;  // this warp's buffered matches before the step
      for (int step = 0; step < kSteps && own < kCapc2; ++step) {
        const int cnt = s_cnt[step * kWarps + warp];
        const int dst = s_pre[step * kWarps + warp];
        if (dst >= kCapc2) break;  // later steps rank later still
        for (int i = lane; i < cnt; i += 32) {
          const int k = own + i;
          const int r = dst + i;
          if (k < kCapc2 && r < kCapc2) {
            cell_pos[r] = s_bpos[warp][k];
            cell_cls[r] = s_bcls[warp][k];
          }
        }
        own += cnt;
      }
    }
    __syncwarp();  // the warp's buffer is refilled by the next cell
  }
}

template <int M, bool kClasses, int V>
cudaError_t launch(Args a, int Wp, cudaStream_t stream) {
  constexpr int kTab = kClasses ? 128 : 256;
  a.H = Wp / V;
  a.R = table_copies(M, kTab, Wp, V);
  const size_t smem = table_bytes(M, kTab, Wp, a.R);
  auto kernel = kconfirm_kernel<M, kClasses, V>;
  cudaError_t e;
  const int grid = resident_grid(kernel, smem, a.n_cells, e);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_m(const Args& a, int Wp, bool classes,
                     cudaStream_t stream) {
  const int V = vector_width(Wp);
  if (V == 1)
    return classes ? launch<M, true, 1>(a, Wp, stream)
                   : launch<M, false, 1>(a, Wp, stream);
  return classes ? launch<M, true, 4>(a, Wp, stream)
                 : launch<M, false, 4>(a, Wp, stream);
}

}  // namespace

// `tabs`: the filter tables as [M][K][Wp] words (K = 128 with class tables,
// 256 with byte tables; Wp = 1, 2, 4 or 8, the padded width of the W
// words). Stage 3 writes `out_pos`/`out_cls` and takes no `checksums`;
// stages 0-2 write `checksums` and take no pair buffers.
extern "C" int hs_teddy_kconfirm(const void* corpus, long long n,
                                 const void* b2c, const void* tabs, int M,
                                 int Wp, int classes, const void* gmeta, int G,
                                 const void* sigs, const void* fills,
                                 const void* slot_cls, int stage,
                                 void* cand_counts, void* conf_counts,
                                 void* out_pos, void* out_cls,
                                 void* checksums, int n_cells, void* stream) {
  if (G < 0 || G > kMaxGroups || stage < 0 || stage > 3 ||
      vector_width(Wp) == 0 || n_cells < 1)
    return int(cudaErrorInvalidValue);
  if (stage == 3 ? (out_pos == nullptr || out_cls == nullptr)
                 : checksums == nullptr)
    return int(cudaErrorInvalidValue);
  Args a;
  a.corpus = static_cast<const uint8_t*>(corpus);
  a.n = n;
  a.b2c = static_cast<const uint8_t*>(b2c);
  a.tabs = static_cast<const uint32_t*>(tabs);
  a.H = a.R = 1;
  a.gmeta = static_cast<const int32_t*>(gmeta);
  a.G = G;
  a.sigs = static_cast<const uint16_t*>(sigs);
  a.fills = static_cast<const uint8_t*>(fills);
  a.slot_cls = static_cast<const int32_t*>(slot_cls);
  a.stage = stage;
  a.n_cells = n_cells;
  a.cand_counts = static_cast<int32_t*>(cand_counts);
  a.conf_counts = static_cast<int32_t*>(conf_counts);
  a.out_pos = static_cast<int32_t*>(out_pos);
  a.out_cls = static_cast<int32_t*>(out_cls);
  a.checksums = static_cast<uint32_t*>(checksums);
  auto s = static_cast<cudaStream_t>(stream);
  const bool c = classes != 0;
  switch (M) {
    case 1: return int(launch_m<1>(a, Wp, c, s));
    case 2: return int(launch_m<2>(a, Wp, c, s));
    case 3: return int(launch_m<3>(a, Wp, c, s));
    case 4: return int(launch_m<4>(a, Wp, c, s));
    case 5: return int(launch_m<5>(a, Wp, c, s));
    case 6: return int(launch_m<6>(a, Wp, c, s));
    case 7: return int(launch_m<7>(a, Wp, c, s));
    case 8: return int(launch_m<8>(a, Wp, c, s));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* hs_teddy_kconfirm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
