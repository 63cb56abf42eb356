// Teddy filter with the hash confirm inside the kernel (sm_90a): the
// kconfirm family.
//
// Replaces the Pallas TPU kernels _make_kernel_fused_classes /
// _make_kernel_fused run with _confirm_epilogue (hyperscan_tpu/ops/
// teddy.py:572, :682, :258), launched by the pallas_call at :1081.
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
// What bounds it. The filter: 1 + M*W shared-memory lookups a byte (see
// teddy_filter_compact.cu). The confirm adds per candidate and group one
// 256-byte row read (L2: the tables are up to a few MiB, read from global
// memory) and a few dozen integer operations, which at the main path's
// ~22 candidates a cell is small beside the filter.
//
// Design. Kernel A's loop (teddy_filter.cuh). The tail bytes of a candidate
// already sit in its thread's window registers, so nothing is gathered. The
// confirm is warp-cooperative: the warp takes its candidates one by one (a
// ballot over the lanes with candidates, their window words by shuffle),
// every lane hashes, and lane l compares the row's slots 4l .. 4l+3 (one
// 8-byte load a lane, one coalesced 256-byte read a warp); a ballot gives
// the matching lanes. Matches go to a per-warp buffer of CAPC2 pairs in
// shared memory in a fixed order; after each step a block scan over the
// warps' counts places them in the cell's buffer, so the output does not
// depend on warp timing. None of the TPU's one-hot matmuls, bf16 signature
// halves or identity-matmul transposes are needed.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

constexpr int kCapc2 = 128;
constexpr int kMaxGroups = 64;

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

template <int M, bool kClasses>
__global__ void __launch_bounds__(kThreads)
kconfirm_kernel(const uint8_t* __restrict__ corpus, long long n,
                const uint8_t* __restrict__ b2c,
                const uint32_t* __restrict__ tabs, int W,
                const int32_t* __restrict__ gmeta, int G,
                const uint16_t* __restrict__ sigs,
                const uint8_t* __restrict__ fills,
                const int32_t* __restrict__ slot_cls,
                int32_t* __restrict__ cand_counts,
                int32_t* __restrict__ conf_counts,
                int32_t* __restrict__ out_pos,
                int32_t* __restrict__ out_cls) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ uint32_t s_tab[];  // [M][W][kTab]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_warp[kWarps];
  __shared__ int s_gm[kMaxGroups * 5];
  __shared__ int32_t s_bpos[kWarps][kCapc2];
  __shared__ int32_t s_bcls[kWarps][kCapc2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < M * W * kTab; i += kThreads) s_tab[i] = tabs[i];
  if (kClasses) s_b2c[tid] = b2c[tid];  // kThreads == 256
  for (int i = tid; i < G * 5; i += kThreads) s_gm[i] = gmeta[i];
  __syncthreads();

  const long long cell0 = (long long)blockIdx.x * kCell;
  int32_t* cell_pos = out_pos + (long long)blockIdx.x * kCapc2;
  int32_t* cell_cls = out_cls + (long long)blockIdx.x * kCapc2;
  int n_cand = 0;  // candidates of this cell before the current step
  int n_conf = 0;  // matches of this cell before the current step
  for (int step = 0; step < kCell / kStep; ++step) {
    const long long base = cell0 + (long long)step * kStep;
    if (base >= n) break;  // uniform across the block
    const long long p0 = base + tid * kChunk;
    uint32_t win[6];
    load_window(corpus, n, p0, lane == 0, win);
    const uint32_t bits =
        cand_bits<M, kClasses>(win, s_b2c, s_tab, W, p0, n);

    int wcnt = 0;  // this warp's matches this step (uniform in the warp)
    unsigned pend = __ballot_sync(kFull, bits != 0u);
    while (pend) {
      const int src = __ffs(pend) - 1;
      pend &= pend - 1;
      uint32_t sb = __shfl_sync(kFull, bits, src);
      uint32_t w[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) w[k] = __shfl_sync(kFull, win[k], src);
      const long long sp0 = base + (long long)(warp * 32 + src) * kChunk;
      while (sb) {
        const int j = __ffs(sb) - 1;
        sb &= sb - 1;
        const uint64_t v = tail8(w, j);
        const uint32_t lo = uint32_t(v);
        const uint32_t hi = uint32_t(v >> 32);
        const long long p = sp0 + j;
        for (int g = 0; g < G; ++g) {
          const int* gm = s_gm + 5 * g;  // cl, mlo, mhi, t_rows, base
          if (p < gm[0] - 1) continue;
          uint32_t h = ((lo & uint32_t(gm[1])) * 0x9E3779B1u) ^
                       ((hi & uint32_t(gm[2])) * 0x85EBCA6Bu);
          h ^= h >> 15;
          h *= 0x2C1B3C6Du;
          h ^= h >> 13;
          const long long row =
              (long long)(gm[4] >> 7) + (h & uint32_t(gm[3] - 1));
          const uint32_t sig = h >> 16;
          const int fill = __ldg(fills + row);
          const uint2 q = __ldg(
              reinterpret_cast<const uint2*>(sigs + row * 128) + lane);
          const uint32_t s4[4] = {q.x & 0xFFFFu, q.x >> 16, q.y & 0xFFFFu,
                                  q.y >> 16};
          uint32_t m = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * lane + e < fill && s4[e] == sig) m |= 1u << e;
          unsigned bal = __ballot_sync(kFull, m != 0u);
          while (bal) {
            const int l = __ffs(bal) - 1;
            bal &= bal - 1;
            uint32_t mm = __shfl_sync(kFull, m, l);
            while (mm) {
              const int e = __ffs(mm) - 1;
              mm &= mm - 1;
              if (lane == 0 && wcnt < kCapc2) {
                s_bpos[warp][wcnt] = int32_t(p);
                s_bcls[warp][wcnt] = __ldg(slot_cls + row * 128 + 4 * l + e);
              }
              ++wcnt;
            }
          }
        }
      }
    }
    // place the warps' matches in the cell's buffer, in warp order
    int conf_total;
    const int wbase =
        n_conf + block_scan(lane == 0 ? wcnt : 0, s_warp, conf_total);
    const int wbase0 = __shfl_sync(kFull, wbase, 0);
    for (int i = lane; i < min(wcnt, kCapc2); i += 32) {
      const int r = wbase0 + i;
      if (r < kCapc2) {
        cell_pos[r] = s_bpos[warp][i];
        cell_cls[r] = s_bcls[warp][i];
      }
    }
    n_conf += conf_total;
    int cand_total;
    block_scan(__popc(bits), s_warp, cand_total);  // also fences s_bpos
    n_cand += cand_total;
  }
  if (tid == 0) {
    cand_counts[blockIdx.x] = n_cand;
    conf_counts[blockIdx.x] = n_conf;
  }
}

template <int M, bool kClasses>
cudaError_t launch(const uint8_t* corpus, long long n, const uint8_t* b2c,
                   const uint32_t* tabs, int W, const int32_t* gmeta, int G,
                   const uint16_t* sigs, const uint8_t* fills,
                   const int32_t* slot_cls, int32_t* cand_counts,
                   int32_t* conf_counts, int32_t* out_pos, int32_t* out_cls,
                   int n_cells, cudaStream_t stream) {
  const size_t smem = table_bytes(M, W, kClasses);
  auto kernel = kconfirm_kernel<M, kClasses>;
  // static shared memory: b2c, scan, group metas, two 8 x 128 buffers
  const size_t fixed = 256 + 4 * kWarps + 4 * 5 * kMaxGroups +
                       2 * 4 * kWarps * kCapc2;
  if (smem + fixed > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_cells, kThreads, smem, stream>>>(
      corpus, n, b2c, tabs, W, gmeta, G, sigs, fills, slot_cls, cand_counts,
      conf_counts, out_pos, out_cls);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hs_teddy_kconfirm(const void* corpus, long long n,
                                 const void* b2c, const void* tabs, int M,
                                 int W, int classes, const void* gmeta, int G,
                                 const void* sigs, const void* fills,
                                 const void* slot_cls, void* cand_counts,
                                 void* conf_counts, void* out_pos,
                                 void* out_cls, int n_cells, void* stream) {
  if (G < 0 || G > kMaxGroups) return int(cudaErrorInvalidValue);
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* b = static_cast<const uint8_t*>(b2c);
  const auto* t = static_cast<const uint32_t*>(tabs);
  const auto* gm = static_cast<const int32_t*>(gmeta);
  const auto* sg = static_cast<const uint16_t*>(sigs);
  const auto* fl = static_cast<const uint8_t*>(fills);
  const auto* sc = static_cast<const int32_t*>(slot_cls);
  auto* cc = static_cast<int32_t*>(cand_counts);
  auto* fc = static_cast<int32_t*>(conf_counts);
  auto* op = static_cast<int32_t*>(out_pos);
  auto* oc = static_cast<int32_t*>(out_cls);
  auto s = static_cast<cudaStream_t>(stream);
#define HS_CASE(MM)                                                          \
  case MM:                                                                   \
    return classes                                                           \
               ? int(launch<MM, true>(c, n, b, t, W, gm, G, sg, fl, sc, cc,  \
                                      fc, op, oc, n_cells, s))               \
               : int(launch<MM, false>(c, n, b, t, W, gm, G, sg, fl, sc, cc, \
                                       fc, op, oc, n_cells, s));
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

extern "C" const char* hs_teddy_kconfirm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
