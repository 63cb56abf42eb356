// The kconfirm kernel (sm_90a): the Teddy filter with the hash confirm
// inside, as a template over the stage (see teddy_kconfirm.cu for what it
// computes, its stages and its design).
//
// Included by teddy_kconfirm.cu (stage 3, the full kernel that the scan
// path launches) and teddy_kconfirm_stage.cu (stages 0-2, which only the
// stage probe and the tests launch), so that each library compiles only
// its own instances.

#pragma once

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

template <int M, bool kClasses, int kStage>
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
                int32_t* __restrict__ out_cls,
                uint32_t* __restrict__ checksums) {
  constexpr int kTab = kClasses ? 128 : 256;
  extern __shared__ uint32_t s_tab[];  // [M][W][kTab]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_warp[kWarps];
  __shared__ int s_gm[kMaxGroups * 5];
  __shared__ int32_t s_bpos[kWarps][kCapc2];
  __shared__ int32_t s_bcls[kWarps][kCapc2];
  __shared__ uint32_t s_chk[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < M * W * kTab; i += kThreads) s_tab[i] = tabs[i];
  if (kClasses) s_b2c[tid] = b2c[tid];  // kThreads == 256
  for (int i = tid; i < G * 5; i += kThreads) s_gm[i] = gmeta[i];
  __syncthreads();

  const long long cell0 = (long long)blockIdx.x * kCell;
  // stages 0-2 are given no pair buffers
  int32_t* cell_pos =
      kStage == 3 ? out_pos + (long long)blockIdx.x * kCapc2 : nullptr;
  int32_t* cell_cls =
      kStage == 3 ? out_cls + (long long)blockIdx.x * kCapc2 : nullptr;
  int n_cand = 0;  // candidates of this cell before the current step
  int n_conf = 0;  // matches of this cell before the current step
  uint32_t chk = 0;  // stages 1-2: this warp's sum of h (lane 0)
  for (int step = 0; step < kCell / kStep; ++step) {
    const long long base = cell0 + (long long)step * kStep;
    if (base >= n) break;  // uniform across the block
    const long long p0 = base + tid * kChunk;
    uint32_t win[6];
    load_window(corpus, n, p0, lane == 0, win);
    const uint32_t bits =
        cand_bits<M, kClasses>(win, s_b2c, s_tab, W, p0, n);

    int wcnt = 0;  // this warp's matches this step (uniform in the warp)
    unsigned pend = kStage >= 1 ? __ballot_sync(kFull, bits != 0u) : 0u;
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
          if (kStage <= 2 && lane == 0) chk += h;
          if (kStage == 1) continue;
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
          if (kStage == 2) {
            wcnt += int(__reduce_add_sync(kFull, __popc(m)));
            continue;
          }
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
    for (int i = lane; kStage == 3 && i < min(wcnt, kCapc2); i += 32) {
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
  if (kStage <= 2) {
    if (lane == 0) s_chk[warp] = chk;
    __syncthreads();
  }
  if (tid == 0) {
    cand_counts[blockIdx.x] = n_cand;
    conf_counts[blockIdx.x] = n_conf;
    if (kStage <= 2) {
      uint32_t sum = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += s_chk[k];
      checksums[blockIdx.x] = sum;
    }
  }
}

template <int M, bool kClasses, int kStage>
cudaError_t launch(const uint8_t* corpus, long long n, const uint8_t* b2c,
                   const uint32_t* tabs, int W, const int32_t* gmeta, int G,
                   const uint16_t* sigs, const uint8_t* fills,
                   const int32_t* slot_cls, int32_t* cand_counts,
                   int32_t* conf_counts, int32_t* out_pos, int32_t* out_cls,
                   uint32_t* checksums, int n_cells, cudaStream_t stream) {
  const size_t smem = table_bytes(M, W, kClasses);
  auto kernel = kconfirm_kernel<M, kClasses, kStage>;
  // static shared memory: b2c, scan, group metas, two 8 x 128 buffers,
  // checksums
  const size_t fixed = 256 + 4 * kWarps + 4 * 5 * kMaxGroups +
                       2 * 4 * kWarps * kCapc2 + 4 * kWarps;
  if (smem + fixed > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_cells, kThreads, smem, stream>>>(
      corpus, n, b2c, tabs, W, gmeta, G, sigs, fills, slot_cls, cand_counts,
      conf_counts, out_pos, out_cls, checksums);
  return cudaGetLastError();
}

// One stage's launch for any M (1..8) and either table kind.
template <int kStage>
int launch_any(const void* corpus, long long n, const void* b2c,
               const void* tabs, int M, int W, int classes,
               const void* gmeta, int G, const void* sigs,
               const void* fills, const void* slot_cls, void* cand_counts,
               void* conf_counts, void* out_pos, void* out_cls,
               void* checksums, int n_cells, void* stream) {
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
  auto* ck = static_cast<uint32_t*>(checksums);
  auto s = static_cast<cudaStream_t>(stream);
#define HS_CASE(MM)                                                         \
  case MM:                                                                  \
    return classes ? int(launch<MM, true, kStage>(c, n, b, t, W, gm, G, sg, \
                                                  fl, sc, cc, fc, op, oc,   \
                                                  ck, n_cells, s))          \
                   : int(launch<MM, false, kStage>(c, n, b, t, W, gm, G,    \
                                                   sg, fl, sc, cc, fc, op,  \
                                                   oc, ck, n_cells, s));
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

}  // namespace
