// Single-word Teddy gate with one flag per 128-byte row (sm_90a).
//
// Replaces the Pallas TPU kernel _make_kernel_gate (hyperscan_tpu/ops/
// teddy.py:649, launched by the pallas_call at :1381) together with the XLA
// row reduce and survivor count that follow it (:1401-1408): stage 1 of the
// gated family.
//
// What it computes. gate(p) = AND_{m<M} gcm[m][b2c[byte p - m]] != 0 for
// p < n (a zero byte before offset 0), where gcm (dev_gate_table, :1644) is
// the compiler's gate table (compiler/teddy.py build_gate_masks) indexed by
// the full masks' byte classes. Row r (bytes [128 r, 128 r + 128)) is
// flagged when any of its positions below n passes the gate. Out: one flag
// byte per row for every row of every 64 KiB cell (0 past n), and the number
// of flagged rows of each cell. The gate is a per-position superset of the
// full filter, so a row whose flag is 0 holds no candidate end; stage 2
// (teddy_filter_compact.cu, survivor-row mode) rescans the flagged rows.
//
// What bounds it. Each corpus byte is read once and costs 1 + M shared-memory
// lookups (the class remap and M gate words), against 1 + M*W for the full
// filter: at M=5 that is 6 lookups a byte against 132 SMs x 32 lookups a
// clock, still above the byte bound, so the lookups bound it. The flags
// written are n/128 bytes.
//
// Design. Kernel A's shape (teddy_filter.cuh: a resident grid walking the
// 64 KiB cells, tables staged once a block, 16-byte loads, look-back by a
// warp shuffle) with W = 1: the gate words are one word a (m, class), so the
// loop reads them with 32-bit loads (V = 1) from 32 copies (fewer where M is
// large), one bank a lane, and no padded words. Eight threads of 16 bytes
// cover one row, so a warp's ballot of "any gate hit" holds the flags of its
// four rows, and lane 0 stores them as one 32-bit word. The TPU wrote an
// n-byte gate plane and reduced it per row in XLA; here no plane exists.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

template <int M>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const uint8_t* __restrict__ corpus, long long n,
            const uint8_t* __restrict__ b2c, const uint32_t* __restrict__ gcm,
            int R, uint8_t* __restrict__ flags, int32_t* __restrict__ counts,
            int n_cells) {
  extern __shared__ __align__(16) uint32_t s_tab[];  // [M][128][R]
  __shared__ uint8_t s_b2c[256];
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  stage_tables<1>(s_tab, gcm, M, 128, 1, R);
  s_b2c[tid] = b2c[tid];  // kThreads == 256
  __syncthreads();

  for (int cell = blockIdx.x; cell < n_cells; cell += gridDim.x) {
    const long long cell0 = (long long)cell * kCell;
    int flagged = 0;  // rows flagged by this warp (lane 0's count)
    for (int step = 0; step < kSteps; ++step) {
      const long long base = cell0 + (long long)step * kStep;
      bool any = false;
      if (base < n) {  // uniform across the block
        const long long p0 = base + tid * kChunk;
        uint32_t win[6];
        load_window(corpus, n, p0, lane == 0, win);
        any = cand_bits<M, true, 1>(win, s_b2c, s_tab, 1, R, p0, n) != 0u;
      }
      const unsigned bal = __ballot_sync(kFull, any);
      if (lane == 0) {
        uint32_t word = 0;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if ((bal >> (8 * r)) & 0xFFu) word |= 1u << (8 * r);
        flagged += __popc(word);
        *reinterpret_cast<uint32_t*>(
            flags + (base + (long long)warp * 32 * kChunk) / kRowBytes) = word;
      }
    }
    if (lane == 0) s_warp[warp] = flagged;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) total += s_warp[k];
      counts[cell] = total;
    }
    __syncthreads();  // s_warp is written again by the next cell
  }
}

template <int M>
cudaError_t launch(const uint8_t* corpus, long long n, const uint8_t* b2c,
                   const uint32_t* gcm, uint8_t* flags, int32_t* counts,
                   int n_cells, cudaStream_t stream) {
  const int R = table_copies(M, 128, 1, 1);
  const size_t smem = table_bytes(M, 128, 1, R);
  cudaError_t e;
  const int grid = resident_grid(gate_kernel<M>, smem, n_cells, e);
  if (e != cudaSuccess) return e;
  gate_kernel<M><<<grid, kThreads, smem, stream>>>(corpus, n, b2c, gcm, R,
                                                   flags, counts, n_cells);
  return cudaGetLastError();
}

}  // namespace

extern "C" int hs_teddy_gate(const void* corpus, long long n, const void* b2c,
                             const void* gcm, int M, void* flags,
                             void* counts, int n_cells, void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* b = static_cast<const uint8_t*>(b2c);
  const auto* g = static_cast<const uint32_t*>(gcm);
  auto* f = static_cast<uint8_t*>(flags);
  auto* k = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return int(launch<1>(c, n, b, g, f, k, n_cells, s));
    case 2: return int(launch<2>(c, n, b, g, f, k, n_cells, s));
    case 3: return int(launch<3>(c, n, b, g, f, k, n_cells, s));
    case 4: return int(launch<4>(c, n, b, g, f, k, n_cells, s));
    case 5: return int(launch<5>(c, n, b, g, f, k, n_cells, s));
    case 6: return int(launch<6>(c, n, b, g, f, k, n_cells, s));
    case 7: return int(launch<7>(c, n, b, g, f, k, n_cells, s));
    case 8: return int(launch<8>(c, n, b, g, f, k, n_cells, s));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* hs_teddy_gate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
