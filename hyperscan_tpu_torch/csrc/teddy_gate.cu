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
// What bounds it. Each corpus byte is read once and each position needs its
// M gate words: M shared-memory words a position against 132 SMs x 32 words
// a clock, above the byte bound, so the lookups bound it. The flags written
// are n/128 bytes.
//
// Design. The host folds the class remap into the table: vec[b] =
// (gcm[0][b2c[b]], ..., gcm[M-1][b2c[b]]) (ops/teddy_gate.py gate_vectors),
// so a byte costs no remap and no multiply. Each byte's vector is loaded
// once and serves the M positions it belongs to (position p takes word m of
// byte p - m's vector) from registers: M words a byte and M - 1 ANDs a
// position. The vector is held as 128-bit parts (words 4h .. 4h+3) in 8
// copies, so the 8 lanes of a quarter warp read distinct banks whatever
// their bytes, and the M % 4 words left as single words in R1 copies (32,
// fewer where M is large), one bank a lane: M shared wavefronts a warp-byte,
// with no padded word. A thread takes 32 bytes a step (the 8 bytes before
// them from its left neighbour by a warp shuffle), so the look-back loads
// are (M - 1) / 32 of the bytes. Four threads cover one row, so a warp's
// ballot of "any gate hit" holds the flags of its eight rows, and lane 0
// stores them as 8 bytes. Blocks walk the 64 KiB cells on a resident grid
// (teddy_filter.cuh). The TPU wrote an n-byte gate plane and reduced it per
// row in XLA; here no plane exists.

#include "teddy_filter.cuh"

namespace {

using namespace teddy;

constexpr int kGateChunk = 32;                    // bytes a thread a step
constexpr int kGateStep = kThreads * kGateChunk;  // bytes a block a step
constexpr int kGateSteps = kCell / kGateStep;
constexpr int kRowThreads = kRowBytes / kGateChunk;  // threads a row
constexpr int kCopies4 = 8;  // copies of a 128-bit part: a quarter warp
constexpr size_t kGateBudget = 64 * 1024;  // three blocks an SM
static_assert(kCell % kGateStep == 0, "a cell is a whole number of steps");
static_assert(kRowThreads == 4, "a warp's ballot holds eight rows");

template <int M>
__global__ void __launch_bounds__(kThreads)
gate_kernel(const uint8_t* __restrict__ corpus, long long n,
            const uint32_t* __restrict__ vec, int R1,
            uint8_t* __restrict__ flags, int32_t* __restrict__ counts,
            int n_cells) {
  constexpr int n4 = M / 4;    // 128-bit parts of a vector
  constexpr int rem = M % 4;   // single words after them
  extern __shared__ __align__(16) uint32_t s_tab[];
  uint32_t* s4 = s_tab;                        // [n4][256][8][4]
  uint32_t* s1 = s_tab + n4 * 256 * kCopies4 * 4;  // [rem][256][R1]
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < n4 * 256 * kCopies4; i += kThreads) {
    const int hb = i / kCopies4;  // (part, byte)
    const int b = hb % 256, h = hb / 256;
#pragma unroll
    for (int e = 0; e < 4; ++e) s4[i * 4 + e] = vec[b * M + 4 * h + e];
  }
  for (int i = tid; i < rem * 256 * R1; i += kThreads) {
    const int wb = i / R1;  // (word, byte)
    const int b = wb % 256, w = wb / 256;
    s1[i] = vec[b * M + 4 * n4 + w];
  }
  __syncthreads();
  const uint32_t* my4 = s4 + (lane & (kCopies4 - 1)) * 4;
  const uint32_t* my1 = s1 + (lane & (R1 - 1));

  for (int cell = blockIdx.x; cell < n_cells; cell += gridDim.x) {
    const long long cell0 = (long long)cell * kCell;
    int flagged = 0;  // rows flagged by this warp (lane 0's count)
    for (int step = 0; step < kGateSteps; ++step) {
      const long long base = cell0 + (long long)step * kGateStep;
      bool any = false;
      if (base < n) {  // uniform across the block
        const long long p0 = base + tid * kGateChunk;
        // win[k]: bytes p0 - 8 + 4 k .. p0 - 5 + 4 k
        uint32_t win[10];
        const uint4 c0 = load16(corpus, n, p0);
        const uint4 c1 = load16(corpus, n, p0 + 16);
        uint32_t pz = __shfl_up_sync(kFull, c1.z, 1);
        uint32_t pw = __shfl_up_sync(kFull, c1.w, 1);
        if (lane == 0) {  // the left neighbour holds other bytes
          const uint4 prev = load16(corpus, n, p0 - 16);
          pz = prev.z;
          pw = prev.w;
        }
        win[0] = pz; win[1] = pw;
        win[2] = c0.x; win[3] = c0.y; win[4] = c0.z; win[5] = c0.w;
        win[6] = c1.x; win[7] = c1.y; win[8] = c1.z; win[9] = c1.w;
        uint32_t acc[kGateChunk];
#pragma unroll
        for (int j = 0; j < kGateChunk; ++j) acc[j] = 0xFFFFFFFFu;
#pragma unroll
        for (int q = 8 - (M - 1); q < 8 + kGateChunk; ++q) {
          // byte p0 - 8 + q: word m of its vector goes to position q - 8 + m
          const uint32_t b = (win[q >> 2] >> ((q & 3) * 8)) & 0xFFu;
          uint32_t w[M];
#pragma unroll
          for (int h = 0; h < n4; ++h) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                my4 + ((h * 256 + b) * kCopies4) * 4);
            w[4 * h] = v.x; w[4 * h + 1] = v.y;
            w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int e = 0; e < rem; ++e)
            w[4 * n4 + e] = my1[(e * 256 + b) * R1];
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int j = q - 8 + m;
            if (j >= 0 && j < kGateChunk) acc[j] &= w[m];
          }
        }
        uint32_t bits = 0u;
#pragma unroll
        for (int j = 0; j < kGateChunk; ++j)
          bits |= uint32_t(acc[j] != 0u) << j;
        const long long left = n - p0;  // bytes of the chunk below n
        if (left < kGateChunk) bits &= left <= 0 ? 0u : (1u << left) - 1u;
        any = bits != 0u;
      }
      const unsigned bal = __ballot_sync(kFull, any);
      if (lane == 0) {
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if ((bal >> (kRowThreads * r)) & 0xFu)
            word[r >> 2] |= 1u << (8 * (r & 3));
        flagged += __popc(word[0]) + __popc(word[1]);
        *reinterpret_cast<uint2*>(
            flags + (base + (long long)warp * 32 * kGateChunk) / kRowBytes) =
            make_uint2(word[0], word[1]);
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

// Copies of each single word: 32, fewer until the table fits the budget.
inline int single_copies(int M) {
  int R1 = 32;
  while (R1 > 1 && (size_t(M / 4) * 256 * kCopies4 * 4 +
                    size_t(M % 4) * 256 * R1) * 4 > kGateBudget)
    R1 >>= 1;
  return R1;
}

template <int M>
cudaError_t launch(const uint8_t* corpus, long long n, const uint32_t* vec,
                   uint8_t* flags, int32_t* counts, int n_cells,
                   cudaStream_t stream) {
  const int R1 = single_copies(M);
  const size_t smem =
      (size_t(M / 4) * 256 * kCopies4 * 4 + size_t(M % 4) * 256 * R1) * 4;
  cudaError_t e;
  const int grid = resident_grid(gate_kernel<M>, smem, n_cells, e);
  if (e != cudaSuccess) return e;
  gate_kernel<M><<<grid, kThreads, smem, stream>>>(corpus, n, vec, R1, flags,
                                                   counts, n_cells);
  return cudaGetLastError();
}

}  // namespace

// vec: [256][M] uint32, vec[b][m] = gcm[m][b2c[b]].
extern "C" int hs_teddy_gate(const void* corpus, long long n, const void* vec,
                             int M, void* flags, void* counts, int n_cells,
                             void* stream) {
  const auto* c = static_cast<const uint8_t*>(corpus);
  const auto* v = static_cast<const uint32_t*>(vec);
  auto* f = static_cast<uint8_t*>(flags);
  auto* k = static_cast<int32_t*>(counts);
  auto s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return int(launch<1>(c, n, v, f, k, n_cells, s));
    case 2: return int(launch<2>(c, n, v, f, k, n_cells, s));
    case 3: return int(launch<3>(c, n, v, f, k, n_cells, s));
    case 4: return int(launch<4>(c, n, v, f, k, n_cells, s));
    case 5: return int(launch<5>(c, n, v, f, k, n_cells, s));
    case 6: return int(launch<6>(c, n, v, f, k, n_cells, s));
    case 7: return int(launch<7>(c, n, v, f, k, n_cells, s));
    case 8: return int(launch<8>(c, n, v, f, k, n_cells, s));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* hs_teddy_gate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
