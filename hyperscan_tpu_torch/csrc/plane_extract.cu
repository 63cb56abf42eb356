// Two-level extraction of the nonzero positions of a uint8 plane (sm_90a):
// the dense family's candidate list.
//
// Replaces sparse_extract (hyperscan_tpu/ops/teddy.py:793, XLA glue after the
// plane-mode pallas_call at :1116; EXTRACT_CHUNK = 256 at :997).
//
// What it computes. The plane is cut into 256-byte chunks. Pass 1 writes
// the number of nonzero bytes of every chunk c with 256 c < n_valid, and 0
// for chunks wholly past n_valid. The caller takes an exclusive cumsum of
// these counts (plain torch over n/256 ints: the total and the number of
// hit chunks come from it). Pass 2 writes the position of the k-th nonzero
// byte of the counted chunks to pos[k] for k < cap1, so the first cap1
// positions come out ascending. Nonzero bytes inside the chunk that holds
// n_valid count, as in the reference (its callers bound-check them).
//
// What bounds it. Bytes: pass 1 reads the plane once (n bytes), pass 2 reads
// it again but only the chunks that hold a nonzero byte (skipped by their
// count), and writes 4 bytes a position. At 3.35 TB/s a 512 MiB plane takes
// ~0.16 ms a pass.
//
// Design. Sixteen threads take one chunk with one 16-byte load each; a byte
// compare (__vcmpne4) and a popcount count a thread's nonzero bytes, a
// shuffle reduce over the 16 lanes gives the chunk's count, and in pass 2 a
// shuffle scan over the 16 lanes gives each thread its first rank. The
// reference gathered whole hit chunks and searched ranks in them at a
// learned chunk capacity; here no chunk capacity exists, so none overflows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkBytes = 256;
constexpr int kLanesPerChunk = kChunkBytes / 16;

__device__ __forceinline__ int nonzero_bytes(const uint4 v) {
  return (__popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) +
          __popc(__vcmpne4(v.z, 0u)) + __popc(__vcmpne4(v.w, 0u))) >> 3;
}

__global__ void __launch_bounds__(kThreads)
chunk_count_kernel(const uint8_t* __restrict__ plane, long long n_chunks,
                   long long n_valid, int32_t* __restrict__ counts) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long chunk = t / kLanesPerChunk;  // uniform over 16 lanes
  int c = 0;
  if (chunk < n_chunks && chunk * kChunkBytes < n_valid)
    c = nonzero_bytes(*reinterpret_cast<const uint4*>(plane + t * 16));
#pragma unroll
  for (int d = kLanesPerChunk / 2; d >= 1; d >>= 1)
    c += __shfl_xor_sync(0xffffffffu, c, d, kLanesPerChunk);
  if (chunk < n_chunks && (threadIdx.x & (kLanesPerChunk - 1)) == 0)
    counts[chunk] = c;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ plane, long long n_chunks,
               const int32_t* __restrict__ counts,
               const int64_t* __restrict__ offsets, int cap1,
               int32_t* __restrict__ pos) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long chunk = t / kLanesPerChunk;
  const int sub = threadIdx.x & (kLanesPerChunk - 1);
  const bool live = chunk < n_chunks && counts[chunk] > 0 &&
                    offsets[chunk] < cap1;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (live) v = *reinterpret_cast<const uint4*>(plane + t * 16);
  const int c = live ? nonzero_bytes(v) : 0;
  int incl = c;
#pragma unroll
  for (int d = 1; d < kLanesPerChunk; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, d, kLanesPerChunk);
    if (sub >= d) incl += u;
  }
  if (!c) return;
  long long r = offsets[chunk] + incl - c;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) {
      if (r < cap1) pos[r] = int32_t(t * 16 + k);
      ++r;
    }
  }
}

}  // namespace

extern "C" int hs_plane_chunk_counts(const void* plane, long long n_chunks,
                                     long long n_valid, void* counts,
                                     void* stream) {
  if (n_chunks <= 0) return int(cudaSuccess);
  const long long threads = n_chunks * kLanesPerChunk;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  chunk_count_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), n_chunks, n_valid,
      static_cast<int32_t*>(counts));
  return int(cudaGetLastError());
}

extern "C" int hs_plane_scatter(const void* plane, long long n_chunks,
                                const void* counts, const void* offsets,
                                int cap1, void* pos, void* stream) {
  if (n_chunks <= 0 || cap1 <= 0) return int(cudaSuccess);
  const long long threads = n_chunks * kLanesPerChunk;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), n_chunks,
      static_cast<const int32_t*>(counts),
      static_cast<const int64_t*>(offsets), cap1,
      static_cast<int32_t*>(pos));
  return int(cudaGetLastError());
}

extern "C" const char* hs_plane_extract_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
