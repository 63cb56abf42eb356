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
// Stages. A compile-time parameter cuts the kernel after each part of the
// confirm, for timing each part on its own (the counterpart of the
// reference's stage-bisect probes, tools_probe_kconf_split.py:128, :164 and
// tools_probe_rank_bisect.py:163, and of teddy.py's _KCONF_STAGE). Stages
// 0-2 write three counts a cell, (candidates, checksum, matches), and no
// pairs:
//   0: the filter and the exact candidate count (checksum, matches 0);
//   1: + each candidate's 8 tail bytes and every group's avalanche hash h,
//      folded into the checksum sum(h) mod 2^32 over the candidates and the
//      groups they reach (p >= cl - 1), so the work cannot be dropped;
//   2: + the bucket-row reads and signature compares: the exact match count;
//   3: the full kernel (the pairs; its outputs are described above).
// Only the stage probe and the tests launch stages 0-2; no scan path does.
// The kernel is a template in teddy_kconfirm.cuh: this library instantiates
// stage 3, teddy_kconfirm_stage.cu stages 0-2, so the scan path's library
// compiles a quarter of the instances.
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

#include "teddy_kconfirm.cuh"

extern "C" int hs_teddy_kconfirm(const void* corpus, long long n,
                                 const void* b2c, const void* tabs, int M,
                                 int W, int classes, const void* gmeta, int G,
                                 const void* sigs, const void* fills,
                                 const void* slot_cls, void* cand_counts,
                                 void* conf_counts, void* out_pos,
                                 void* out_cls, int n_cells, void* stream) {
  return launch_any<3>(corpus, n, b2c, tabs, M, W, classes, gmeta, G, sigs,
                       fills, slot_cls, cand_counts, conf_counts, out_pos,
                       out_cls, nullptr, n_cells, stream);
}

extern "C" const char* hs_teddy_kconfirm_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
