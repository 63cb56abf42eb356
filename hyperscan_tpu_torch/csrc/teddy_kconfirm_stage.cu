// Kernel 4's stage modes 0-2 (sm_90a): the kconfirm kernel of
// teddy_kconfirm.cuh cut after each part of its confirm, for timing each
// part on its own (the counterpart of the reference's stage-bisect probes,
// tools_probe_kconf_split.py:128, :164 and tools_probe_rank_bisect.py:163).
// What each stage computes is set out in teddy_kconfirm.cu. A library of
// its own, so that the scan path's library compiles only stage 3.

#include "teddy_kconfirm.cuh"

extern "C" int hs_teddy_kconfirm_stage(
    const void* corpus, long long n, const void* b2c, const void* tabs,
    int M, int W, int classes, const void* gmeta, int G, const void* sigs,
    const void* fills, const void* slot_cls, void* cand_counts,
    void* conf_counts, void* checksums, int stage, int n_cells,
    void* stream) {
#define HS_STAGE(S)                                                          \
  case S:                                                                    \
    return launch_any<S>(corpus, n, b2c, tabs, M, W, classes, gmeta, G,      \
                         sigs, fills, slot_cls, cand_counts, conf_counts,    \
                         nullptr, nullptr, checksums, n_cells, stream);
  switch (stage) {
    HS_STAGE(0)
    HS_STAGE(1)
    HS_STAGE(2)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef HS_STAGE
}

extern "C" const char* hs_teddy_kconfirm_stage_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
