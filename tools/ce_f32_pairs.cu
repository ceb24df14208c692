// src/repro_torch/kernels/csrc/fused_ce_bwd.cu as it is, for
// tools/ce_f32_pairs.py to build with macros that vary the f32 route (read
// by csrc/ce_planes.cuh): CE_PASSES3 / CE_PAIR_A / CE_PAIR_B (the plane
// pairs a product) and CE_COEF3_PROMOTE (the stages of one tensor-core sum
// in the scores' (0, 0) pass; 0: one sum over all of K).
#include "../src/repro_torch/kernels/csrc/fused_ce_bwd.cu"
