// Block MINRES's whole-solve kernel (block_minres.cuh) for f32 vectors
// with f32, bf16 or f16 diagonals; replaces the TPU kernel
// krylov_tpu/ops/pallas_fused.py:2669 block_minres_dia_fused.
#include "block_minres.cuh"

KTT_BM_INIT(ktt_block_minres_dia_init_f32, float)
KTT_BM_ITERATE(ktt_block_minres_dia_iterate_f32_f32, float, float)
KTT_BM_ITERATE(ktt_block_minres_dia_iterate_f32_bf16, float, __nv_bfloat16)
KTT_BM_ITERATE(ktt_block_minres_dia_iterate_f32_f16, float, __half)
