// Block GMRES's whole-solve kernel (block_gmres.cuh) with a compressed
// bf16 basis and f32 vectors (f32, bf16 or f16 diagonals); replaces the
// TPU kernel krylov_tpu/ops/pallas_fused.py:2221 block_gmres_dia_fused.
#include "block_gmres.cuh"

KTT_BG_ENTRIES(ktt_block_gmres_dia_init_f32_f32_bf16,
               ktt_block_gmres_dia_iterate_f32_f32_bf16, float, float,
               __nv_bfloat16)
KTT_BG_ENTRIES(ktt_block_gmres_dia_init_f32_bf16_bf16,
               ktt_block_gmres_dia_iterate_f32_bf16_bf16, float,
               __nv_bfloat16, __nv_bfloat16)
KTT_BG_ENTRIES(ktt_block_gmres_dia_init_f32_f16_bf16,
               ktt_block_gmres_dia_iterate_f32_f16_bf16, float, __half,
               __nv_bfloat16)
