// GMRES's whole-solve kernel (gmres.cuh) with an f16 Krylov panel and f32
// or f64 vectors; replaces the TPU kernel
// krylov_tpu/ops/pallas_fused.py:1922 gmres_dia_fused.
#include "gmres.cuh"

KTT_GMRES_INIT(ktt_gmres_dia_init_f32_f16, float, __half)
KTT_GMRES_INIT(ktt_gmres_dia_init_f64_f16, double, __half)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_f32_f16, float, float, __half)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_bf16_f16, float, __nv_bfloat16,
                  __half)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_f16_f16, float, __half, __half)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f64_f64_f16, double, double, __half)
