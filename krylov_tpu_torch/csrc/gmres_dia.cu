// GMRES's whole-solve kernel (gmres.cuh) with the Krylov panel in b's type;
// replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:1922
// gmres_dia_fused.
#include "gmres.cuh"

KTT_GMRES_INIT(ktt_gmres_dia_init_f32_f32, float, float)
KTT_GMRES_INIT(ktt_gmres_dia_init_f64_f64, double, double)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_f32_f32, float, float, float)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_bf16_f32, float, __nv_bfloat16,
                  float)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f32_f16_f32, float, __half, float)
KTT_GMRES_ITERATE(ktt_gmres_dia_iterate_f64_f64_f64, double, double, double)
