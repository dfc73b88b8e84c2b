// Block GMRES's whole-solve kernel (block_gmres.cuh) for f32 vectors and
// an f32 basis with f32 diagonals;
// replaces the TPU kernel krylov_tpu/ops/pallas_fused.py:2221
// block_gmres_dia_fused.  One set of types a file, so that the sets
// compile side by side.
#include "block_gmres.cuh"

KTT_BG_ENTRIES(ktt_block_gmres_dia_init_f32_f32_f32,
               ktt_block_gmres_dia_iterate_f32_f32_f32, float, float, float)
