// Block MINRES's whole-solve kernel (block_minres.cuh) for f64 vectors
// and diagonals; replaces the TPU kernel
// krylov_tpu/ops/pallas_fused.py:2669 block_minres_dia_fused.
#include "block_minres.cuh"

KTT_BM_INIT(ktt_block_minres_dia_init_f64, double)
KTT_BM_ITERATE(ktt_block_minres_dia_iterate_f64_f64, double, double)
