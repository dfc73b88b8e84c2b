"""Build and load the port's CUDA kernels.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles each
source for Hopper (``sm_90a``); one more links the objects into a shared
library with a plain C interface, which ``ctypes`` loads.  No PyTorch
header is compiled, so the build takes seconds.  The library goes to
``build/krylov_tpu_torch/`` at the root of the checkout, beside a stamp
holding the hash of the sources and flags; changed sources rebuild.
Nothing is built when the package is imported: the first kernel launch
builds.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "krylov_tpu_torch"
LIB_PATH = BUILD_DIR / "libkrylov_tpu_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# (vector, diagonal) type pairs that every kernel takes
_PAIRS = ("f32_f32", "f32_bf16", "f32_f16", "f64_f64")
# the further pairs of the DIA SpMV kernels (ops/cuda_dia.py)
_SPMV_PAIRS = _PAIRS + ("f64_f32", "bf16_bf16", "f16_f16", "c64_f32",
                        "c64_c64", "c128_f64", "c128_c128")
# the element types of the block-ELL kernels
_BELL = ("f32", "f64", "bf16", "f16", "c64", "c128")
# the kernels on the Saunders-Simon-Yip launches of csrc/ssy.cuh
_SSY = ("usymlq", "usymqr", "trilqr", "usymlqr", "tricg", "trimr")
# the kernels on the Golub-Kahan launches of csrc/gk.cuh
_GK = ("lsqr", "lsmr", "lslq", "craig", "craigmr", "lnlq")
# C entry points and their argument types; every pointer and the stream
# is a c_void_p, so ctypes never cuts a 64-bit address to 32 bits.
_SIGNATURES = {
    # (pd, offsets, nd, x, y, n[, halo], lo, hi, kabs, stream)
    **{f"ktt_dia_spmv_{t}": (_P, _P, _I, _P, _P, _L, _L, _L, _L, _P)
       for t in _SPMV_PAIRS},
    **{f"ktt_dia_spmv_padded_{t}": (_P, _P, _I, _P, _P, _L, _L, _L, _L, _L,
                                    _P)
       for t in _SPMV_PAIRS},
    **{f"ktt_cg_dia_init_{t}": (_P,) * 8 + (_L, _I, _D, _D, _P)
       for t in ("f32", "f64")},
    **{f"ktt_cg_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 8
       + (_L, _I, _I, _I, _P)
       for t in _PAIRS},
    # (pd, offsets, nd, b, work, partial, sc, st, n, grid, degree, atol,
    # rtol, stream) and (pd, offsets, nd, work, partial, sc, st, n, grid,
    # degree, iters, cap, stream)
    **{f"ktt_cg_cheby_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _D, _D, _P) for t in _PAIRS},
    **{f"ktt_cg_cheby_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # (pd, offsets, nd, b, work, partial, sc, st, n, grid, stream) and
    # (pd, offsets, nd, work, partial, sc, st, n, grid, iters, cap, stream)
    **{f"ktt_{k}_dia_init_{t}": (_P, _P, _I) + (_P,) * 5 + (_L, _I, _P)
       for k in ("cr", "car") for t in _PAIRS},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _P) for k in ("cr", "car") for t in _PAIRS},
    # (b, dinv, work, partial, sc, st, n, grid, window, stream) and (pd,
    # offsets, nd, dinv, work, partial, sc, st, n, grid, window, iters, cap,
    # stream)
    **{f"ktt_minres_dia_init_{t}": (_P,) * 6 + (_L, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_minres_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # (b, work, partial, sc, st, n, grid[, nshifts], stream) and (pd,
    # offsets, nd, work, partial, sc, st, n, grid[, nshifts],
    # check_curvature, iters, cap, stream)
    **{f"ktt_cg_lanczos_dia_init_{t}": (_P,) * 5 + (_L, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_cg_lanczos_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_cg_lanczos_shift_dia_init_{t}": (_P,) * 5 + (_L, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_cg_lanczos_shift_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _I, _P) for t in _PAIRS},
    # (pd, offsets, nd, b, work, partial, sc, st, n, grid, transfer_to_cg,
    # stream), (pd, offsets, nd, work, partial, sc, st, n, grid,
    # transfer_to_cg, iters, cap, stream) and (work, sc, st, n, grid,
    # stream)
    **{f"ktt_symmlq_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_symmlq_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_symmlq_dia_finish_{t}": (_P,) * 3 + (_L, _I, _P)
       for t in ("f32", "f64")},
    # (b, work, partial, sc, st, n, grid, stream), (pd, offsets, nd, work,
    # partial, sc, st, n, grid, iters, cap, stream) and (work, sc, st, n,
    # grid, stream)
    **{f"ktt_minres_qlp_dia_init_{t}": (_P,) * 5 + (_L, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_minres_qlp_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_minres_qlp_dia_finish_{t}": (_P,) * 3 + (_L, _I, _P)
       for t in ("f32", "f64")},
    # (pd, offsets, nd, b, work, partial, sc, st, n, grid, itmax, stream)
    # and (pd, offsets, nd, work, partial, sc, st, n, grid, iters, cap,
    # stream)
    **{f"ktt_minares_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_minares_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _P) for t in _PAIRS},
    # (b, V, x, partial, sc, st, n, grid, mem, itmax, stream) and (pd,
    # offsets, nd, lo, hi, b, w, V, x, partial, sc, st, n, grid, mem[,
    # confirm], iters, cap, stream); GMRES's names end in the Krylov
    # panel's type
    **{f"ktt_gmres_dia_init_{t[:3]}_{v}": (_P,) * 6 + (_L, _I, _I, _I, _P)
       for t in ("f32", "f64") for v in (t, "bf16", "f16")},
    **{f"ktt_gmres_dia_iterate_{t}_{v}": (_P, _P, _I, _L, _L) + (_P,) * 7
       + (_L, _I, _I, _I, _I, _I, _P)
       for t in _PAIRS for v in (t[:3], "bf16", "f16")},
    **{f"ktt_fom_dia_init_{t}": (_P,) * 6 + (_L, _I, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_fom_dia_iterate_{t}": (_P, _P, _I, _L, _L) + (_P,) * 7
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # (b, work, partial, sc, st, n, grid, stream) and (pd, offsets, nd, b,
    # work, partial, sc, st, n, grid, iters, cap, stream)
    **{f"ktt_{k}_dia_init_{t}": (_P,) * 5 + (_L, _I, _P)
       for k in ("bicgstab", "cgs") for t in ("f32", "f64")},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _I, _P) for k in ("bicgstab", "cgs") for t in _PAIRS},
    # (b, V, P, x, partial, sc, st, n, grid, mem, mP, stream) and (pd,
    # offsets, nd, lo, hi, w, V, P, x, partial, sc, st, n, grid, mem, mP,
    # diom, iters, cap, stream)
    **{f"ktt_trunc_dia_init_{t}": (_P,) * 7 + (_L, _I, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_trunc_dia_iterate_{t}": (_P, _P, _I, _L, _L) + (_P,) * 7
       + (_L, _I, _I, _I, _I, _I, _I, _P) for t in _PAIRS},
    # (b, c, work, partial, sc, st, n, grid, stream), (pd, offsets, nd,
    # pd_adj, offsets_adj, nd_adj, lo, hi, lo_adj, hi_adj, work, partial,
    # sc, st, n, grid, flag, iters, cap, stream) and (work, sc, st, n,
    # grid, stream)
    **{f"ktt_{k}_dia_init_{t}": (_P,) * 6 + (_L, _I, _P)
       for k in ("bilq", "qmr", "bilqr") for t in ("f32", "f64")},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I) + (_L,) * 4
       + (_P,) * 4 + (_L, _I, _I, _I, _I, _P)
       for k in ("bilq", "qmr", "bilqr") for t in _PAIRS},
    **{f"ktt_{k}_dia_finish_{t}": (_P,) * 3 + (_L, _I, _P)
       for k in ("bilq", "qmr", "bilqr") for t in ("f32", "f64")},
    # the SSY kernels (csrc/ssy.cuh): (b, c, work, partial, sc, st, n, grid,
    # flag, stream), iterate as the two-sided kernels, and (work, sc, st,
    # n, grid, stream)
    **{f"ktt_{k}_dia_init_{t}": (_P,) * 6 + (_L, _I, _I, _P)
       for k in _SSY for t in ("f32", "f64")},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I) + (_L,) * 4
       + (_P,) * 4 + (_L, _I, _I, _I, _I, _P)
       for k in _SSY for t in _PAIRS},
    **{f"ktt_{k}_dia_finish_{t}": (_P,) * 3 + (_L, _I, _P)
       for k in ("usymlq", "usymqr", "trilqr", "usymlqr")
       for t in ("f32", "f64")},
    # the Golub-Kahan kernels (csrc/gk.cuh): (pd_adj, offsets_adj, nd_adj,
    # b, work, partial, sc, st, n, grid, flag, window, stream), (pd,
    # offsets, nd, pd_adj, offsets_adj, nd_adj, work, partial, sc, st, n,
    # grid, flag, window, iters, cap, stream) and (work, sc, st, n, grid,
    # flag, stream)
    **{f"ktt_{k}_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _I, _P) for k in _GK for t in _PAIRS},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _I, _P) for k in _GK for t in _PAIRS},
    **{f"ktt_{k}_dia_finish_{t}": (_P,) * 3 + (_L, _I, _I, _P)
       for k in ("lslq", "lnlq") for t in ("f32", "f64")},
    # CGNE and CRMR (csrc/cgne_crmr_dia.cu): (pd_adj, offsets_adj, nd_adj,
    # b, work, partial, sc, st, n, grid, variant, stream) and (pd, offsets,
    # nd, pd_adj, offsets_adj, nd_adj, work, partial, sc, st, n, grid,
    # variant, iters, cap, stream)
    **{f"ktt_cgne_crmr_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_cgne_crmr_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I)
       + (_P,) * 4 + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # CGLS and CRLS (csrc/cgls_dia.cu, csrc/crls_dia.cu): ([pd, offsets,
    # nd,] pd_adj, offsets_adj, nd_adj, b, work, partial, sc, st, n, grid,
    # stream), CRLS's with A's diagonals first, and (pd, offsets, nd,
    # pd_adj, offsets_adj, nd_adj, work, partial, sc, st, n, grid, iters,
    # cap, stream)
    **{f"ktt_cgls_dia_init_{t}": (_P, _P, _I) + (_P,) * 5 + (_L, _I, _P)
       for t in _PAIRS},
    **{f"ktt_crls_dia_init_{t}": (_P, _P, _I, _P, _P, _I) + (_P,) * 5
       + (_L, _I, _P) for t in _PAIRS},
    **{f"ktt_{k}_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _P) for k in ("cgls", "crls") for t in _PAIRS},
    # CGLS-Lanczos-shift (csrc/cgls_lanczos_shift_dia.cu): (pd_adj,
    # offsets_adj, nd_adj, b, work, partial, sc, st, n, grid, nshifts,
    # stream) and (pd, offsets, nd, pd_adj, offsets_adj, nd_adj, work,
    # partial, sc, st, n, grid, nshifts, iters, cap, stream)
    **{f"ktt_cgls_lanczos_shift_dia_init_{t}": (_P, _P, _I) + (_P,) * 5
       + (_L, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_cgls_lanczos_shift_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I)
       + (_P,) * 4 + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # GPMR (csrc/gpmr_dia.cu): (b, c, work, partial, sc, st, n, grid, mem,
    # stream), (pd_a, offsets_a, nd_a, pd_b, offsets_b, nd_b, work,
    # partial, sc, st, n, grid, mem, iters, cap, stream) and (work, sc,
    # st, n, grid, mem, stream)
    **{f"ktt_gpmr_dia_init_{t}": (_P,) * 6 + (_L, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_gpmr_dia_iterate_{t}": (_P, _P, _I, _P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    **{f"ktt_gpmr_dia_finish_{t}": (_P,) * 3 + (_L, _I, _I, _P)
       for t in ("f32", "f64")},
    # block MINRES (csrc/block_minres_dia.cu, block_minres_dia_f64.cu):
    # (Bt, work, partial, sc, st, n, grid, p, stream) and (pd, offsets, nd,
    # work, partial, sc, st, n, grid, p, iters, cap, stream)
    **{f"ktt_block_minres_dia_init_{t}": (_P,) * 5 + (_L, _I, _I, _P)
       for t in ("f32", "f64")},
    **{f"ktt_block_minres_dia_iterate_{t}": (_P, _P, _I) + (_P,) * 4
       + (_L, _I, _I, _I, _I, _P) for t in _PAIRS},
    # block GMRES (csrc/block_gmres_dia.cu, block_gmres_dia_bf16.cu,
    # block_gmres_dia_f64.cu; the names end in the basis type): (pd,
    # offsets, nd, Bt, V, W, X, partial, sc, st, n, grid, p, mem, itmax,
    # stream) and (..., grid, p, mem, confirm, iters, cap, stream)
    **{f"ktt_block_gmres_dia_{k}_{t}_{v}": (_P, _P, _I) + (_P,) * 7
       + (_L,) + (_I,) * (4 if k == "init" else 6) + (_P,)
       for k in ("init", "iterate") for t in _PAIRS
       for v in (t[:3], "bf16")},
    # the block-ELL products (csrc/bell_spmv.cu): (data, idx, x, y, nbr,
    # mbpr, bs, m, n[, p, cols], rows, parts, ld, wide, stream)
    **{f"ktt_bell_spmv_{t}": (_P,) * 4 + (_I, _I, _I, _L, _L) + (_I,) * 4
       + (_P,) for t in _BELL},
    **{f"ktt_bell_spmm_{t}": (_P,) * 4 + (_I, _I, _I, _L, _L) + (_I,) * 6
       + (_P,) for t in _BELL},
    # the SELL-C-128 product over a part table (csrc/sell_spmv.cu): (data,
    # idx, chunk_of, slice_ptr, table, nparts, inv, x, y_dia, y, nsl, m, n,
    # stream)
    **{f"ktt_sell_spmv_{t}": (_P,) * 5 + (_I, _P, _P, _P, _P, _I, _L, _L, _P)
       for t in _SPMV_PAIRS},
}


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _key():
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def build():
    """Compile the kernels unless the library for these sources exists.

    Returns the library's path."""
    key = _key()
    stamp = LIB_PATH.with_suffix(".sha256")
    if LIB_PATH.exists() and stamp.exists() and stamp.read_text() == key:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}.tmp")
    cu, _ = _sources()
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in cu]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(cu, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    results = [(cmd, proc, *proc.communicate())
               for cmd, proc in zip(compiles, procs)]
    link = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc, out, err in results:
            _check_run(cmd, proc.returncode, out, err)
        proc = subprocess.run(link, capture_output=True, text=True)
        _check_run(link, proc.returncode, proc.stdout, proc.stderr)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, LIB_PATH)
    stamp.write_text(key)
    return LIB_PATH


def _check_run(cmd, returncode, out, err):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n"
                           f"{' '.join(cmd)}\n{out}{err}")


@functools.cache
def library():
    """The loaded kernel library (built at first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ktt_error_string.argtypes = (ctypes.c_int,)
    lib.ktt_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _stream_getter():
    import torch
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get if get is not None else \
        (lambda i: torch.cuda.current_stream(i).cuda_stream)


def current_stream(index):
    """The raw handle of the current CUDA stream of device ``index``, by
    one lookup (PyTorch's own getter where it has one)."""
    return _stream_getter()(index)


def check(err, name):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().ktt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
