"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, which ``ctypes`` loads.
No PyTorch header is compiled, so the build takes seconds.  The library
goes to ``build/krylov_tpu_torch/`` at the root of the checkout, beside
a stamp holding the hash of the sources and flags; changed sources
rebuild.  Nothing is built when the package is imported: the first
kernel launch builds.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
# (vector, diagonal) type pairs that every kernel takes
_PAIRS = ("f32_f32", "f32_bf16", "f32_f16", "f64_f64")
# C entry points and their argument types; every pointer and the stream
# is a c_void_p, so ctypes never cuts a 64-bit address to 32 bits.
_SIGNATURES = {
    **{f"ktt_dia_spmv_{t}": (_P, _P, _I, _P, _P, _L, _P) for t in _PAIRS},
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cu, _ = _sources()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(key)
    return LIB_PATH


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


def check(err, name):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().ktt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
