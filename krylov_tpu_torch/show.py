"""Pretty-printing for stats and workspaces (counterpart of
``krylov_tpu/show.py``, reference src/krylov_show.jl).

``show_stats`` renders the field table of any stats object;
``show_workspace`` renders the byte size of each tensor of the last
solve's state, with the architecture (CPU or GPU) read from the tensors'
device, the analogue of the reference's table with ktypeof-based
architecture detection (src/krylov_show.jl:66-83).
"""

import dataclasses
import sys

import numpy as np
import torch

from .workspaces import state_tensors

# Default stream for verbose solver output (reference ``kstdout``,
# src/Krylov.jl:10): the reference pins Core.stdout so that redirecting
# Julia's stdout does not silence solver tables; in Python the stable
# handle is the interpreter's real stdout.
kstdout = sys.stdout


SPECIAL_FIELDS = {
    "residualscg": "residuals (cg)",
    "errorscg": "errors (cg)",
    "Anorm": "‖A‖F",
    "Acond": "κ₂(A)",
    "err_ubnds_lq": "error bound LQ",
    "err_ubnds_cg": "error bound CG",
    "npc_count": "npcCount",
}


def vec2str(x, ndisp=7):
    """Reference vec2str (src/krylov_utils.jl:163-195): %8.1e elements,
    middle elision past ndisp entries."""
    x = np.asarray(x)
    n = x.shape[0]
    nside = n if n <= ndisp else max(1, (ndisp - 1) // 2)
    s = "["
    i = 0
    while i < min(nside, n):
        s += f"{float(x[i]):8.1e} "
        i += 1
    if i < n // 2:
        s += "... "
    i = max(i, n - nside)
    while i < n:
        s += f"{float(x[i]):8.1e} "
        i += 1
    return s + "]"


def _fmt_timer(v):
    if v < 1e-3:
        return f"{1e6 * v:.2f}μs"
    if v < 1.0:
        return f"{1e3 * v:.2f}ms"
    return f"{v:.2f}s"


def _fmt_val(field, v):
    if field == "timer":
        return _fmt_timer(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, np.ndarray):
        return vec2str(v if v.dtype != bool else v.astype(float))
    if isinstance(v, list):
        return "[" + ", ".join(vec2str(e) for e in v) + "]"
    return f"{v}"


def show_stats(stats):
    """Render stats in the reference format (src/krylov_show.jl:35-59):

        SimpleStats
         niter: 0
         solved: true
         ...
         timer: 1.23s
         status: unknown
    """
    fields = [f.name for f in dataclasses.fields(stats)]
    ordered = (["niter"]
               + [f for f in fields if f not in ("niter", "timer", "status")]
               + ["timer", "status"])
    lines = [type(stats).__name__]
    for f in ordered:
        fname = SPECIAL_FIELDS.get(f, f.replace("_", " "))
        lines.append(f" {fname}: {_fmt_val(f, getattr(stats, f))}")
    return "\n".join(lines)


def _device_arch(tensor):
    """GPU for a tensor on a CUDA device, else CPU."""
    return "GPU" if tensor.device.type == "cuda" else "CPU"


def show_workspace(ws):
    lines = [f"┌ {type(ws).__name__}  method={ws.method}"]
    if ws.stats is not None:
        lines.append(f"│ {'niter':<18s} {ws.stats.niter}")
        lines.append(f"│ {'status':<18s} {ws.stats.status!r}")
    total = 0
    # the state's device; a whole-solve kernel keeps no state, so then the
    # solution's
    arch = _device_arch(ws.x) if isinstance(ws.x, torch.Tensor) else "CPU"
    for fname, t in state_tensors(ws.state):
        nbytes = t.numel() * t.element_size()
        total += nbytes
        arch = _device_arch(t)
        lines.append(f"│ {fname:<18s} {str(tuple(t.shape)):<14s} "
                     f"{nbytes} bytes")
    lines.append(f"│ {'architecture':<18s} {arch}")
    lines.append(f"│ {'total storage':<18s} {total} bytes")
    lines.append("└")
    return "\n".join(lines)
