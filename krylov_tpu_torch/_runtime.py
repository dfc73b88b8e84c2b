"""Solver-loop runtime (counterpart of ``krylov_tpu/_runtime.py``).

* A solver core advances a state of tensors whose int32 fields
  ``status`` and ``iter`` say whether it is still running.  Every
  data-dependent exit writes a nonzero status code on the device; the
  host decodes it into the reference's status strings after the solve.

* PyTorch runs eagerly, so there is no traced ``while_loop``.  ``drive``
  runs the core in chunks of ``chunk`` iterations.  Inside a chunk the
  core takes every step with its updates masked by
  ``status == RUNNING and iter < cap``, so the host never waits for the
  device inside a chunk; it reads the status once per chunk.  A frozen
  state stays bit-for-bit what it was, so niter is exact.  With a user
  callback the host reads ``active`` before each step instead and ends
  the chunk at the first inactive one (``take_steps``), so the callback
  sees exactly the iterations the JAX package's ``while_loop`` runs.

* ``history=True`` preallocates an (itmax+1,) buffer that the core writes
  at index ``iter``; the host trims it to ``niter+1``.
"""

import contextlib
import math
import time

import torch

from . import stats as _stats
from ._dtypes import sqrt_eps
from .ops.dia import resolve_device

# ---------------------------------------------------------------------------
# status codes (device-side int32) → reference status strings (host-side)
# ---------------------------------------------------------------------------

RUNNING = 0
SOLVED = 1
ZERO_RESIDUAL = 2
NPC = 3
ON_BOUNDARY = 4
ZERO_CURVATURE = 5
USER_EXIT = 6
BREAKDOWN = 7
INCONSISTENT = 8
SOLVED_AR = 9          # least-squares solution found (‖Aᴴr‖ criterion)
SOLVED_X = 10          # minimum-norm solution found
COND_EXCEEDED = 11
ERR_BOUND = 12         # forward-error bound small enough (etol-type stops)
XBIG = 13              # truncated step / solution too large (lslq utol)
NONPOSDEF = 14         # operator not positive definite (informational exits)
SOLVED_PRIMAL_DUAL = 15
BREAKDOWN_BETA = 16    # solver-specific breakdown variants
BREAKDOWN_RHO = 17
SOLVED_CG_POINT = 18
SOLVED_LSQ = 20        # "found approximate minimum least-squares solution"
SOLVED_ZERO = 21       # "found approximate zero-residual solution"
FWD_ERR = 22           # "truncated forward error small enough"
ILL_COND_MACH = 23     # "condition number seems too large for this machine"
MIN_LSQ_X = 24         # "x is a minimum least-squares solution"
# host-assigned:
TIRED = 100
OVERTIMED = 101

BASE_STATUS = {
    RUNNING: _stats.UNKNOWN,
    SOLVED: _stats.SOLVED,
    ZERO_RESIDUAL: _stats.ZERO_RESIDUAL,
    NPC: _stats.NPC,
    ON_BOUNDARY: _stats.ON_BOUNDARY,
    ZERO_CURVATURE: _stats.ZERO_CURVATURE,
    USER_EXIT: _stats.USER_EXIT,
    BREAKDOWN: "breakdown",
    INCONSISTENT: _stats.INCONSISTENT,
    SOLVED_AR: _stats.SOLVED_AR,
    SOLVED_X: _stats.SOLVED_X,
    COND_EXCEEDED: "condition number exceeds tolerance",
    ERR_BOUND: "error bound small enough",
    SOLVED_LSQ: "found approximate minimum least-squares solution",
    SOLVED_ZERO: "found approximate zero-residual solution",
    FWD_ERR: "truncated forward error small enough",
    ILL_COND_MACH: "condition number seems too large for this machine",
    MIN_LSQ_X: "x is a minimum least-squares solution",
    TIRED: _stats.TIRED,
    OVERTIMED: _stats.OVERTIMED,
}


def decode_status(code, overrides=None):
    """Map a device status code to the reference's status string."""
    code = int(code)
    if overrides and code in overrides:
        return overrides[code]
    return BASE_STATUS.get(code, _stats.UNKNOWN)


def is_solved_code(code):
    return int(code) in (
        SOLVED, ZERO_RESIDUAL, NPC, ON_BOUNDARY, SOLVED_AR, SOLVED_X,
        ERR_BOUND, SOLVED_PRIMAL_DUAL, SOLVED_CG_POINT,
        SOLVED_LSQ, SOLVED_ZERO, FWD_ERR, MIN_LSQ_X,
    )


# ---------------------------------------------------------------------------
# tolerances & history
# ---------------------------------------------------------------------------

def as_device_tensor(v, like):
    """``v`` as a tensor on the device of ``like`` (an operator, or a
    tensor already placed).

    A tensor stays where it is.  Anything else goes to ``like.device``,
    the device of the operator's data; where the operator holds no
    tensor (``device`` is None, as for a FunctionOperator), it goes to
    the card, and raises when there is none: an entry point never falls
    back to the CPU on its own.
    """
    if isinstance(v, torch.Tensor):
        return v
    device = getattr(like, "device", None)
    if device is None:
        device = resolve_device("cuda")
    return torch.as_tensor(v, device=device)


def default_tol(tol, dtype):
    """atol/rtol default to √eps(T) of the real dtype (reference kwargs)."""
    return sqrt_eps(dtype) if tol is None else float(tol)


def resolve_itmax(itmax, default):
    """itmax=0 means the per-solver default (e.g. 2n for CG)."""
    itmax = int(itmax)
    return default if itmax == 0 else itmax


def hist_init(hist_len, dtype, device):
    """Preallocated history buffer (NaN-filled; trimmed on host)."""
    return torch.full((max(hist_len, 1),), float("nan"), dtype=dtype,
                      device=device)


def hist_write(hist, idx, value, enabled):
    """hist[idx] = value when history is on, in place (unlike the JAX
    package's functional update): idx and value are 0-d device tensors,
    so the host does not wait for the device."""
    if enabled:
        hist.index_put_((idx.reshape(1).long(),),
                        value.reshape(1).to(hist.dtype))
    return hist


def hist_write_masked(hist, active, idx, value, enabled):
    """hist[idx] = value where ``active``; an inactive step writes
    hist[0] back unchanged, so its idx may lie past the buffer's end."""
    if enabled:
        i = torch.where(active, idx, torch.zeros_like(idx))
        hist_write(hist, i, torch.where(active, value.to(hist.dtype),
                                        hist[i.long()]), True)
    return hist


def hist_trim(hist, niter):
    """The first niter+1 entries of the history buffer, on the host."""
    return hist[: int(niter) + 1].cpu().numpy()


# ---------------------------------------------------------------------------
# the chunked solve loop
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in IEEE fp32, not TF32.

    The counterpart of ``jax.default_matmul_precision("highest")``: a
    TF32 product keeps about three decimal digits, which would floor a
    solve of a dense (``MatrixOperator``) system near 1e-3.  PyTorch's
    matmul default is already fp32, but cuDNN's is TF32, and a caller
    may have switched either; both flags are set for the duration and
    restored after.
    """
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def drive(run, itmax, timemax, start_time=None, chunk=64):
    """Run ``state = run(state_or_none, cap, steps)`` to completion.

    ``run`` takes ``steps`` masked iterations with the iteration cap
    ``cap`` and returns a state with 0-d int32 tensors ``status`` and
    ``iter``.  The host reads the status once per chunk of ``chunk``
    iterations, and checks the wall clock there when ``timemax`` is
    finite.  Returns (state, overtimed: bool).
    """
    if start_time is None:
        start_time = time.perf_counter()
    with full_fp32():
        cap = 0
        state = None
        while True:
            prev, cap = cap, min(cap + chunk, itmax)
            state = run(state, cap, cap - prev)
            if int(state.status) != RUNNING or cap >= itmax:
                return state, False
            if (math.isfinite(timemax)
                    and time.perf_counter() - start_time > timemax):
                return state, True


def take_steps(body, state, steps, iter_cap, callback=None):
    """``steps`` calls of ``state = body(state)``, each of which masks its
    updates by ``status == RUNNING and iter < iter_cap`` on the device.

    With a ``callback`` (the user's, which ``body`` calls) the host reads
    that condition before each step and stops at the first inactive one,
    so the callback never sees a masked step; without one the host never
    waits for the device here."""
    for _ in range(steps):
        if callback is not None and not bool(
                (state.status == RUNNING) & (state.iter < iter_cap)):
            break
        state = body(state)
    return state


def final_status_code(state_status, niter, itmax, overtimed):
    """Host-side: RUNNING after the loop means tired or overtimed."""
    code = int(state_status)
    if code == RUNNING:
        code = OVERTIMED if overtimed else TIRED
    return code


# ---------------------------------------------------------------------------
# verbose display
# ---------------------------------------------------------------------------

def debug_header(verbose, text):
    if verbose > 0:
        print(text, flush=True)


def debug_table(verbose, name, cols, m, n=None):
    """Problem line and column labels (reference per-solver tables, e.g.
    src/cg.jl:132,182), as krylov_tpu prints them."""
    if verbose > 0:
        if n is None or m == n:
            print(f"{name}: system of size {m}", flush=True)
        else:
            print(f"{name}: system of {m} equations in {n} variables",
                  flush=True)
        print("  ".join(f"{c:>7s}" for c in cols), flush=True)


def debug_row(verbose, iter_, fmt, *values):
    """Per-iteration display every `verbose` iterations (reference
    kdisplay, krylov_utils.jl:301).  Reads the values on the host, so it
    waits for the device; it is only reached with verbose > 0."""
    if verbose > 0 and int(iter_) % verbose == 0:
        print(fmt.format(int(iter_), *(float(v) for v in values)),
              flush=True)


def debug_row_vals(verbose, gate_iter, fmt, *values):
    """Like ``debug_row``, but the cadence gate and the printed values are
    independent: for tables whose leading column is not the iteration
    count (block GMRES prints the pass first, reference
    src/block_gmres.jl:181).  The values are Python numbers."""
    if verbose > 0 and int(gate_iter) % verbose == 0:
        print(fmt.format(*values), flush=True)
