"""The generic interface (counterpart of ``krylov_tpu/interface.py``,
reference src/interface.jl).

``krylov_workspace(method, ...)`` allocates a reusable workspace;
``krylov_solve(method, A, b, ...)`` is the out-of-place solve;
``krylov_solve_inplace(ws, A, b, ...)`` re-runs a workspace in place
(the reference's ``krylov_solve!``).  Method names are strings (the
analogue of ``Val(:cg)`` dispatch).
"""

from .workspaces import METHOD_TABLE, KrylovWorkspace, results

KRYLOV_METHODS = tuple(sorted(METHOD_TABLE))


def krylov_workspace(method, *args, **config):
    """Allocate a reusable workspace for ``method``.

    Accepts (m, n), (A, b) or nothing, plus construction-time options
    (window, ...).
    """
    ws = KrylovWorkspace(method)
    if len(args) == 2 and all(isinstance(a, int) for a in args):
        ws.m, ws.n = args
    elif len(args) >= 1 and hasattr(args[0], "shape"):
        shape = args[0].shape
        if shape is not None:
            ws.m, ws.n = shape[0], shape[-1]
    ws.config.update(config)
    return ws


def krylov_solve(method, A, b, *args, **kwargs):
    """Out-of-place generic solve: returns (x, stats) or (x, y, stats)."""
    ws = KrylovWorkspace(method)
    ws.solve(A, b, *args, **kwargs)
    return results(ws)


def krylov_solve_inplace(ws, A, b, *args, **kwargs):
    """In-place generic solve on an existing workspace (krylov_solve!)."""
    return ws.solve(A, b, *args, **kwargs)
