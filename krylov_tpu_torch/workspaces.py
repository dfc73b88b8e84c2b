"""Workspaces and their accessors (counterpart of
``krylov_tpu/workspaces.py``, reference src/krylov_workspaces.jl and
src/workspace_accessors.jl).

A ``KrylovWorkspace`` carries the method name and its solve-time
configuration, the last solve's state (the solver core's tensors, so
internals such as ``npc_dir`` stay reachable, like the reference's
workspace fields), the last stats object and a pending warm-start guess
set by ``warm_start(ws, x0[, y0])``.  ``METHOD_TABLE`` is the reference's
per-method (nsol, nA, nAt, warm) table (src/workspace_accessors.jl:
101-139) for all 39 methods, each resolved to its solver; a method
missing from the port would raise ``NotImplementedError`` naming the
item of ROADMAP.md Queue 1 that ports it (``_QUEUE_ITEM``, empty now
that all 39 are ported).
"""

import functools

import torch

from .solvers import bicgstab as _bicgstab
from .solvers import bilq as _bilq
from .solvers import block as _block
from .solvers import cg as _cg
from .solvers import cg_lanczos as _cg_lanczos
from .solvers import cgls as _cgls
from .solvers import cgne as _cgne
from .solvers import cr as _cr
from .solvers import craig as _craig
from .solvers import fom as _fom
from .solvers import gpmr as _gpmr
from .solvers import gmres as _gmres
from .solvers import lslq as _lslq
from .solvers import lsmr as _lsmr
from .solvers import lsqr as _lsqr
from .solvers import minares as _minares
from .solvers import minres as _minres
from .solvers import minres_qlp as _minres_qlp
from .solvers import symmlq as _symmlq
from .solvers import tricg as _tricg
from .solvers import usymlq as _usymlq

# method -> (nsol, nA, nAt, warm_start_allowed, needs_c, two_operators)
METHOD_TABLE = {
    "cg": (1, 1, 0, True, False, False),
    "cr": (1, 1, 0, True, False, False),
    "car": (1, 1, 0, True, False, False),
    "cg_lanczos": (1, 1, 0, True, False, False),
    "cg_lanczos_shift": (1, 1, 0, False, False, False),
    "symmlq": (1, 1, 0, True, False, False),
    "minres": (1, 1, 0, True, False, False),
    "minres_qlp": (1, 1, 0, True, False, False),
    "minares": (1, 1, 0, True, False, False),
    "cgs": (1, 2, 0, True, False, False),
    "bicgstab": (1, 2, 0, True, False, False),
    "bilq": (1, 1, 1, True, False, False),
    "qmr": (1, 1, 1, True, False, False),
    "bilqr": (2, 1, 1, True, True, False),
    "diom": (1, 1, 0, True, False, False),
    "fom": (1, 1, 0, True, False, False),
    "dqgmres": (1, 1, 0, True, False, False),
    "gmres": (1, 1, 0, True, False, False),
    "fgmres": (1, 1, 0, True, False, False),
    "cgls": (1, 1, 1, False, False, False),
    "cgls_lanczos_shift": (1, 1, 1, False, False, False),
    "crls": (1, 1, 1, False, False, False),
    "lslq": (1, 1, 1, False, False, False),
    "lsqr": (1, 1, 1, False, False, False),
    "lsmr": (1, 1, 1, False, False, False),
    "cgne": (1, 1, 1, False, False, False),
    "crmr": (1, 1, 1, False, False, False),
    "lnlq": (2, 1, 1, False, False, False),
    "craig": (2, 1, 1, False, False, False),
    "craigmr": (2, 1, 1, False, False, False),
    "usymlq": (1, 1, 1, True, True, False),
    "usymqr": (1, 1, 1, True, True, False),
    "usymlqr": (2, 1, 1, True, True, False),
    "trilqr": (2, 1, 1, True, True, False),
    "tricg": (2, 1, 1, True, True, False),
    "trimr": (2, 1, 1, True, True, False),
    "gpmr": (2, 1, 0, True, True, True),
    "block_minres": (1, 1, 0, True, False, False),
    "block_gmres": (1, 1, 0, True, False, False),
}

# the ported methods: (the solve returning (x, stats, state), the public
# wrapper, which takes ``precision``)
_PORTED = {
    "cg": (_cg._cg_solve, _cg.cg),
    "cr": (_cr._cr_solve, _cr.cr),
    "car": (_cr._car_solve, _cr.car),
    "cg_lanczos": (_cg_lanczos._cg_lanczos_solve, _cg_lanczos.cg_lanczos),
    "cg_lanczos_shift": (_cg_lanczos._cg_lanczos_shift_solve,
                         _cg_lanczos.cg_lanczos_shift),
    "symmlq": (_symmlq._symmlq_solve, _symmlq.symmlq),
    "minres": (_minres._minres_solve, _minres.minres),
    "minres_qlp": (_minres_qlp._minres_qlp_solve, _minres_qlp.minres_qlp),
    "minares": (_minares._minares_solve, _minares.minares),
    "gmres": (functools.partial(_gmres._gmres_like_solve, False),
              _gmres.gmres),
    "fgmres": (functools.partial(_gmres._gmres_like_solve, True),
               _gmres.fgmres),
    "fom": (_fom._fom_solve, _fom.fom),
    "bicgstab": (_bicgstab._bicgstab_solve, _bicgstab.bicgstab),
    "cgs": (_bicgstab._cgs_solve, _bicgstab.cgs),
    "diom": (functools.partial(_fom._trunc_solve, "diom"), _fom.diom),
    "dqgmres": (functools.partial(_fom._trunc_solve, "dqgmres"),
                _fom.dqgmres),
    "bilq": (_bilq._bilq_solve, _bilq.bilq),
    "qmr": (_bilq._qmr_solve, _bilq.qmr),
    "bilqr": (_bilq._bilqr_solve, _bilq.bilqr),
    "usymlq": (_usymlq._usymlq_solve, _usymlq.usymlq),
    "usymqr": (_usymlq._usymqr_solve, _usymlq.usymqr),
    "trilqr": (_usymlq._trilqr_solve, _usymlq.trilqr),
    "usymlqr": (_usymlq._usymlqr_solve, _usymlq.usymlqr),
    "lsqr": (_lsqr._lsqr_solve, _lsqr.lsqr),
    "lsmr": (_lsmr._lsmr_solve, _lsmr.lsmr),
    "lslq": (_lslq._lslq_solve, _lslq.lslq),
    "cgne": (_cgne._cgne_solve, _cgne.cgne),
    "crmr": (_cgne._crmr_solve, _cgne.crmr),
    "craig": (_craig._craig_solve, _craig.craig),
    "craigmr": (_craig._craigmr_solve, _craig.craigmr),
    "lnlq": (_craig._lnlq_solve, _craig.lnlq),
    "cgls": (_cgls._cgls_solve, _cgls.cgls),
    "crls": (_cgls._crls_solve, _cgls.crls),
    "cgls_lanczos_shift": (_cgls._cgls_lanczos_shift_solve,
                           _cgls.cgls_lanczos_shift),
    "tricg": (_tricg._tricg_solve, _tricg.tricg),
    "trimr": (_tricg._trimr_solve, _tricg.trimr),
    "gpmr": (_gpmr._gpmr_solve, _gpmr.gpmr),
    "block_minres": (_block._block_minres_solve, _block.block_minres),
    "block_gmres": (_block._block_gmres_solve, _block.block_gmres),
}

# the ROADMAP.md Queue 1 item that ports each other method (none left)
_QUEUE_ITEM = {}


def _resolve(method):
    """(solve, public wrapper) of a ported method; raises for the rest."""
    if method in _PORTED:
        return _PORTED[method]
    raise NotImplementedError(
        f"{method} is not ported yet (ROADMAP.md Queue 1 item "
        f"{_QUEUE_ITEM[method]})")


def state_tensors(state):
    """(name, tensor) of each tensor of a solver state, whatever its
    container: a NamedTuple, a SimpleNamespace or a dict."""
    if state is None:
        return []
    if hasattr(state, "_asdict"):
        items = state._asdict().items()
    elif isinstance(state, dict):
        items = state.items()
    else:
        items = vars(state).items()
    return [(k, v) for k, v in items if isinstance(v, torch.Tensor)]


class KrylovConstructor:
    """Prototype-vector workspace allocator (reference
    krylov_workspaces.jl:36-54).

    Holds prototype vectors ``vm`` (length m, the b-side) and ``vn``
    (length n, the c-side; defaults to ``vm``) from which workspaces take
    their problem dimensions and dtype.  The solves themselves place
    their data where their operands lie.
    """

    def __init__(self, vm, vn=None):
        self.vm = torch.as_tensor(vm)
        self.vn = self.vm if vn is None else torch.as_tensor(vn)

    @property
    def m(self):
        return self.vm.shape[0]

    @property
    def n(self):
        return self.vn.shape[0]

    @property
    def dtype(self):
        return self.vm.dtype


class KrylovWorkspace:
    """Reusable solve context for one method (reference XyzWorkspace)."""

    def __init__(self, method, m=None, n=None, dtype=None, **config):
        if isinstance(method, KrylovConstructor):
            raise ValueError(
                "pass the method name first: "
                "KrylovWorkspace('cg', KrylovConstructor(...))")
        if isinstance(m, KrylovConstructor):
            kc = m
            m, n, dtype = kc.m, kc.n, kc.dtype
        if method not in METHOD_TABLE:
            raise ValueError(f"unknown Krylov method: {method!r}")
        self.method = method
        self.m = m
        self.n = n
        self.dtype = dtype
        self.config = config          # construction-time options
        self.nsol, self.nA, self.nAt, self.warm_allowed, self.needs_c, \
            self.two_ops = METHOD_TABLE[method]
        self._solver, self._public = _resolve(method)
        self._x0 = None
        self._y0 = None
        self.stats = None
        self.state = None
        self.x = None
        self.y = None

    def solve(self, A, b, *args, **kwargs):
        """In-place-style solve (the reference's xyz!(workspace, ...))."""
        kw = dict(self.config)
        kw.update(kwargs)
        pos = list(args)
        if self._x0 is not None and self.warm_allowed:
            if self.nsol == 2 and self._y0 is not None:
                pos = pos + [self._x0, self._y0]
            else:
                pos = pos + [self._x0]
            self._x0 = self._y0 = None
        if kw.get("precision") not in (None, "working"):
            # precision= other than "working" lives in the public wrappers
            # (double_word raises there until it is ported); such solves
            # keep no state
            out = self._public(A, b, *pos, **kw) + (None,)
        else:
            out = self._solver(A, b, *pos, **kw)
        if len(out) == 4:
            self.x, self.y, self.stats, self.state = out
        else:
            self.x, self.stats, self.state = out
            self.y = None
        return self

    def __getattr__(self, name):
        # Fall through to solver-state fields (npc_dir, rNorm, ...).
        state = self.__dict__.get("state")
        if state is not None and hasattr(state, name):
            return getattr(state, name)
        raise AttributeError(name)

    def __repr__(self):
        lines = [f"{type(self).__name__}(method={self.method!r})"]
        if self.stats is not None:
            lines.append(f"  niter: {self.stats.niter}")
            lines.append(f"  status: {self.stats.status!r}")
        if self.state is not None:
            total = sum(t.numel() * t.element_size()
                        for _, t in state_tensors(self.state))
            lines.append(f"  state storage: {total} bytes")
        return "\n".join(lines)


class BlockKrylovWorkspace(KrylovWorkspace):
    """Supertype of the block-method workspaces (reference
    src/block_krylov_workspaces.jl): ``BlockMinresWorkspace`` and
    ``BlockGmresWorkspace`` subclass it."""


# Generated per-method workspace classes (CgWorkspace, MinresWorkspace, ...)
def _make_ws_class(method):
    cname = "".join(w.capitalize() for w in method.split("_")) + "Workspace"

    def __init__(self, *shape_args, **config):
        m = n = dtype = None
        if len(shape_args) >= 1 and isinstance(shape_args[0],
                                               KrylovConstructor):
            kc = shape_args[0]
            m, n, dtype = kc.m, kc.n, kc.dtype
        elif len(shape_args) >= 2 and all(isinstance(a, int)
                                          for a in shape_args[:2]):
            m, n = shape_args[:2]
            if len(shape_args) >= 3:
                dtype = shape_args[2]
        elif len(shape_args) >= 1:
            A = shape_args[0]
            if hasattr(A, "shape") and A.shape is not None:
                m, n = A.shape[0], A.shape[-1]
            if len(shape_args) >= 2 and hasattr(shape_args[1], "dtype"):
                dtype = shape_args[1].dtype
        KrylovWorkspace.__init__(self, method, m, n, dtype, **config)

    base = (BlockKrylovWorkspace if method.startswith("block_")
            else KrylovWorkspace)
    return cname, type(cname, (base,), {"__init__": __init__})


for _method in METHOD_TABLE:
    _name, _cls = _make_ws_class(_method)
    globals()[_name] = _cls


# -- accessors (reference src/workspace_accessors.jl) -----------------------

def solution(ws, index=None):
    """x (or (x, y) for two-output methods; index selects one)."""
    if ws.nsol == 2:
        if index is not None:
            return (ws.x, ws.y)[index - 1]
        return ws.x, ws.y
    if index not in (None, 1):
        raise ValueError(f"{ws.method} returns only one solution")
    return ws.x


def statistics(ws):
    return ws.stats


def results(ws):
    """(solution..., stats): what the out-of-place API returns."""
    if ws.nsol == 2:
        return ws.x, ws.y, ws.stats
    return ws.x, ws.stats


def issolved(ws):
    st = ws.stats
    if hasattr(st, "solved_primal"):
        return st.solved_primal and st.solved_dual
    return bool(st.solved)


def issolved_primal(ws):
    return bool(ws.stats.solved_primal)


def issolved_dual(ws):
    return bool(ws.stats.solved_dual)


def iteration_count(ws):
    return ws.stats.niter


def Aprod_count(ws):
    return ws.nA * ws.stats.niter


def Atprod_count(ws):
    return ws.nAt * ws.stats.niter


def Bprod_count(ws):
    """gpmr only: one B product per iteration."""
    return ws.stats.niter


def elapsed_time(ws):
    return ws.stats.timer


def warm_start(ws, x0, y0=None):
    """Register an initial guess for the next solve (reference
    warm_start!)."""
    if not ws.warm_allowed:
        raise ValueError(f"{ws.method} does not support warm starts")
    ws._x0 = x0
    ws._y0 = y0
    return ws
