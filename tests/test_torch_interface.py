"""The port's generic interface and workspaces against krylov_tpu's
(tests/test_interface.py, tests/test_storage.py and
tests/test_stats_show.py for the methods the port has).

Inputs are made with numpy from a seed (or the fixture generators) and
given to both packages.  Tolerances: in f64 the status string and niter
are equal and x agrees to 1e-8 relative (reductions are summed in
another order).  All 39 methods are ported; a method the port lacked
would raise ``NotImplementedError`` naming its item of ROADMAP.md Queue
1 when its workspace is built.
"""

import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import fixtures as fx
import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu import workspaces as jws
from krylov_tpu_torch import workspaces as tws

PORTED = ("cg", "cr", "car", "cg_lanczos", "cg_lanczos_shift", "symmlq",
          "minres", "minres_qlp", "minares", "gmres", "fgmres", "fom",
          "bicgstab", "cgs", "diom", "dqgmres", "bilq", "qmr", "bilqr",
          "usymlq", "usymqr", "trilqr", "usymlqr", "lsqr", "lsmr", "lslq",
          "cgne", "crmr", "craig", "craigmr", "lnlq", "cgls", "crls",
          "cgls_lanczos_shift", "tricg", "trimr", "gpmr", "block_minres",
          "block_gmres")
# the ROADMAP.md Queue 1 item that ports each other method: none is left
QUEUE_ITEM = {}
SHIFTS = [0.0, 1.0]
N_, NSH, MEM = 10, 2, 5
# element budgets for the large tensors (size ≥ n) of each state, copied
# from tests/test_storage.py:35-57 (reference docs/src/storage.md:50-80)
BUDGETS = {
    "cg": lambda n: 4 * n,
    "cr": lambda n: 5 * n,
    "car": lambda n: 7 * n,
    "cg_lanczos": lambda n: 5 * n,
    "cg_lanczos_shift": lambda n: 3 * n + 2 * n * NSH + 5 * NSH,
    "symmlq": lambda n: 6 * n,
    "minres": lambda n: 6 * n,
    "minres_qlp": lambda n: 6 * n,
    "minares": lambda n: 8 * n,
    "cgs": lambda n: 6 * n,
    "bicgstab": lambda n: 6 * n,
    "fom": lambda n: (MEM + 3) * n + (MEM + 2) ** 2,
    "gmres": lambda n: (MEM + 3) * n + (MEM + 2) ** 2,
    "fgmres": lambda n: (2 * MEM + 3) * n + (MEM + 2) ** 2,
    "diom": lambda n: (2 * MEM + 1) * n + 4 * MEM,
    "dqgmres": lambda n: (2 * MEM + 2) * n + 4 * MEM,
    "bilq": lambda n: 8 * n,
    "qmr": lambda n: 9 * n,
    "bilqr": lambda n: 10 * n,
    # tests/test_storage.py:52-76 with m = n
    "usymlq": lambda n: 8 * n,
    "usymqr": lambda n: 9 * n,
    "trilqr": lambda n: 10 * n,
    "usymlqr": lambda n: 11 * n,
    # tests/test_storage.py:63-65 with m = n
    "lsqr": lambda n: 4 * n + 3 * n,
    "lsmr": lambda n: 5 * n + 3 * n,
    "lslq": lambda n: 4 * n + 3 * n,
    # tests/test_storage.py:68-72 with m = n
    "cgne": lambda n: 3 * n + 2 * n,
    "crmr": lambda n: 3 * n + 2 * n,
    "lnlq": lambda n: 4 * n + 4 * n,
    "craig": lambda n: 4 * n + 4 * n,
    "craigmr": lambda n: 5 * n + 5 * n,
    # tests/test_storage.py:64-66, 77 with m = n
    "cgls": lambda n: 3 * n + 2 * n,
    "cgls_lanczos_shift": lambda n: (3 + NSH) * n + 2 * n + 5 * NSH,
    "crls": lambda n: 4 * n + 3 * n,
    "tricg": lambda n: 6 * n + 6 * n,
    # tests/test_storage.py:78-82 with m = n, GPMR at itmax = 12 and block
    # MINRES at p = 2
    "trimr": lambda n: 8 * n + 8 * n,
    "gpmr": lambda n: (12 + 1) * (n + n) + (2 * 12 + 2) ** 2 + 8 * 12,
    "block_minres": lambda n: 7 * n * 2 + 12 * 2 * 2,
    # tests/test_storage.py:83-90 with p = 2: the basis and X, the
    # transformed Hessenberg and the accumulated QR factor, the rhs
    "block_gmres": lambda n: (MEM + 2) * n * 2 + 2 * ((MEM + 1) * 2) ** 2
    + (MEM + 1) * 2 * 2,
}
# the memory the ring methods' budgets are for (tests/test_storage.py:91-97)
EXTRA_KW = {**dict.fromkeys(("fom", "gmres", "fgmres", "block_gmres"),
                            {"memory": MEM, "restart": True}),
            **dict.fromkeys(("diom", "dqgmres"), {"memory": MEM}),
            "gpmr": {"itmax": 12}}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _system(n=20):
    A, b = fx.symmetric_definite(n=n)
    return np.asarray(A), np.asarray(b)


# the methods that take c after b
NEEDS_C = ("bilqr", "usymlq", "usymqr", "trilqr", "usymlqr", "tricg",
           "trimr")
# the methods that take the shifts after b
SHIFTED = ("cg_lanczos_shift", "cgls_lanczos_shift")


def _extra(method, b=None):
    """The arguments after b: the shifts, or c (here b again)."""
    if method in SHIFTED:
        return (SHIFTS,)
    return (b,) if method in NEEDS_C else ()


def _args(method, A, b):
    """A method's arguments after its name: (A, b, ...) with _extra's
    tail; GPMR's (A, B, b, c) with B = Aᴴ and c = b; block MINRES's and
    block GMRES's (A, B) with B = [b, 1]."""
    if method == "gpmr":
        return (A, A.T, b, b)
    if method in ("block_minres", "block_gmres"):
        return (A, np.stack([np.asarray(b), np.ones(len(b))], axis=1))
    return (A, b) + _extra(method, b)


def test_method_table_is_the_reference_table():
    assert kt.METHOD_TABLE == kj.METHOD_TABLE
    assert kt.KRYLOV_METHODS == kj.KRYLOV_METHODS
    assert set(PORTED) | set(QUEUE_ITEM) == set(kt.METHOD_TABLE)


@pytest.mark.parametrize("method", PORTED)
def test_krylov_solve_matches_jax(method):
    A, b = _system()
    args = _args(method, A, b)
    targs = tuple(torch.as_tensor(a) if getattr(a, "ndim", 1) == 2 else a
                  for a in args)
    *xj, sj = kj.krylov_solve(method, *args)
    *xt, st = kt.krylov_solve(method, *targs)
    assert st.status == sj.status and st.niter == sj.niter
    assert st.solved == sj.solved
    for vt, vj in zip(xt, xj):
        assert _rel(vt.numpy(), vj) <= 1e-8
    *xd, sd = getattr(kt, method)(*targs)
    assert sd.niter == st.niter
    assert all(torch.equal(vd, vt) for vd, vt in zip(xd, xt))


@pytest.mark.parametrize("method", ["block_gmres"])
def test_unported_method_raises_naming_its_queue_item(method):
    """The last method of Queue 1 (item 7b) is ported: its workspace
    builds, and krylov_solve through it equals the direct call; no method
    is left to raise."""
    A, b = _system()
    B = np.stack([b, np.ones(len(b))], axis=1)
    assert kt.krylov_workspace(method).method == method
    X, st = kt.krylov_solve(method, torch.as_tensor(A), B)
    Xd, sd = getattr(kt, method)(torch.as_tensor(A), B)
    assert (st.status, st.niter) == (sd.status, sd.niter) and st.solved
    assert torch.equal(X, Xd)
    assert QUEUE_ITEM == tws._QUEUE_ITEM == {}


def test_unknown_method_and_workspace_classes():
    with pytest.raises(ValueError, match="unknown Krylov method"):
        kt.krylov_workspace("not_a_method")
    A, b = _system()
    ws = tws.MinresQlpWorkspace(torch.as_tensor(A), torch.as_tensor(b))
    assert (ws.m, ws.n, ws.dtype) == (20, 20, torch.float64)
    kc = kt.KrylovConstructor(torch.as_tensor(b))
    ws = kt.KrylovWorkspace("minares", kc)
    assert (ws.m, ws.n, ws.dtype) == (20, 20, torch.float64)
    assert issubclass(tws.BlockMinresWorkspace, kt.BlockKrylovWorkspace)
    assert (tws.BlockMinresWorkspace(4, 4).m, tws.BlockMinresWorkspace(
        4, 4).n) == (4, 4)
    assert issubclass(tws.BlockGmresWorkspace, kt.BlockKrylovWorkspace)
    assert (tws.BlockGmresWorkspace(4, 4).m, tws.BlockGmresWorkspace(
        4, 4).n) == (4, 4)


@pytest.mark.parametrize("method", ["cg", "minres_qlp", "minares"])
def test_workspace_accessors_match_jax(method):
    A, b = _system(30)
    wj = kj.krylov_workspace(method, A, b)
    wt = kt.krylov_workspace(method, torch.as_tensor(A), b)
    kj.krylov_solve_inplace(wj, A, b)
    kt.krylov_solve_inplace(wt, torch.as_tensor(A), b)
    assert kt.issolved(wt) == kj.issolved(wj)
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert kt.Aprod_count(wt) == kj.Aprod_count(wj)
    assert kt.Atprod_count(wt) == kj.Atprod_count(wj) == 0
    assert kt.elapsed_time(wt) > 0
    assert kt.statistics(wt).status == kj.statistics(wj).status
    x, stats = kt.results(wt)
    assert stats is kt.statistics(wt) and x is kt.solution(wt)
    assert _rel(kt.solution(wt).numpy(), kj.solution(wj)) <= 1e-8
    with pytest.raises(ValueError, match="only one solution"):
        kt.solution(wt, 2)
    assert wt.rNorm is not None and "state storage" in repr(wt)
    # a warm start from half the solution, then a second system
    x0 = 0.5 * np.asarray(kj.solution(wj))
    kj.warm_start(wj, x0)
    kt.warm_start(wt, x0)
    kj.krylov_solve_inplace(wj, A, b)
    kt.krylov_solve_inplace(wt, torch.as_tensor(A), b)
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert _rel(kt.solution(wt).numpy(), kj.solution(wj)) <= 1e-8
    assert wt._x0 is None
    kt.krylov_solve_inplace(wt, torch.as_tensor(2.0 * A), b)
    kj.krylov_solve_inplace(wj, 2.0 * A, b)
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    assert _rel(kt.solution(wt).numpy(), kj.solution(wj)) <= 1e-8


def test_bilqr_workspace_accessors_match_jax():
    """A BiLQR workspace: two solutions, the primal and dual flags, one A
    and one Aᴴ product per iteration, and a warm start from (x0, y0)."""
    A, b, c = fx.square_adjoint(n=20)
    wj = kj.krylov_workspace("bilqr", A, b)
    wt = kt.krylov_workspace("bilqr", torch.as_tensor(A), b)
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, torch.as_tensor(A), b, c)
    st, sj = kt.statistics(wt), kj.statistics(wj)
    assert isinstance(st, kt.AdjointStats)
    assert (st.status, st.niter) == (sj.status, sj.niter)
    assert kt.issolved(wt) == kj.issolved(wj) == st.solved
    assert kt.issolved_primal(wt) == jws.issolved_primal(wj)
    assert kt.issolved_dual(wt) == jws.issolved_dual(wj)
    assert kt.Aprod_count(wt) == kt.Atprod_count(wt) == st.niter \
        == kj.Atprod_count(wj)
    x, y = kt.solution(wt)
    assert kt.solution(wt, 1) is x and kt.solution(wt, 2) is y
    assert kt.results(wt) == (x, y, st)
    for vt, vj in zip((x, y), kj.solution(wj)):
        assert _rel(vt.numpy(), vj) <= 1e-10
    kj.warm_start(wj, 0.5 * np.asarray(x), 0.5 * np.asarray(y))
    kt.warm_start(wt, 0.5 * x, 0.5 * y)
    kj.krylov_solve_inplace(wj, A, b, c)
    kt.krylov_solve_inplace(wt, torch.as_tensor(A), b, c)
    assert kt.iteration_count(wt) == kj.iteration_count(wj)
    for vt, vj in zip(kt.solution(wt), kj.solution(wj)):
        assert _rel(vt.numpy(), vj) <= 1e-10
    assert wt._x0 is None and wt._y0 is None


def test_warm_start_refused_and_double_word_through_the_workspace():
    A, b = _system()
    with pytest.raises(ValueError, match="does not support warm starts"):
        kt.warm_start(kt.krylov_workspace("cg_lanczos_shift"), b)
    ws = kt.krylov_workspace("minres_qlp", precision="double_word")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        kt.krylov_solve_inplace(ws, torch.as_tensor(A), b)
    x, st = kt.krylov_solve("cg", torch.as_tensor(A), b,
                            precision="compensated")
    assert st.solved


@pytest.mark.parametrize("method", ["cg_lanczos", "cg_lanczos_shift",
                                    "symmlq", "minres_qlp", "bilqr",
                                    "usymqr", "trilqr", "usymlqr", "lsmr",
                                    "lslq", "lnlq"])
def test_show_stats_matches_jax(method):
    """The port's stats classes render as the JAX package's do, field for
    field, given the same values."""
    A, b = _system()
    *_, sj = kj.krylov_solve(method, A, b, *_extra(method, b),
                             history=True)
    port_cls = getattr(kt, type(sj).__name__)
    st = port_cls(**{f.name: getattr(sj, f.name)
                     for f in dataclasses.fields(sj)})
    assert kt.show_stats(st) == kj.show_stats(sj)


def test_show_workspace_and_kstdout():
    A, b = _system()
    ws = kt.krylov_workspace("minres_qlp", torch.as_tensor(A), b)
    kt.krylov_solve_inplace(ws, torch.as_tensor(A), b)
    shown = kt.show_workspace(ws)
    assert "method=minres_qlp" in shown and "w_km1" in shown
    assert "architecture       CPU" in shown
    total = sum(t.numel() * t.element_size()
                for _, t in tws.state_tensors(ws.state))
    assert f"total storage      {total} bytes" in shown
    assert kt.kstdout is not None


def _storage_system(n=N_):
    """The SPD fixture of tests/fixtures.py:drive_method."""
    A = np.diag(4.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1) \
        + np.diag(-np.ones(n - 1), -1)
    b = np.random.default_rng(42).standard_normal(n)
    return torch.as_tensor(A), torch.as_tensor(b)


@pytest.mark.parametrize("method", PORTED)
def test_state_within_storage_budget(method):
    A, b = _storage_system()
    solve, _ = tws._resolve(method)
    shifts = ([0.0, 1.0],) if method in SHIFTED else ()
    if method in NEEDS_C:
        shifts = (b,)
    args = (A, b) + shifts
    if method == "gpmr":
        args = (A, A.T, b, b)
    if method in ("block_minres", "block_gmres"):
        args = (A, torch.stack([b, torch.ones_like(b)], 1))
    *_, stats, state = solve(*args, **EXTRA_KW.get(method, {}))
    assert state is not None and stats.niter > 0
    big = sum(t.numel() for _, t in tws.state_tensors(state)
              if t.numel() >= N_)
    assert big <= BUDGETS[method](N_), (method, big)
