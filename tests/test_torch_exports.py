"""The port's top level against the JAX package's: every public name of
``krylov_tpu`` that is not a module is on ``krylov_tpu_torch``, or waits
for the item of ROADMAP.md Queue 1 that ports it (``QUEUED``)."""

import types

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu as kj
import krylov_tpu_torch as kt

# the open ROADMAP.md Queue 1 item that brings each name still missing
QUEUED = {
    8: ("knorm2",),
    10: ("pipelined_cg",),
    11: ("batched_solve", "batched_solve_xy", "BatchedStats",
         "export_solver", "export_solver_xy", "load_solver"),
}


def _jax_public_names():
    return sorted(
        n for n in dir(kj)
        if (not n.startswith("_") or n == "__version__")
        and not isinstance(getattr(kj, n), types.ModuleType))


def test_every_jax_name_is_exported_or_queued():
    queued = {n for names in QUEUED.values() for n in names}
    missing = [n for n in _jax_public_names()
               if not hasattr(kt, n) and n not in queued]
    assert missing == []


def test_queue_map_names_each_missing_name_once():
    """Each queued name is a JAX name the port lacks, named under one
    open item (8, 10 and 11)."""
    names = [n for item in QUEUED.values() for n in item]
    assert len(names) == len(set(names))
    assert set(QUEUED) <= {8, 10, 11}
    jax_names = set(_jax_public_names())
    for n in names:
        assert n in jax_names and not hasattr(kt, n), n


def test_kops_workspaces_and_version_exported():
    """The six k-ops compute what the JAX package's do, every generated
    workspace class is exported, and the version string matches."""
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(50), rng.standard_normal(50)
    for name in ("kdot", "kdotr", "kdotr2"):
        assert abs(float(getattr(kt, name)(torch.as_tensor(x),
                                           torch.as_tensor(y)))
                   - float(getattr(kj, name)(x, y))) <= 1e-12
    assert abs(float(kt.knorm(torch.as_tensor(x))) - float(kj.knorm(x))) \
        <= 1e-12
    for got, want in zip(kt.roots_quadratic(*map(torch.tensor, (1.0, -3.0,
                                                                 2.0))),
                         kj.roots_quadratic(1.0, -3.0, 2.0)):
        assert abs(float(got) - float(want)) <= 1e-12
    for got, want in zip(kt.to_boundary(torch.as_tensor(x[:5]),
                                        torch.as_tensor(y[:5]),
                                        torch.tensor(3.0)),
                         kj.to_boundary(x[:5], y[:5], 3.0)):
        assert abs(float(got) - float(want)) <= 1e-12
    for method in kt.METHOD_TABLE:
        cname = "".join(w.capitalize() for w in method.split("_")) \
            + "Workspace"
        assert getattr(kt, cname).__name__ == getattr(kj, cname).__name__
        assert issubclass(getattr(kt, cname), kt.KrylovWorkspace)
    assert kt.__version__ == kj.__version__


def test_sell_and_hybrid_names_exported():
    """The nine names of the SELL and hybrid slice are on the port's top
    level, as on the JAX package's, and the SELL kernel counts its
    launches under ``sell_spmv``."""
    for name in ("HybridOperator", "HybridMatrix", "hybrid_from_csr",
                 "split_diagonals", "SELLMatrix", "SELLBucketed",
                 "sell_from_csr", "sell_bucketed_from_csr", "sell_spmv"):
        assert hasattr(kj, name) and hasattr(kt, name), name
    assert kt.KERNELS["sell_spmv"] is kt.sell_spmv
    assert "sell_spmv" in kt.kernel_launches()
