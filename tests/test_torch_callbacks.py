"""A user callback sees exactly the iterations that run.

The JAX package calls the callback inside its ``while_loop`` body, so it
runs once per iteration while ``status == RUNNING and iter < cap``.  The
port takes its iterations in chunks of masked steps; with a callback the
host reads that condition before each step and ends the chunk at the
first inactive one.  Here a recording callback on each general route
sees the same ``iter`` values (exactly, in order) as a
``jax.debug.callback`` inside the JAX package's callback, on a 6³ f64
Poisson system.
"""

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu as kj
import krylov_tpu_torch as kt
from krylov_tpu.ops.dia import poisson_dia as jpoisson
from krylov_tpu_torch.convert import dia_from_numpy

SOLVERS = ("cg", "cr", "car", "minres", "cg_lanczos", "symmlq", "minres_qlp",
           "minares")


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("stop_at", [None, 4], ids=["run_out", "user_exit"])
def test_callback_sees_only_active_iterations(solver, stop_at):
    D = jpoisson(6, 6, 6, dtype=np.float64)
    A = dia_from_numpy(np.array(D.data), D.offsets, D.shape, device="cpu")
    b = np.random.default_rng(11).standard_normal(216)
    seen_j, seen_t = [], []

    def jax_callback(s):
        jax.debug.callback(lambda it: seen_j.append(int(it)), s.iter,
                           ordered=True)
        return False if stop_at is None else s.iter >= stop_at

    def torch_callback(s):
        seen_t.append(int(s.iter))
        return False if stop_at is None else s.iter >= stop_at

    _, sj = getattr(kj, solver)(D, b, callback=jax_callback)
    jax.effects_barrier()
    _, st = getattr(kt, solver)(A, torch.as_tensor(b),
                                callback=torch_callback)
    assert st.niter == sj.niter and st.status == sj.status
    assert seen_t == seen_j
    assert len(seen_t) == st.niter and seen_t[-1] == st.niter
