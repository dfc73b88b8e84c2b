"""Drive the PyTorch/CUDA port (krylov_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout, holds each against its plain
PyTorch version at the shapes of the main path, solves the flagship
system (the 3-D Poisson 7-point stencil in DIA form, 128^3 unknowns,
float32; CG also at 256^3) through the public entry points: ``cg``
(M = I, and a Chebyshev polynomial M), ``cr``, ``car``, ``minres``,
``cg_lanczos``, ``cg_lanczos_shift``, ``symmlq``, ``minres_qlp`` and
``minares``, and the non-symmetric convection-diffusion stencil of the
same size through ``gmres``, ``fgmres``, ``fom``, ``bicgstab``,
``cgs``, ``diom``, ``dqgmres``, ``bilq``, ``qmr`` and ``bilqr`` (Ax = b
and A^H y = c, in float64), and the same stencil with 0.5 on its main
diagonal through ``usymlq``, ``usymqr``, ``trilqr`` and ``usymlqr`` (the
saddle point [I A; A^H 0]) and, in float32 and float64, the least-squares
solvers ``lsqr``, ``lsmr`` and ``lslq`` and the least-norm solvers
``craig``, ``craigmr``, ``lnlq``, ``cgne`` and ``crmr``, and on the
unshifted stencils the normal-equation solvers ``cgls``, ``crls`` and
``cgls_lanczos_shift`` (convection-diffusion, lambda = 0.1),
``tricg`` and ``trimr`` (Poisson), ``gpmr`` (K = 0.1 (P + I) and its
transpose), ``block_minres`` and ``block_gmres`` (Poisson + 0.5 I, four
columns), each by its whole-solve kernel and by the general route with
its DIA SpMV kernel, and ``cg``, ``block_gmres`` and ``block_minres`` on
a block-tridiagonal block-ELL operator through the BELL SpMV and SpMM
kernels, and
``cg``, ``bicgstab`` and ``lsqr`` on a general sparse FEM band matrix
handed over as CSR (analysed once into a DIA part and a SELL-C-128
remainder, through the DIA SpMV and SELL SpMV kernels), chains the
padded-layout SpMV, solves the systems whose dtypes once had no SpMV
kernel, drives every ported method through ``krylov_solve`` and a
workspace round trip, and checks that each path launched its kernels.
Prints
one line per phase, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; without
a CUDA device it exits non-zero before printing a result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
TOTAL_LIMIT_S = 600.0
T0 = time.perf_counter()


class Phase:
    """Print a phase's wall time and fail it when it overruns its limit."""

    def __init__(self, name, limit_s):
        self.name, self.limit_s = name, limit_s

    def __enter__(self):
        self.t = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t
        if exc_type is None:
            print(f"[{self.name}] done in {dt:.2f} s", flush=True)
            if dt > self.limit_s:
                raise RuntimeError(f"phase {self.name} took {dt:.1f} s, "
                                   f"over its {self.limit_s} s limit")
        return False


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def hbm_rate(name):
    """Published memory bandwidth in bytes/s of the H100 variants."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def f32_rate(name):
    """Published float32 (non-tensor-core) peak in FLOP/s."""
    return 51e12 if "PCIe" in name else 67e12


def event_ms(fn, reps=20, warmup=3):
    """Median time of one call of fn, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def case_times(kernel_call, plain_call, timed, niter):
    """A phase case's times, taken only for a case whose numbers go into
    the kernels line (the others are held to their plain versions
    untimed, to keep the run inside TOTAL_LIMIT_S): the kernel's median
    ms of three calls and the plain version's ms of one, each warmed up
    by its result call, and the text for the case's line; (None, None,
    "") for an untimed case."""
    if not timed:
        return None, None, ""
    ms = event_ms(kernel_call, reps=3, warmup=0)
    plain_ms = event_ms(plain_call, reps=1, warmup=0)
    return ms, plain_ms, (f"; ms={ms:.3f} plain_ms={plain_ms:.3f} "
                          f"({1e3 * ms / max(niter, 1):.1f} us/iter)")


def host_us(fn, calls=100, batches=10):
    """Host time per call of fn in microseconds: a host clock around
    batches of ``calls`` calls with no synchronise inside a batch (the
    card drains its queue between batches, so a batch never waits on a
    full launch queue), summed and divided by the calls."""
    fn()
    total = 0.0
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        total += time.perf_counter() - t
    torch.cuda.synchronize()
    return total / (calls * batches) * 1e6


def device_ms(fn, reps=20):
    """Device time of one call of fn: the time of the kernels that the
    profiler (CUPTI) records over ``reps`` calls, divided by reps; None
    where it records none, or a count of kernels that is not a whole
    multiple of reps (a trace that lost records: a long run of this
    script has shown traces with half of them, timed below the bound)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)), e.count)
            for e in prof.key_averages() if not e.key.startswith("aten::")]
    us = sum(t for t, _ in rows)
    count = sum(c for t, c in rows if t > 0)
    return us / reps / 1e3 if us > 0 and count % reps == 0 else None


def fmt(v):
    return "not measured" if v is None else f"{v:.4f}"


def on_device(bound_ms, dev_ms):
    """The share of the bound that the device time reaches, for a print."""
    return "" if dev_ms is None else f", {bound_ms / dev_ms:.3f} on the " \
        "device"


def csr_of(pd, offsets, dtype):
    """torch.sparse CSR copy of the aligned DIA matrix (yardstick only)."""
    nd, n = pd.shape
    rows, cols, vals = [], [], []
    i = torch.arange(n, device=pd.device)
    for d, k in enumerate(offsets):
        j = i + k
        keep = (j >= 0) & (j < n)
        rows.append(i[keep])
        cols.append(j[keep])
        vals.append(pd[d][keep].to(dtype))
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n))
    return coo.coalesce().to_sparse_csr()


def fem_band(nf, seed=0):
    """bench.py:698-704's FEM band: nf rows of 12 nonzeros at column
    offsets uniform in ±300 (clipped to the matrix), normal values
    (float64; the bench's float32 values are these rounded), seed 0;
    as (rows, cols, vals) on the host."""
    gen = np.random.default_rng(seed)
    fr = np.repeat(np.arange(nf, dtype=np.int64), 12)
    fc = np.clip(fr + gen.integers(-300, 301, size=fr.size), 0, nf - 1)
    return fr, fc, gen.standard_normal(fr.size)


def dominant(rows, cols, vals, nf, symmetric):
    """The band's off-diagonal entries (with their transposes where
    ``symmetric``: S + S^T) and the diagonal 1 + the sum of the moduli
    of each row's off-diagonal entries: SPD where symmetric, strictly
    diagonally dominant in every case."""
    keep = rows != cols
    r, c, v = rows[keep], cols[keep], vals[keep]
    if symmetric:
        r, c, v = np.r_[r, c], np.r_[c, r], np.r_[v, v]
    d = 1.0 + np.bincount(r, np.abs(v), nf)
    i = np.arange(nf)
    return np.r_[r, i], np.r_[c, i], np.r_[v, d]


def torch_csr(csr, dtype=None):
    """torch.sparse CSR copy of a CSRMatrix (yardstick only)."""
    return torch.sparse_csr_tensor(
        csr.indptr, csr.indices,
        csr.data if dtype is None else csr.data.to(dtype),
        csr.shape)


def bell_tridiagonal(kt, nb, dt, seed, dev="cuda"):
    """The SPD block-tridiagonal BELL of tests/test_pallas_spmv.py:
    184-203 (nb block rows of 128: M M^T / 128^2 + 2 I on the diagonal, a
    seeded off-diagonal block and its transpose beside it, clamped at the
    edges), built on the card."""
    bs = 128
    g = np.random.default_rng(seed)
    M = torch.as_tensor(g.standard_normal((nb, bs, bs)) / bs, device=dev)
    diag = M @ M.transpose(1, 2) + 2 * torch.eye(bs, dtype=M.dtype,
                                                 device=dev)
    off = torch.as_tensor(g.standard_normal((bs, bs)) / (4 * bs),
                          device=dev)
    i = torch.arange(nb, device=dev)
    idx = torch.stack([(i - 1).clamp(min=0), i, (i + 1).clamp(max=nb - 1)],
                      1)
    data = torch.zeros((nb, 3, bs, bs), dtype=torch.float64, device=dev)
    for k in range(3):
        j = idx[:, k]
        data[:, k] += torch.where((j == i)[:, None, None], diag, 0.0)
        data[:, k] += torch.where((j == i - 1)[:, None, None], off, 0.0)
        data[:, k] += torch.where((j == i + 1)[:, None, None], off.T, 0.0)
    del M, diag
    return kt.BELLMatrix(data.to(dt), idx.to(torch.int32), (nb * bs, nb * bs),
                         bs)


def bsr_of(A):
    """torch.sparse_bsr_tensor of a BELL's blocks, the duplicate block
    columns of a row summed (the library yardstick's operand)."""
    dev = A.data.device
    nbr, mbpr, bs, _ = A.data.shape
    rows = torch.arange(nbr, device=dev).repeat_interleave(mbpr)
    key = rows * nbr + A.indices.reshape(-1).long()
    uniq, inv = torch.unique(key, return_inverse=True)
    vals = torch.zeros((uniq.numel(), bs, bs), dtype=A.dtype,
                       device=dev).index_add_(0, inv,
                                              A.data.reshape(-1, bs, bs))
    crow = torch.zeros(nbr + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(uniq // nbr, minlength=nbr), 0)
    return torch.sparse_bsr_tensor(crow, uniq % nbr, vals, A.shape)


def bell_bound_ms(A, X, bw):
    """The byte bound of one BELL product: the blocks and their indices,
    x and y, each once, at ``bw`` bytes/s."""
    return (A.data.numel() * A.data.element_size() + A.indices.numel() * 4
            + 2 * X.numel() * X.element_size()) / bw * 1e3


# phase 3l's BELLs: block rows and element type
BELL_CASES = ((1024, torch.float32), (1024, torch.float64),
              (96, torch.float32), (96, torch.float64))


def bell_label(p, nb, dt):
    name = "bell_spmv" if p == 1 else "bell_spmm"
    return f"{name} p={p} nb={nb} {str(dt)[6:]}"


def bell_device_main():
    """``python3 chip_smoke.py --bell-device``: the device ms of
    BELLOperator's products on phase 3l's BELLs (p = 1, 4 and 8), one
    profiler trace each, as one JSON line keyed by 3l's labels."""
    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    _build.library()
    gen = np.random.default_rng(SEED + 43)
    out = {}
    for nb, dt in BELL_CASES:
        A = bell_tridiagonal(kt, nb, dt, SEED + 31)
        op = kt.BELLOperator(A)
        for p in (1, 4, 8):
            X = torch.as_tensor(gen.standard_normal(
                (A.shape[1], p) if p > 1 else A.shape[1])).to("cuda", dt)
            call = op.matvec if p == 1 else op.matmat
            out[bell_label(p, nb, dt)] = device_ms(lambda: call(X))
        del A, op
    print(json.dumps(out), flush=True)


def bell_device_ms_in_own_process():
    """``bell_device_main``'s device ms, {label: ms or None}, from a
    process of its own: late in a long run of this script the profiler's
    traces have lost kernel records (PERF.md §7), in a fresh process they
    have not.  {} where that process fails (its error printed)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--bell-device"], capture_output=True, text=True,
                         timeout=300)
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or not lines:
        print(f"  --bell-device failed ({run.returncode}): "
              f"{run.stderr[-2000:]}", flush=True)
        return {}
    print(f"  device ms from a process of its own "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    return json.loads(lines[-1])


def solve_profile(solve):
    """One call of ``solve`` (a default solve, run once before as a
    warm-up) under the profiler (CUPTI kernel records): (stats, wall us,
    device busy us, [(device us, calls, kernel)]), or None where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, stats = solve()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        # an aten:: row repeats the device time of the kernels it
        # launched (aten::linalg_qr and its geqr2 kernel), so only the
        # kernels and copies count
        if dev_us > 0 and not e.key.startswith("aten::"):
            rows.append((dev_us, e.count, e.key))
    if not rows:
        return None
    return stats, wall_us, sum(r[0] for r in rows), sorted(rows,
                                                            reverse=True)


def profile_solve(solve, top=10):
    """Device time by kernel over one call of ``solve`` (a default solve,
    run once before as a warm-up), and the device's busy share of its
    wall time (torch.profiler; CUPTI kernel records)."""
    prof = solve_profile(solve)
    if prof is None:
        print("  profiler saw no device time", flush=True)
        return
    stats, wall_us, busy_us, rows = prof
    print(f"  niter={stats.niter} wall_us={wall_us:.1f} device_busy_us="
          f"{busy_us:.1f} busy_share={busy_us / wall_us:.3f}", flush=True)
    for dev_us, count, key in rows[:top]:
        print(f"  {dev_us:12.1f} us {count:7d} calls {dev_us / count:9.2f} "
              f"us/call  {key[:90]}", flush=True)


def main():
    with Phase("0 device", 30):
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                     "is False)")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        kind = torch.cuda.get_device_name(0)
        bw, peak = hbm_rate(kind), f32_rate(kind)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {kind}; bounds use {bw / 1e12} TB/s and "
              f"{peak / 1e12} TFLOP/s f32", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    import krylov_tpu_torch as kt
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops.cuda_dia import (DIASpMV, dia_align,
                                               dia_spmv_aligned,
                                               dia_spmv_aligned_ref,
                                               offsets_tensor)
    from krylov_tpu_torch import _runtime as rt
    from krylov_tpu_torch.ops import cuda_dia
    from krylov_tpu_torch.ops import cuda_fused as cf
    from krylov_tpu_torch.ops.cuda_fused import (cg_dia_fused,
                                                 cg_dia_fused_ref)
    from krylov_tpu_torch.solvers.bicgstab import _STATUS as biortho_status
    from krylov_tpu_torch.solvers.fom import _FOM_STATUS as fom_status
    from krylov_tpu_torch.solvers.minares import _STATUS as minares_status
    from krylov_tpu_torch.solvers.symmlq import _STATUS as symmlq_status

    def reset_counts():
        for w in kt.KERNELS.values():
            w.launches = 0

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def rhs(n, dtype=torch.float32, gen=rng):
        return torch.as_tensor(gen.standard_normal(n)).to(dev, dtype)

    def ssy_residuals(name, pd, ot, pda, ota, b, c, out):
        """The true relative residuals (f64, the plain SpMV) of an SSY
        solve's outputs: ||b - Ax|| / ||b|| (0 where b = 0), with
        ||c - A^H y|| / ||c|| for TriLQR; for USYMLQR the saddle blocks
        ||b - x - Ay|| / ||b|| and ||c - A^H x|| / ||c||."""
        def rel(r, v):
            nv = float(v.double().norm())
            return float(r.norm()) / nv if nv > 0 else float(r.norm())

        x = out[0].double()
        if name == "usymlqr_dia":
            y = out[1].double()
            return [rel(b.double() - x - dia_spmv_aligned_ref(
                        pd.double(), ot, y), b),
                    rel(c.double() - dia_spmv_aligned_ref(pda.double(), ota,
                                                          x), c)]
        res = [rel(b.double() - dia_spmv_aligned_ref(pd.double(), ot, x), b)]
        if name == "trilqr_dia":
            res.append(rel(c.double() - dia_spmv_aligned_ref(
                pda.double(), ota, out[1].double()), c))
        return res

    def true_rel_residual(pd, ot, b, x, sigma=0.0):
        """‖b − (A + σI)x‖ / ‖b‖ in f64 (complex128 for complex b) with
        the plain SpMV."""
        wide = torch.complex128 if b.is_complex() else torch.float64
        xd = x.to(wide)
        r = b.to(wide) - (dia_spmv_aligned_ref(pd.double(), ot, xd)
                          + sigma * xd)
        return float(r.norm() / b.to(wide).norm())

    def ls_residuals(pd, ot, pda, ota, b, x):
        """||b - Ax|| / ||b|| and ||A^H (b - Ax)|| in f64 with the plain
        SpMV (the first 0 where b = 0)."""
        r = b.double() - dia_spmv_aligned_ref(pd.double(), ot, x.double())
        nb = float(b.double().norm())
        return (float(r.norm()) / nb if nb > 0 else float(r.norm()),
                float(dia_spmv_aligned_ref(pda.double(), ota, r).norm()))

    def gk_args(method, dt, n, lam=0.0, window=5, sigma=0.0,
                transfer=False, rtol=None):
        """(args after (pd, pda, ot, ota, b), kwargs) of a Golub-Kahan
        kernel and its plain version, at the entry points' defaults: sqrt
        eps(T) for axtol, btol and etol (and LSLQ's atol, rtol, utol),
        atol = rtol = 0 for LSQR and LSMR, conlim 1e8, itmax m + n."""
        tol = rt.default_tol(None, dt)
        if method == "lslq":
            return ((lam, sigma, tol, tol if rtol is None else rtol, tol,
                     tol, tol, 1e8, 2 * n),
                    {"use_sigma": sigma > 0, "transfer_to_lsqr": transfer,
                     "window": window})
        return ((lam, tol, tol, 0.0, 0.0 if rtol is None else rtol, tol,
                 1e8, 2 * n), {"window": window})

    with Phase("1 build", 180):
        t = time.perf_counter()
        lib = _build.library()
        print(f"  nvcc build + load: {time.perf_counter() - t:.2f} s "
              f"({_build.LIB_PATH.name}, {lib._name})", flush=True)

    report = {}
    with Phase("2 dia_spmv kernel vs plain", 90):
        cases = [("128^3 f32", 128, torch.float32, torch.float32, 1e-6),
                 ("128^3 bf16 pd", 128, torch.float32, torch.bfloat16, 1e-6),
                 ("256^3 f32", 256, torch.float32, torch.float32, 1e-6),
                 ("64^3 f64", 64, torch.float64, torch.float64, 1e-14)]
        for label, N, xdt, pdt, tol in cases:
            A = kt.poisson_dia(N, dtype=torch.float64 if xdt ==
                               torch.float64 else torch.float32)
            n = A.shape[0]
            pd = dia_align(A.data, A.offsets, n).to(pdt)
            ot = offsets_tensor(A.offsets, dev)
            x = rhs(n, xdt)
            y = dia_spmv_aligned(pd, ot, x)
            y_ref = dia_spmv_aligned_ref(pd, ot, x)
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            rel = err / float(y_ref.abs().max())
            plan = DIASpMV(pd, ot, A.offsets)
            same = torch.equal(plan(x), y)
            ms = event_ms(lambda: dia_spmv_aligned(pd, ot, x))
            plan_ms = event_ms(lambda: plan(x))
            plain_ms = event_ms(lambda: dia_spmv_aligned_ref(pd, ot, x))
            csr = csr_of(pd, A.offsets, xdt)
            lib_ms = event_ms(lambda: torch.mv(csr, x))
            del csr
            us_pub = host_us(lambda: dia_spmv_aligned(pd, ot, x))
            us_plan = host_us(lambda: plan(x))
            dev_ms = device_ms(lambda: plan(x))
            nbytes = pd.numel() * pd.element_size() + 2 * n * x.element_size() \
                + ot.numel() * 8
            flops = 2 * pd.numel()
            bound_ms = max(nbytes / bw, flops / peak) * 1e3
            bound_by = "bytes" if nbytes / bw >= flops / peak \
                else "operations"
            print(f"  {label}: n={n} max_abs_err={err:.3e} max_rel_err="
                  f"{rel:.3e} (tol {tol:g}) ms={ms:.4f} (DIASpMV "
                  f"{plan_ms:.4f}, device {fmt(dev_ms)}) plain_ms="
                  f"{plain_ms:.4f} csr_ms={lib_ms:.4f} bound_ms="
                  f"{bound_ms:.4f} ({nbytes / 1e6:.1f} MB, "
                  f"{bound_ms / plan_ms:.3f} of it by events"
                  f"{on_device(bound_ms, dev_ms)}"
                  f"); host us/call dia_spmv_aligned {us_pub:.2f}, DIASpMV "
                  f"{us_plan:.2f}", flush=True)
            check(rel <= tol, f"dia_spmv {label} agrees with its plain "
                  f"version ({rel:.2e} <= {tol:g})")
            check(same, f"dia_spmv {label}: DIASpMV's call gives the "
                  "public wrapper's bits")
            if label == "128^3 f32":
                # the main path's call: DIAOperator's DIASpMV
                report["dia_spmv"] = dict(max_abs_err=err, ms=plan_ms,
                                          plain_ms=plain_ms,
                                          bound_ms=bound_ms,
                                          bound_by=bound_by,
                                          library_ms=lib_ms)
            del A, pd, x, y, y_ref, plan
        # the pairs that had no kernel before (64^3): the general routes
        # of an f64 b on f32 diagonals, of complex systems and of bf16 or
        # f16 vectors run them; tolerances relative to max|y| as in
        # tests/test_torch_port.py (one ulp of the narrow types)
        pairs = [(torch.float64, torch.float32, 1e-14),
                 (torch.bfloat16, torch.bfloat16, 1e-2),
                 (torch.float16, torch.float16, 1e-3),
                 (torch.complex64, torch.float32, 1e-6),
                 (torch.complex64, torch.complex64, 1e-6),
                 (torch.complex128, torch.float64, 1e-14),
                 (torch.complex128, torch.complex128, 1e-14)]
        A = kt.poisson_dia(64, dtype=torch.float64)
        ot = offsets_tensor(A.offsets, dev)
        pd64 = dia_align(A.data, A.offsets, A.shape[0])
        x64 = rhs(A.shape[0], torch.float64)
        for xdt, pdt, tol in pairs:
            pd = (pd64 * (1.0 + 0.5j) if pdt.is_complex else pd64).to(pdt)
            x = (x64 * (0.5 - 1.0j) if xdt.is_complex else x64).to(xdt)
            y = dia_spmv_aligned(pd, ot, x)
            y_ref = dia_spmv_aligned_ref(pd, ot, x)
            torch.cuda.synchronize()
            rel = float((y - y_ref).abs().max() / y_ref.abs().max())
            check(y.dtype == xdt and rel <= tol,
                  f"dia_spmv 64^3 x {xdt} with pd {pdt} agrees with its "
                  f"plain version ({rel:.2e} <= {tol:g})")
        del A, pd64, x64, pd, x, y, y_ref

    with Phase("2b dia_spmv_padded kernel vs plain, chained", 60):
        # two chained products at 128^3 f32 in the padded layout with the
        # input halo full of NaN: the interior must agree with the plain
        # version (1e-6 of max|y|, as dia_spmv) and stay finite.  The
        # main path of this kernel is a chain of products through the
        # public entry points (pad, 8 products, unpad), driven with the
        # counts set to 0 just before and read just after.
        A = kt.poisson_dia(128)
        n = A.shape[0]
        pd = dia_align(A.data, A.offsets, n)
        ot = offsets_tensor(A.offsets, dev)
        x = rhs(n)
        xw = kt.dia_pad_layout(x, A.offsets)
        h = (xw.shape[0] - n) // 2
        xw[:h] = float("nan")
        xw[h + n:] = float("nan")
        y2w = kt.dia_spmv_padded(pd, ot, kt.dia_spmv_padded(pd, ot, xw, n),
                                 n)
        y2 = kt.dia_unpad_layout(y2w, A.offsets, n)
        ref = dia_spmv_aligned_ref(pd, ot, dia_spmv_aligned_ref(pd, ot, x))
        torch.cuda.synchronize()
        err = float((y2 - ref).abs().max())
        rel = err / float(ref.abs().max())
        check(bool(torch.isfinite(y2).all()) and rel <= 1e-6,
              f"dia_spmv_padded chained twice with NaN halos agrees with "
              f"its plain version ({rel:.2e} <= 1e-6)")
        yw = kt.dia_spmv_padded(pd, ot, xw, n)
        ms = event_ms(lambda: kt.dia_spmv_padded(pd, ot, yw, n))
        plain_ms = event_ms(lambda: cuda_dia.dia_spmv_padded_ref(
            pd, ot, yw, n), reps=1, warmup=0)
        csr = csr_of(pd, A.offsets, torch.float32)
        lib_ms = event_ms(lambda: torch.mv(csr, x))
        del csr
        nbytes = pd.numel() * pd.element_size() + 2 * n * x.element_size() \
            + ot.numel() * 8
        bound_ms = nbytes / bw * 1e3
        print(f"  128^3 f32 padded (halo {h}): max_abs_err={err:.3e} ms="
              f"{ms:.4f} plain_ms={plain_ms:.4f} csr_ms={lib_ms:.4f} "
              f"bound_ms={bound_ms:.4f}", flush=True)
        report["dia_spmv_padded"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by="bytes",
                                         library_ms=lib_ms)
        torch.cuda.synchronize()
        reset_counts()
        vw = kt.dia_pad_layout(x, A.offsets)
        for _ in range(8):
            vw = kt.dia_spmv_padded(pd, ot, vw, n)
            vw = vw / kt.dia_unpad_layout(vw, A.offsets, n).abs().max()
        v = kt.dia_unpad_layout(vw, A.offsets, n)
        torch.cuda.synchronize()
        launches_padded = kt.kernel_launches()["dia_spmv_padded"]
        check(bool(torch.isfinite(v).all()) and launches_padded == 8,
              f"the chained path launched dia_spmv_padded "
              f"({launches_padded} times)")
        del A, pd, x, xw, y2w, y2, ref, yw, vw, v

    from krylov_tpu_torch.ops import cuda_sell as csell
    from krylov_tpu_torch.ops.hybrid import split_diagonals

    def sell_bytes(S, x):
        """Bytes a SELL product must move: every stored slot (its element
        and its 4-byte index), x and y once."""
        parts = getattr(S, "parts", (S,))
        slots = sum(p.data.numel() for p in parts)
        return slots * (parts[0].data.element_size() + 4) \
            + (S.shape[0] + S.shape[1]) * x.element_size()

    def hybrid_vs_plain(label, op, csr, x, tol):
        """A HybridOperator's products on the card against plain versions
        on the same inputs: the DIA half (dia_spmv_aligned on the
        diagonals the analysis aligned) against dia_spmv_aligned_ref, and
        the whole DIA + SELL sum against the plain CSR product of the
        source matrix; with adjoint storage, both again for A^H (rmatvec
        against CSROperator.with_adjoint()).  max |dy| <= tol max|y|."""
        from krylov_tpu_torch.ops.sparse import spmv as csr_spmv
        sides = [("A", op.hyb, op.matvec, lambda v: csr_spmv(csr, v))]
        if op.hyb_h is not None:
            sides.append(("A^H", op.hyb_h, op.rmatvec,
                          kt.CSROperator(csr).with_adjoint().rmatvec))
        for side, hyb, run, plain in sides:
            check(hyb.dia_pd is not None and hyb.sell is not None,
                  f"{label} {side}: a DIA part on the card and a remainder")
            yd = dia_spmv_aligned(hyb.dia_pd, hyb._offsets, x)
            yd_ref = dia_spmv_aligned_ref(hyb.dia_pd, hyb._offsets, x)
            y, y_ref = run(x), plain(x)
            torch.cuda.synchronize()
            rd = float((yd - yd_ref).abs().max() / yd_ref.abs().max())
            rh = float((y - y_ref).abs().max() / y_ref.abs().max())
            print(f"  {label} {side}: DIA half ({len(hyb.dia.offsets)} "
                  f"diagonals) rel={rd:.3e}; DIA + SELL against the plain "
                  f"CSR product rel={rh:.3e} (tol {tol:g})", flush=True)
            check(yd.dtype == x.dtype and rd <= tol
                  and bool(torch.isfinite(yd).all()),
                  f"{label} {side}: dia_spmv on the analysed diagonals "
                  f"agrees with its plain version ({rd:.2e} <= {tol:g})")
            check(y.dtype == x.dtype and y.shape == y_ref.shape
                  and rh <= tol and bool(torch.isfinite(y).all()),
                  f"{label} {side}: hybrid_spmv agrees with the plain CSR "
                  f"product ({rh:.2e} <= {tol:g})")
            del yd, yd_ref, y, y_ref

    with Phase("2c sell_spmv kernel vs plain", 150):
        # The SELL kernel against its plain version on bench.py:698-704's
        # FEM band at n = 2^17 (1.56 M nonzeros), bucketed as the JAX
        # package packs it (5 parts, uncovered ones among them) in f32,
        # in f64 (the same parts, data widened) and with f64 x on the f32
        # data; a sigma-sorted plan (the band with n/256 heavy constraint
        # rows spread over every slice, each coupled to the first 1280
        # columns: row_pos un-permutes on the card); a single covered
        # sell_from_csr of the band; and the SELL remainder of the main
        # path's matrix (the band made SPD: S + S^T with a dominant
        # diagonal; phase 5y solves it), analysed once through
        # as_operator and cached on the matrix.  Tolerances: max |dy| <=
        # 1e-5 max|y| with f32 accumulation, 1e-12 in f64 (the same
        # products summed in another order).  Times by CUDA events
        # (median of 20); the bound counts every stored slot (element
        # and 4-byte index), x and y once, over the HBM rate; Gnnz/s on
        # the true nonzeros (bench.py:709); the library yardstick is
        # torch.sparse CSR @ x on the same matrix.
        nf = 1 << 17
        fr, fc, fv = fem_band(nf)
        t = time.perf_counter()
        fem32 = kt.csr_from_coo(fr, fc, fv.astype(np.float32), (nf, nf))
        SB = kt.sell_bucketed_from_csr(fem32)
        t_pack = time.perf_counter() - t
        check(isinstance(SB, kt.SELLBucketed) and len(SB.parts) >= 2
              and any(not p.covered for p in SB.parts),
              f"the FEM band packs into {len(SB.parts)} depth parts, "
              "uncovered ones among them")
        print(f"  FEM band n={nf} nnz={SB.nnz}: host packing {t_pack:.2f} s; "
              f"parts (pairs, Kmax, covered): "
              f"{[(p.data.shape[0], p.kmax, p.covered) for p in SB.parts]}"
              f"; fill {SB.fill:.3f}; {sell_bytes(SB, fem32.data) / 1e6:.1f}"
              " MB", flush=True)
        SB64 = kt.SELLBucketed(
            [csell.SELLMatrix(p.data.double(), p.idx, p.slice_of,
                              p.chunk_of, p.shape, p.nnz, p.covered,
                              p.slice_ptr) for p in SB.parts],
            SB.shape, SB.nnz, SB.row_pos)
        gen = np.random.default_rng(SEED + 40)
        x64 = torch.as_tensor(gen.standard_normal(nf), device=dev)
        x32 = x64.float()
        hr, hc = fr.copy(), fc.copy()
        heavy = np.sort(gen.choice(nf, nf // 256, replace=False))
        hr = np.r_[hr, np.repeat(heavy, 1280)]
        hc = np.r_[hc, np.tile(np.arange(1280), len(heavy))]
        sorted_csr = kt.csr_from_coo(hr, hc, gen.standard_normal(hr.size),
                                     (nf, nf), dtype=np.float32)
        SS = kt.sell_bucketed_from_csr(sorted_csr)
        check(isinstance(SS, kt.SELLBucketed) and SS.row_pos is not None,
              f"the spread heavy rows take the sigma-sorted plan "
              f"({len(SS.parts)} parts)")
        S1 = kt.sell_from_csr(fem32)
        sr, sc, sv = dominant(fr, fc, fv, nf, True)
        fem_spd = kt.csr_from_coo(sr, sc, sv.astype(np.float32), (nf, nf))
        t = time.perf_counter()
        spd_op = kt.as_operator(fem_spd)
        t_spd = time.perf_counter() - t
        spd_rem = split_diagonals(fem_spd)[1]
        SR = spd_op.hyb.sell
        print(f"  SPD band nnz={fem_spd.nnz}: host analysis {t_spd:.2f} s "
              f"(DIA offsets {spd_op.hyb.dia.offsets}; remainder "
              f"{type(SR).__name__}, "
              f"{len(getattr(SR, 'parts', (SR,)))} parts, fill "
              f"{SR.fill:.3f})", flush=True)
        check(isinstance(spd_op, kt.HybridOperator)
              and fem_spd._hybrid_op is spd_op
              and spd_op.hyb.dia_pd is not None
              and isinstance(SR, (kt.SELLMatrix, kt.SELLBucketed)),
              "the SPD band analyses to a DIA part on the card and a SELL "
              "remainder, cached on the matrix")
        hybrid_vs_plain("SPD band f32 (main path)", spd_op, fem_spd, x32,
                        1e-5)
        cases = [("FEM band bucketed f32", SB, x32, fem32, 1e-5),
                 ("FEM band bucketed f64", SB64, x64, None, 1e-12),
                 ("FEM band bucketed f64 x, f32 data", SB, x64, None, 1e-12),
                 ("sigma-sorted f32", SS, x32, sorted_csr, 1e-5),
                 ("FEM band single covered f32", S1, x32, fem32, 1e-5),
                 ("SPD band remainder f32 (main path)", SR, x32, spd_rem,
                  1e-5)]
        for label, S, x, lib_csr, tol in cases:
            bucketed = isinstance(S, kt.SELLBucketed)
            run = (lambda S=S, x=x: csell.sell_bucketed_spmv(S, x)) \
                if bucketed else (lambda S=S, x=x: kt.sell_spmv(S, x))
            plain = (lambda S=S, x=x: csell.sell_bucketed_spmv_ref(S, x)) \
                if bucketed else (lambda S=S, x=x: csell.sell_spmv_ref(S, x))
            n0 = kt.sell_spmv.launches
            y = run()
            nl = kt.sell_spmv.launches - n0
            y_ref = plain()
            torch.cuda.synchronize()
            err = float((y - y_ref).abs().max())
            rel = err / float(y_ref.abs().max())
            ms = event_ms(run)
            dev_ms = device_ms(run)
            plain_ms = event_ms(plain, reps=5)
            us = host_us(run)
            comp = ""
            if bucketed:
                # the per-part composition: the kernel on each part alone,
                # then PyTorch's adds and gather
                parts = (lambda S=S, x=x:
                         csell.sell_bucketed_spmv_parts(S, x))
                same = torch.equal(y, parts())
                comp = (f"; per-part composition ({len(S.parts)} launches) "
                        f"ms={event_ms(parts):.4f} host us/call="
                        f"{host_us(parts):.2f}, bit-equal={same}")
                check(same, f"sell_spmv {label}: one launch gives the "
                      "per-part composition's bits")
            lib_ms = None
            if lib_csr is not None:
                tc = torch_csr(lib_csr, x.dtype)
                lib_ms = event_ms(lambda tc=tc, x=x: tc @ x)
                del tc
            nbytes = sell_bytes(S, x)
            bound_ms = nbytes / bw * 1e3
            need = S.nnz * (S.dtype.itemsize + 4) \
                + (S.shape[0] + S.shape[1]) * x.element_size()
            print(f"  {label}: launches={nl} max_abs_err={err:.3e} rel="
                  f"{rel:.3e} (tol {tol:g}) ms={ms:.4f} (device "
                  f"{fmt(dev_ms)}) plain_ms={plain_ms:.4f} csr_ms="
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={bound_ms:.4f} ({nbytes / 1e6:.1f} MB of "
                  f"slots, {bound_ms / ms:.3f} of it by events"
                  f"{on_device(bound_ms, dev_ms)}"
                  f") nnz bound_ms="
                  f"{need / bw * 1e3:.4f} ({need / 1e6:.1f} MB) "
                  f"{S.nnz / ms / 1e6:.2f} Gnnz/s host us/call={us:.2f}"
                  f"{comp}", flush=True)
            check(nl == 1, f"sell_spmv {label}: one launch per product")
            check(y.dtype == x.dtype and y.shape == (nf,) and rel <= tol
                  and bool(torch.isfinite(y).all()),
                  f"sell_spmv {label} agrees with its plain version "
                  f"({rel:.2e} <= {tol:g})")
            if label.endswith("(main path)"):
                report["sell_spmv"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms,
                                           bound_ms=bound_ms,
                                           bound_by="bytes",
                                           library_ms=lib_ms)
            del y, y_ref
        one = SB.parts[0]
        ms = event_ms(lambda: kt.sell_spmv(one, x32))
        print(f"  one part alone (pairs {one.data.shape[0]}, Kmax "
              f"{one.kmax}): ms={ms:.4f} bound_ms="
              f"{sell_bytes(one, x32) / bw * 1e3:.4f}", flush=True)
        # the main path's whole product: the DIA half and one SELL launch
        # that adds it, against the DIA half plus the per-part composition
        hyb = spd_op.hyb
        counts0 = kt.kernel_launches()
        y = spd_op.matvec(x32)
        counts1 = kt.kernel_launches()
        nl = (counts1["dia_spmv"] - counts0["dia_spmv"],
              counts1["sell_spmv"] - counts0["sell_spmv"])
        parts = (lambda: hyb._dia_spmv(x32)
                 + csell.sell_bucketed_spmv_parts(hyb.sell, x32)) \
            if isinstance(hyb.sell, kt.SELLBucketed) else \
            (lambda: hyb._dia_spmv(x32) + kt.sell_spmv(hyb.sell, x32))
        same = torch.equal(y, parts())
        tc = torch_csr(fem_spd)
        lib_ms = event_ms(lambda: tc @ x32)
        del tc
        need = fem_spd.nnz * 8 + 2 * nf * 4
        ms = event_ms(lambda: spd_op.matvec(x32))
        dev_ms = device_ms(lambda: spd_op.matvec(x32))
        print(f"  SPD band hybrid product (main path): launches dia_spmv, "
              f"sell_spmv = {nl} ms={ms:.4f} (device {fmt(dev_ms)}) host "
              f"us/call="
              f"{host_us(lambda: spd_op.matvec(x32)):.2f}; DIA half + "
              f"per-part composition ms={event_ms(parts):.4f} host us/call="
              f"{host_us(parts):.2f} bit-equal={same}; csr_ms={lib_ms:.4f} "
              f"nnz bound_ms={need / bw * 1e3:.4f}", flush=True)
        check(nl == (1, 1) and same, "the hybrid product is one dia_spmv "
              "and one sell_spmv launch, bit for bit the DIA half plus the "
              "per-part composition")
        del SB, SB64, SS, S1, sorted_csr, fem32, spd_rem, SR, x32, x64, y

    with Phase("3 cg_dia kernel vs plain", 90):
        A = kt.poisson_dia(128)
        n = A.shape[0]
        pd = dia_align(A.data, A.offsets, n)
        ot = offsets_tensor(A.offsets, dev)
        b = rhs(n)
        rtol = float(np.sqrt(np.finfo(np.float32).eps))
        for label, dinv in (("M=I", None),
                            ("Jacobi", torch.full_like(b, 1.0 / 6.0))):
            k = cg_dia_fused(pd, ot, b, 0.0, rtol, 2 * n, dinv=dinv)
            r = cg_dia_fused_ref(pd, ot, b, 0.0, rtol, 2 * n, dinv=dinv)
            torch.cuda.synchronize()
            kn, ks, kv = int(k[1]), int(k[3]), int(k[4])
            rn, rs = int(r[1]), int(r[3])
            res_k = true_rel_residual(pd, ot, b, k[0])
            res_r = true_rel_residual(pd, ot, b, r[0])
            err = float((k[0] - r[0]).abs().max())
            print(f"  {label}: kernel niter={kn} status={ks} viol={kv} "
                  f"true_res={res_k:.3e}; plain niter={rn} status={rs} "
                  f"true_res={res_r:.3e}; max_abs_err(x)={err:.3e}",
                  flush=True)
            check(ks == rs == 1 and kv == 0,
                  f"cg_dia {label}: same status (solved) as the plain "
                  "version")
            check(abs(kn - rn) <= max(2, 0.1 * rn),
                  f"cg_dia {label}: niter {kn} within ±max(2, 10%) of {rn}")
            check(res_k <= 1.5 * rtol,
                  f"cg_dia {label}: true residual {res_k:.2e} <= 1.5·rtol")
            if dinv is None:
                ms = event_ms(lambda: cg_dia_fused(pd, ot, b, 0.0, rtol,
                                                   2 * n), reps=5, warmup=1)
                plain_ms = event_ms(lambda: cg_dia_fused_ref(
                    pd, ot, b, 0.0, rtol, 2 * n), reps=3, warmup=1)
                it_bytes = (pd.numel() * pd.element_size()
                            + 6 * n * b.element_size())
                bound_ms = kn * it_bytes / bw * 1e3
                print(f"  M=I: ms/solve={ms:.3f} (us/iter "
                      f"{1e3 * ms / kn:.2f}) plain ms/solve={plain_ms:.3f} "
                      f"bound_ms={bound_ms:.3f} ({it_bytes / 1e6:.1f} MB "
                      f"per iteration x {kn})", flush=True)
                report["cg_dia"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by="bytes", library_ms=None)
        del A, pd, b

    def hold_cases(cases, seed):
        """Each whole-solve kernel against its plain version on the same
        inputs.  A case is (label, N, dtype, kernel, wrapper args after
        (pd, ot, b), kwargs, the vectors every iteration must read and
        write beside the stencil's diagonals, the stencil applications
        per iteration).  Tolerances: status and flags equal; niter within
        ±max(2, 10%) in f32 (and for BiCGSTAB and CGS in f64) and equal in
        f64; max|x - x_plain| /
        max|x_plain| within 1e-2 in f32 (two solves stopped at rtol 1e-6
        on a system of condition number about 6.7e3 may differ by about
        7e-3) and 1e-8 in f64 (rtol 1e-10, the same iterations).  The
        kwarg "jacobi" adds a variable Jacobi dinv, "flip" flips the sign
        of the first half of the main diagonal (an indefinite stencil),
        "three_eigenvalues" keeps only the main diagonal, set to 1, 2, 3,
        1, 2, ... (the Krylov space is exhausted at the third step),
        "convdiff" takes the convection-diffusion stencil (cell Peclet
        number 0.3) for the Poisson one, "zero_rhs" sets b = 0, "warm"
        passes b - A x0 with x0 = 0.5 (what a warm-started solve gives
        its kernel), and a "shifts" list becomes a tensor on the card.
        Where the vectors to read and write depend on the iterations, as
        for GMRES and FOM, that entry is a function of the kernel's int
        outputs, the diagonals' bytes and one vector's bytes giving the
        solve's bound in bytes; GMRES's and FOM's npass (the last int)
        is held to the band too in f32."""
        systems = {}
        # a generator of the phase's own, so that the later phases draw
        # the same right-hand sides as they did before the phase existed
        gen = np.random.default_rng(seed)
        for label, N, dt, name, args, kw, nvec, napply in cases:
            kw = dict(kw)
            # the stencil, or one of its two variants
            variant = next((v for v in ("flip", "three_eigenvalues",
                                        "convdiff") if kw.pop(v, False)),
                           None)
            rhs_kind = next((v for v in ("zero_rhs", "warm")
                             if kw.pop(v, False)), None)
            if (N, dt, variant) not in systems:
                A = (kt.convdiff_dia(N, dtype=dt) if variant == "convdiff"
                     else kt.poisson_dia(N, dtype=dt))
                data = A.data
                if variant == "three_eigenvalues":
                    data = torch.zeros_like(data)
                    data[A.offsets.index(0)] = 1.0 + torch.arange(
                        N ** 3, device=dev) % 3
                elif variant == "flip":
                    data = data.clone()
                    data[A.offsets.index(0), : N ** 3 // 2] *= -1.0
                pd = dia_align(data, A.offsets, A.shape[0])
                if (N, dt, None) in systems:
                    b = systems[N, dt, None][2]
                else:
                    b = rhs(N ** 3, dt, gen)
                systems[N, dt, variant] = (
                    pd, offsets_tensor(A.offsets, dev), b)
                del A, data
            pd, ot, b = systems[N, dt, variant]
            n = b.shape[0]
            if rhs_kind == "zero_rhs":
                b = torch.zeros_like(b)
            elif rhs_kind == "warm":
                b = b - dia_spmv_aligned_ref(pd, ot, torch.full_like(b, 0.5))
            if kw.pop("jacobi", False):
                kw = {"dinv": 1.0 / (6.0 + 0.5 * torch.sin(torch.arange(
                    n, device=dev, dtype=dt)))}
            shifts_t = None
            if "shifts" in kw:
                shifts_t = torch.tensor(kw.pop("shifts"), dtype=dt,
                                        device=dev)
                args = (shifts_t,) + tuple(args)
            kernel, plain = getattr(cf, name[:-4] + "_dia_fused"), \
                getattr(cf, name[:-4] + "_dia_fused_ref")
            k = kernel(pd, ot, b, *args, **kw)
            r = plain(pd, ot, b, *args, **kw)
            torch.cuda.synchronize()
            kints = [i for v in k[1:] if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            rints = [i for v in r[1:] if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            err = float((k[0] - r[0]).abs().max())
            rel = err / max(float(r[0].abs().max()), 1e-300)
            f32 = dt == torch.float32
            label = f"{name} {label} {N}^3 {'f32' if f32 else 'f64'}"
            ms, plain_ms, times = case_times(
                lambda: kernel(pd, ot, b, *args, **kw),
                lambda: plain(pd, ot, b, *args, **kw), name not in report,
                kints[0])
            if callable(nvec):
                bound_bytes = nvec(kints, pd.numel() * pd.element_size(),
                                   n * b.element_size())
                it_bytes = bound_bytes / max(kints[0], 1)
            else:
                it_bytes = (napply * pd.numel() * pd.element_size()
                            + nvec * n * b.element_size())
                bound_bytes = kints[0] * it_bytes
            if shifts_t is not None:
                # a shift's x and p (4 vectors read or written) move only
                # while it is active; its active iterations are those of
                # the same solve with that shift alone (the same Lanczos
                # stream and the same arithmetic for that shift)
                active = sum(int(kernel(pd, ot, b, shifts_t[i:i + 1],
                                        *args[1:], **kw)[1])
                             for i in range(shifts_t.shape[0]))
                bound_bytes += active * 4 * n * b.element_size()
                print(f"  shift-iterations active: {active} of "
                      f"{kints[0] * shifts_t.shape[0]}", flush=True)
            bound_ms = bound_bytes / bw * 1e3
            print(f"  {label}: kernel niter={kints[0]} codes={kints[1:]}; "
                  f"plain niter={rints[0]} codes={rints[1:]}; max_abs_err"
                  f"(x)={err:.3e} rel={rel:.3e}; bound_ms={bound_ms:.3f} "
                  f"({it_bytes / 1e6:.1f} MB per iteration x {kints[0]})"
                  f"{times}", flush=True)
            npass = name in ("gmres_dia", "fom_dia") and f32
            check(kints[1:len(kints) - npass] == rints[1:len(rints) - npass],
                  f"{label}: same status and flags as the plain version")
            # BiCGSTAB's and CGS's stopping iteration moves with the order
            # of the sums even in f64 (ROADMAP.md Queue 3, "Expected niter
            # drift"): they are held to the band, with x to 1e-8
            if f32 or name in ("bicgstab_dia", "cgs_dia"):
                check(abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0]),
                      f"{label}: niter {kints[0]} within ±max(2, 10%) of "
                      f"{rints[0]}")
                if npass:
                    check(abs(kints[-1] - rints[-1])
                          <= max(2, 0.1 * rints[-1]),
                          f"{label}: npass {kints[-1]} within ±max(2, 10%) "
                          f"of {rints[-1]}")
            else:
                check(kints[0] == rints[0],
                      f"{label}: niter {kints[0]} equals {rints[0]}")
            check(rel <= (1e-2 if f32 else 1e-8),
                  f"{label}: x agrees ({rel:.2e})")
            if name not in report:
                report[name] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by="bytes", library_ms=None)
        del systems

    with Phase("3b symmetric-solver kernels vs plain", 120):
        def cheby_case(label, N, dt, rtol, degree):
            n = N ** 3
            return (label, N, dt, "cg_cheby_dia",
                    (0.0, rtol, 2 * n, 0.4, 12.2, degree), {},
                    6 + 3 * (degree - 1), degree)

        def minres_case(label, N, dt, rtol, lam=0.0, jacobi=False):
            return (label, N, dt, "minres_dia",
                    (0.0, rtol, rtol, 1e-8, lam, 2 * N ** 3),
                    {"jacobi": jacobi}, 13 if jacobi else 10, 1)

        cases = [cheby_case("cheby degree 8", 128, torch.float32, 1e-6, 8),
                 cheby_case("cheby degree 1", 128, torch.float32, 1e-6, 1),
                 minres_case("minres M=I", 128, torch.float32, 1e-7),
                 minres_case("minres Jacobi", 128, torch.float32, 1e-7,
                             jacobi=True),
                 minres_case("minres lambda=0.5", 128, torch.float32, 1e-7,
                             lam=0.5),
                 ("cr", 128, torch.float32, "cr_dia",
                  (0.0, 1e-6, 2 * 128 ** 3), {}, 8, 1),
                 ("car", 128, torch.float32, "car_dia",
                  (0.0, 1e-6, 2 * 128 ** 3), {}, 12, 1),
                 cheby_case("cheby degree 8", 64, torch.float64, 1e-10, 8),
                 minres_case("minres M=I", 64, torch.float64, 1e-10),
                 ("cr", 64, torch.float64, "cr_dia",
                  (0.0, 1e-10, 2 * 64 ** 3), {}, 8, 1),
                 ("car", 64, torch.float64, "car_dia",
                  (0.0, 1e-10, 2 * 64 ** 3), {}, 12, 1)]
        hold_cases(cases, SEED + 1)

    with Phase("3c Lanczos-family kernels vs plain", 150):
        # cg_lanczos (with check_curvature on the indefinite stencil of
        # tests/test_fused.py:524-542), cg_lanczos_shift with shifts
        # (0, 0.5, 1, 2), and symmlq plain, with lambda = 0.5 and without
        # the CG-point transfer; per iteration each reads the diagonals
        # once and v, vprev, the next v and x and p (wbar) read and
        # written: 7 vectors (3, and 4 per active shift, for the shift
        # solver).
        shifts = [0.0, 0.5, 1.0, 2.0]

        def lanczos_cases(N, dt, rtol):
            n = N ** 3
            return [
                ("plain", N, dt, "cg_lanczos_dia", (0.0, rtol, 2 * n), {},
                 7, 1),
                ("check_curvature, indefinite", N, dt, "cg_lanczos_dia",
                 (0.0, rtol, 2 * n), {"flip": True,
                                      "check_curvature": True}, 7, 1),
                ("shifts (0, 0.5, 1, 2)", N, dt, "cg_lanczos_shift_dia",
                 (0.0, rtol, 2 * n), {"shifts": shifts}, 3, 1),
                ("plain", N, dt, "symmlq_dia",
                 (0.0, rtol, 1e-8, 0.0, 2 * n), {}, 7, 1),
                ("lambda=0.5", N, dt, "symmlq_dia",
                 (0.0, rtol, 1e-8, 0.5, 2 * n), {}, 7, 1),
                ("transfer_to_cg=False", N, dt, "symmlq_dia",
                 (0.0, rtol, 1e-8, 0.0, 2 * n), {"transfer_to_cg": False},
                 7, 1)]

        hold_cases(lanczos_cases(128, torch.float32, 1e-6)
                   + lanczos_cases(64, torch.float64, 1e-10), SEED + 2)

    with Phase("3d MINRES-QLP and MINARES kernels vs plain", 150):
        # each plain, with lambda = 0.5, with lambda = -2 (an indefinite
        # system, tests/test_fused.py:920-931 and 963-970) and on the
        # diagonal with three distinct eigenvalues, where MINARES's
        # Lanczos process stops at its breakdown while the iteration
        # finishes; Artol = 0, so that rtol alone stops the solve.  The
        # indefinite system needs thousands of iterations (3,800 at 32^3,
        # the plain version on the CPU), so it runs 200, where two f32
        # solves still agree to about 1e-5.  Per iteration MINRES-QLP
        # reads the diagonals once, v and v_{k-1}, writes the next v, and
        # reads and writes x, w_{k-1} and w_k (9 vectors); MINARES reads
        # v_k, v_{k+1}, two W and two D columns, writes the next v, one W
        # and one D column, and reads and writes x (11 vectors).
        def qlp_cases(N, dt, rtol):
            n = N ** 3
            cases = []
            for name, nvec in (("minres_qlp_dia", 9), ("minares_dia", 11)):
                cases += [
                    ("plain", N, dt, name, (0.0, rtol, 0.0, 0.0, 2 * n), {},
                     nvec, 1),
                    ("lambda=0.5", N, dt, name, (0.0, rtol, 0.0, 0.5, 2 * n),
                     {}, nvec, 1),
                    ("lambda=-2, 200 iterations", N, dt, name,
                     (0.0, rtol, 0.0, -2.0, 200), {}, nvec, 1),
                    ("three eigenvalues", N, dt, name,
                     (0.0, rtol, 0.0, 0.0, 2 * n),
                     {"three_eigenvalues": True}, nvec, 1)]
            return cases

        hold_cases(qlp_cases(128, torch.float32, 1e-6)
                   + qlp_cases(64, torch.float64, 1e-10), SEED + 4)

    with Phase("3e non-symmetric kernels vs plain", 300):
        # GMRES with memory 20 and restarts, with memory 20 and a bf16
        # Krylov panel, and with the memory of a solve without restart
        # (512); FOM with memory 20; BiCGSTAB and CGS, on the
        # convection-diffusion stencil (cell Peclet number 0.3) at 128^3
        # f32 and 64^3 f64, and each at 16^3 with b = 0 and with a warm
        # start.  CGS runs in f64 throughout: in f32 it does not converge
        # on this stencil at 128^3 (the kernel and its plain version both
        # stop on the alpha breakdown with a NaN x after about 900
        # iterations from a normal b, at any rtol from 3.45e-4 to 1e-6;
        # the plain version on the CPU diverges at 32^3 from b = 1 too),
        # since it squares the residual polynomial; its kernel's f32 and
        # f64 launches are one template.  Bounds: GMRES and FOM read the
        # diagonals once per stencil (each iteration, and each restart's
        # b - A x), v_0..v_k
        # once and write v_{k+1} in an iteration with k, read each basis
        # vector once more and x twice at a pass end, and b and x and
        # write v_0 at a restart (a bf16 panel's vectors at its width);
        # BiCGSTAB and CGS apply the stencil twice per iteration and read
        # or write 10 and 11 vectors.
        def arnoldi_bound(mem, panel_bytes=None):
            def bound(kints, pd_bytes, vbytes):
                niter, npass = kints[0], kints[-1]
                vb = vbytes if panel_bytes is None else panel_bytes(vbytes)
                restarts = max(npass - 1, 0)
                basis = sum(j % mem + 2 for j in range(niter)) + niter
                return ((niter + restarts) * pd_bytes + basis * vb
                        + npass * 2 * vbytes + restarts * (2 * vbytes + vb))
            return bound

        def nonsym_cases(N, dt, rtol):
            n = N ** 3
            cd = {"convdiff": True}
            bf16 = arnoldi_bound(20, lambda vbytes: vbytes * 2 // (
                4 if dt == torch.float32 else 8))
            return [
                ("memory 20", N, dt, "gmres_dia", (0.0, rtol, 2 * n, 20),
                 cd, arnoldi_bound(20), 1),
                ("memory 20, bf16 panel", N, dt, "gmres_dia",
                 (0.0, rtol, 2 * n, 20, torch.bfloat16), cd, bf16, 1),
                ("memory 512", N, dt, "gmres_dia", (0.0, rtol, 2 * n, 512),
                 cd, arnoldi_bound(512), 1),
                ("memory 20", N, dt, "fom_dia", (0.0, rtol, 2 * n, 20), cd,
                 arnoldi_bound(20), 1),
                ("convdiff", N, dt, "bicgstab_dia", (0.0, rtol, 2 * n), cd,
                 10, 2),
                ("convdiff", N, torch.float64, "cgs_dia",
                 (0.0, 1e-10, 2 * n), cd, 11, 2)]

        small = []
        for kind in ("zero_rhs", "warm"):
            for name, args, nvec in (
                    ("gmres_dia", (0.0, 1e-6, 8192, 20), arnoldi_bound(20)),
                    ("fom_dia", (0.0, 1e-6, 8192, 20), arnoldi_bound(20)),
                    ("bicgstab_dia", (0.0, 1e-6, 8192), 10),
                    ("cgs_dia", (0.0, 1e-10, 8192), 11)):
                small.append((kind, 16, torch.float64 if name == "cgs_dia"
                              else torch.float32, name, args,
                              {"convdiff": True, kind: True}, nvec, 2))
        hold_cases(nonsym_cases(128, torch.float32, 1e-6)
                   + nonsym_cases(64, torch.float64, 1e-10) + small,
                   SEED + 6)

    with Phase("3f truncated and two-sided kernels vs plain", 240):
        # DIOM and DQGMRES at memory 2, 6 and 20 (memory 2 gives DIOM a P
        # ring of one slot; neither converges at memory 2 on this stencil,
        # so those run 200 iterations), BiLQ with and without the BiCG
        # transfer, QMR and BiLQR, on the convection-diffusion stencil at
        # 128^3 f32 and 64^3 f64, and BiLQ, QMR and BiLQR also at 128^3
        # f64, their full-width paths: in f32 at 128^3 the two-sided
        # methods stop on residual estimates that have lost all accuracy
        # (BiLQ: true relative residuals of 84 and 32 for the kernel and
        # its plain version), so there BiLQ and QMR are held to the plain
        # version's status only and BiLQR's run is only printed (PERF.md
        # section 7).  Each other kernel against its plain
        # version on the same inputs: status and flags equal, niter within
        # +-max(2, 10%) for DIOM and DQGMRES (the two-sided kernels' niter
        # is printed, not held: their stops move with the rounding of
        # their residual estimates even in f64, BiLQ by 480 against 400
        # iterations at 128^3 and BiLQR by 252 against 309 at 64^3 with
        # x equal to 1e-9), x (and y) within 1e-2 relative in f32 and 1e-8
        # in f64 (1e-7 for the two-sided kernels, whose true residuals
        # reach only 1e-9 to 1e-8 at rtol 1e-10: BiLQR's x agrees to
        # 1.3e-8 at 128^3 after the same 541 iterations), and a true
        # relative residual ||b - Ax|| / ||b|| (and
        # ||c - A^H y|| / ||c||), from the plain SpMV in f64, no worse
        # than 1.5 times the plain version's (with 1e-9 of slack in f64,
        # where both sit at rounding level).  Bounds count bytes: the
        # diagonals once per stencil and the vectors the method must read
        # and write in each iteration -- DIOM and DQGMRES the window's
        # min(k + 1, mem) basis vectors and min(k, mP) directions, x twice,
        # the new p and v; BiLQ 10, QMR 11, BiLQR 15 vectors beside the
        # two stencils.
        def trunc_bound(mem, diom):
            mP = mem - 1 if diom else mem

            def bound(niter, pd_bytes, vbytes):
                return sum(pd_bytes + (min(k + 1, mem) + min(k, mP) + 4)
                           * vbytes for k in range(niter))
            return bound

        def slice6_cases(N, dt, rtol, report):
            n = N ** 3
            cases = []
            for variant in ("dqgmres", "diom"):
                for mem in (20, 6, 2):
                    itmax = 200 if mem == 2 else 2 * n
                    cases.append((
                        f"{variant} memory {mem}"
                        + (", 200 iterations" if mem == 2 else ""), N, dt,
                        "trunc_dia", (0.0, rtol, itmax, mem, variant),
                        trunc_bound(mem, variant == "diom"), 1,
                        report and variant == "dqgmres" and mem == 20))
            cases += [
                ("bilq", N, dt, "bilq_dia", (0.0, rtol, 2 * n, True), 10, 2,
                 report),
                ("bilq transfer_to_bicg=False", N, dt, "bilq_dia",
                 (0.0, rtol, 2 * n, False), 10, 2, False),
                ("qmr", N, dt, "qmr_dia", (0.0, rtol, 2 * n), 11, 2, report),
                ("bilqr", N, dt, "bilqr_dia", (0.0, rtol, 2 * n, True), 15, 2,
                 False)]
            return cases

        cases = (slice6_cases(128, torch.float32, 1e-6, True)
                 + slice6_cases(64, torch.float64, 1e-10, False)
                 + [c for c in slice6_cases(128, torch.float64, 1e-10, True)
                    if c[3] != "trunc_dia" and c[-1]]
                 + [("bilqr", 128, torch.float64, "bilqr_dia",
                     (0.0, 1e-10, 2 * 128 ** 3, True), 15, 2, True)])
        systems = {}
        gen = np.random.default_rng(SEED + 8)
        for label, N, dt, name, args, nvec, napply, to_report in cases:
            if (N, dt) not in systems:
                A = kt.convdiff_dia(N, dtype=dt)
                pd = dia_align(A.data, A.offsets, A.shape[0])
                pda, offa = kt.dia_align_adjoint(pd, A.offsets, A.shape[0])
                systems[N, dt] = (pd, offsets_tensor(A.offsets, dev), pda,
                                  offsets_tensor(offa, dev),
                                  rhs(N ** 3, dt, gen), rhs(N ** 3, dt, gen))
                del A
            pd, ot, pda, ota, b, c = systems[N, dt]
            n = b.shape[0]
            kernel = getattr(cf, name[:-4] + "_dia_fused")
            plain = getattr(cf, name[:-4] + "_dia_fused_ref")
            head = ((pd, ot, b) if name == "trunc_dia" else
                    (pd, pda, ot, ota, b) + ((c,) if name == "bilqr_dia"
                                             else ()))
            k = kernel(*head, *args)
            r = plain(*head, *args)
            torch.cuda.synchronize()
            kints = [i for v in k if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            rints = [i for v in r if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            nsol = 2 if name == "bilqr_dia" else 1
            err = max(float((k[i] - r[i]).abs().max()) for i in range(nsol))
            rel = max(float((k[i] - r[i]).abs().max())
                      / max(float(r[i].abs().max()), 1e-300)
                      for i in range(nsol))
            res_k = [true_rel_residual(pd, ot, b, k[0])]
            res_p = [true_rel_residual(pd, ot, b, r[0])]
            if nsol == 2:
                res_k.append(true_rel_residual(pda, ota, c, k[1]))
                res_p.append(true_rel_residual(pda, ota, c, r[1]))
            f32 = dt == torch.float32
            label = f"{name} {label} {N}^3 {'f32' if f32 else 'f64'}"
            to_report = to_report and (name == "trunc_dia" or not f32)
            ms, plain_ms, times = case_times(
                lambda: kernel(*head, *args), lambda: plain(*head, *args),
                to_report, kints[0])
            pd_bytes, vbytes = pd.numel() * pd.element_size(), \
                n * b.element_size()
            if callable(nvec):
                bound_bytes = nvec(kints[0], pd_bytes, vbytes)
            else:
                bound_bytes = kints[0] * (napply * pd_bytes + nvec * vbytes)
            bound_ms = bound_bytes / bw * 1e3
            print(f"  {label}: kernel niter={kints[0]} codes={kints[1:]}; "
                  f"plain niter={rints[0]} codes={rints[1:]}; max_abs_err="
                  f"{err:.3e} rel={rel:.3e}; true_res kernel "
                  f"{[f'{v:.3e}' for v in res_k]} plain "
                  f"{[f'{v:.3e}' for v in res_p]}; bound_ms={bound_ms:.3f} "
                  f"({bound_bytes / max(kints[0], 1) / 1e6:.1f} MB per "
                  f"iteration x {kints[0]}){times}", flush=True)
            if name != "trunc_dia" and f32:
                # the two-sided kernels in f32 stop on residual estimates
                # that have lost all accuracy, far apart from their plain
                # versions (PERF.md section 7); their full-width paths run
                # in f64.  BiLQ and QMR are held to the plain version's
                # status here; BiLQR's flags differ too, and its run is
                # only recorded
                if name != "bilqr_dia":
                    check(kints[1:] == rints[1:],
                          f"{label}: same status as the plain version")
                del k, r
                continue
            check(kints[1:] == rints[1:],
                  f"{label}: same status and flags as the plain version")
            if name == "trunc_dia":
                check(abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0]),
                      f"{label}: niter {kints[0]} within ±max(2, 10%) of "
                      f"{rints[0]}")
            # the two-sided kernels' true residuals reach only 1e-9 to
            # 1e-8 at rtol 1e-10 in f64 (their estimates lose digits), so
            # their x is held to 1e-7 there
            tol_x = 1e-2 if f32 else (1e-8 if name == "trunc_dia" else 1e-7)
            check(rel <= tol_x, f"{label}: x agrees ({rel:.2e} <= "
                  f"{tol_x:g})")
            slack = 0.0 if f32 else 1e-9
            check(all(a <= 1.5 * p + slack for a, p in zip(res_k, res_p)),
                  f"{label}: true residuals no worse than 1.5 x the plain "
                  f"version's")
            if to_report:
                report[name] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by="bytes", library_ms=None)
            del k, r
        del systems


    def shifted_dia(N, dtype=torch.float32):
        """convdiff_dia(N) with 0.5 added to its main diagonal: the SSY
        solvers' stencil (PERF.md section 4)."""
        A = kt.convdiff_dia(N, dtype=dtype)
        A.data[A.offsets.index(0)] += 0.5
        return A

    with Phase("3g SSY kernels vs plain", 240):
        # USYMLQ (with and without the USYMCG transfer), USYMQR, TriLQR and
        # USYMLQR (ls and ln, ls alone, ln alone) on the convection-
        # diffusion stencil with 0.5 on its main diagonal, at 128^3 f32
        # (rtol 1e-6, the full-width path) and 64^3 f64 (rtol 1e-10), and
        # with b = 0.  Each kernel against its plain version on the same
        # inputs: status and flags equal, niter within +-max(2, 10%), and
        # x (and y) within 1e-7 relative in f64; in f32 the true relative
        # residuals (f64, the plain SpMV: ||b - Ax|| for USYMLQ and USYMQR,
        # with ||c - A^H y|| for TriLQR; the saddle blocks b - x - Ay and
        # c - A^H x for USYMLQR) no worse than 1.5 times the plain
        # version's.  Bounds count bytes: the diagonals of A and A^H once
        # each and the vectors each method must read and write -- USYMLQ
        # 10, USYMQR 11, TriLQR 15, USYMLQR 19 (the headers of csrc/*.cu).
        def ssy_cases(N, dt, rtol, report):
            n = N ** 3
            return [
                ("usymlq", N, dt, "usymlq_dia", (0.0, rtol, 2 * n), {}, 10,
                 report),
                ("usymlq transfer_to_usymcg=False", N, dt, "usymlq_dia",
                 (0.0, rtol, 2 * n), {"transfer_to_usymcg": False}, 10,
                 False),
                ("usymqr", N, dt, "usymqr_dia", (0.0, rtol, 2 * n), {}, 11,
                 report),
                ("trilqr", N, dt, "trilqr_dia", (0.0, rtol, 2 * n), {}, 15,
                 report),
                ("usymlqr", N, dt, "usymlqr_dia", (0.0, rtol, 2 * n), {}, 19,
                 report),
                ("usymlqr ls", N, dt, "usymlqr_dia", (0.0, rtol, 2 * n),
                 {"ln": False}, 19, False),
                ("usymlqr ln", N, dt, "usymlqr_dia", (0.0, rtol, 2 * n),
                 {"ls": False}, 19, False),
                ("usymlq b = 0", N, dt, "usymlq_dia", (0.0, rtol, 2 * n),
                 {"zero_rhs": True}, 10, False),
                ("usymqr b = 0", N, dt, "usymqr_dia", (0.0, rtol, 2 * n),
                 {"zero_rhs": True}, 11, False),
                ("usymlqr b = 0", N, dt, "usymlqr_dia", (0.0, rtol, 2 * n),
                 {"zero_rhs": True}, 19, False)]

        cases = (ssy_cases(128, torch.float32, 1e-6, True)
                 + ssy_cases(64, torch.float64, 1e-10, False))
        systems = {}
        gen = np.random.default_rng(SEED + 11)
        for label, N, dt, name, args, kw, nvec, to_report in cases:
            kw = dict(kw)
            zero_rhs = kw.pop("zero_rhs", False)
            if (N, dt) not in systems:
                A = shifted_dia(N, dt)
                pd = dia_align(A.data, A.offsets, A.shape[0])
                pda, offa = kt.dia_align_adjoint(pd, A.offsets, A.shape[0])
                systems[N, dt] = (pd, offsets_tensor(A.offsets, dev), pda,
                                  offsets_tensor(offa, dev),
                                  rhs(N ** 3, dt, gen), rhs(N ** 3, dt, gen))
                del A
            pd, ot, pda, ota, b, c = systems[N, dt]
            if zero_rhs:
                b = torch.zeros_like(b)
            n = b.shape[0]
            kernel = getattr(cf, name[:-4] + "_dia_fused")
            plain = getattr(cf, name[:-4] + "_dia_fused_ref")
            head = (pd, pda, ot, ota, b, c)
            k = kernel(*head, *args, **kw)
            r = plain(*head, *args, **kw)
            torch.cuda.synchronize()
            nsol = 2 if name in ("trilqr_dia", "usymlqr_dia") else 1
            kints = [i for v in k[nsol:] if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            rints = [i for v in r[nsol:] if v.dtype == torch.int32
                     for i in v.reshape(-1).tolist()]
            err = max(float((k[i] - r[i]).abs().max()) for i in range(nsol))
            rel = max(float((k[i] - r[i]).abs().max())
                      / max(float(r[i].abs().max()), 1e-300)
                      for i in range(nsol))
            # the right-hand side each sweep solves: USYMLQR's ls sweep
            # alone solves [I A; A^H 0][x; y] = [b; 0], its ln sweep alone
            # [0; c]
            b_eff = torch.zeros_like(b) if kw.get("ls") is False else b
            c_eff = torch.zeros_like(c) if kw.get("ln") is False else c
            res_k, res_p = (ssy_residuals(name, pd, ot, pda, ota, b_eff,
                                          c_eff, v) for v in (k, r))
            f32 = dt == torch.float32
            label = f"{name} {label} {N}^3 {'f32' if f32 else 'f64'}"
            ms, plain_ms, times = case_times(
                lambda: kernel(*head, *args, **kw),
                lambda: plain(*head, *args, **kw), to_report, kints[0])
            it_bytes = (2 * pd.numel() * pd.element_size()
                        + nvec * n * b.element_size())
            bound_ms = kints[0] * it_bytes / bw * 1e3
            print(f"  {label}: kernel niter={kints[0]} codes={kints[1:]}; "
                  f"plain niter={rints[0]} codes={rints[1:]}; max_abs_err="
                  f"{err:.3e} rel={rel:.3e}; true_res kernel "
                  f"{[f'{v:.3e}' for v in res_k]} plain "
                  f"{[f'{v:.3e}' for v in res_p]}; bound_ms={bound_ms:.3f} "
                  f"({it_bytes / 1e6:.1f} MB per iteration x {kints[0]})"
                  f"{times}", flush=True)
            check(kints[1:] == rints[1:],
                  f"{label}: same status and flags as the plain version")
            check(abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0]),
                  f"{label}: niter {kints[0]} within ±max(2, 10%) of "
                  f"{rints[0]}")
            if f32:
                check(all(a <= 1.5 * p for a, p in zip(res_k, res_p)),
                      f"{label}: true residuals no worse than 1.5 x the "
                      f"plain version's")
            else:
                check(rel <= 1e-7, f"{label}: x agrees ({rel:.2e} <= 1e-7)")
            if to_report:
                report[name] = dict(max_abs_err=err, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bound_ms,
                                    bound_by="bytes", library_ms=None)
            del k, r
        del systems

    with Phase("3h Golub-Kahan kernels vs plain", 240):
        # LSQR, LSMR and LSLQ on the convection-diffusion stencil with 0.5
        # on its main diagonal at the entry points' default tolerances:
        # at 64^3 f64, status and flags equal, niter within
        # +-max(2, 10%) and x within 1e-7 relative; at 128^3 f32 (the
        # full-width path), status equal, niter within the band and the
        # true relative residual ||b - Ax|| / ||b|| (f64, the plain SpMV)
        # no worse than 1.5 times the plain version's.  Variants at 128^3
        # f32: b = 0, lambda = 0.1, a window of 12, LSLQ with sigma = 0.1
        # and with the transfer to the LSQR point; and the other stops:
        # LSLQ at rtol 1e-6 in f32 (the forward-error lower bound, code
        # 44) and LSQR at rtol 1e-6 in f64 (code 20, the ||A^H r|| test).
        # Bounds count bytes: the diagonals of A and A^H once each and the
        # vectors each method must read and write, u, v, x and its
        # directions -- LSQR 8, LSMR 10, LSLQ 8 (the headers of csrc/*.cu).
        nvecs = {"lsqr": 8, "lsmr": 10, "lslq": 8}
        cases = [(m, 64, torch.float64, {}, None, False)
                 for m in ("lsqr", "lsmr", "lslq")]
        cases += [(m, 128, torch.float32, {}, None, True)
                  for m in ("lsqr", "lsmr", "lslq")]
        cases += [("lsqr", 128, torch.float32, {"zero_rhs": True}, None,
                   False),
                  ("lslq", 128, torch.float32, {"zero_rhs": True}, None,
                   False),
                  ("lsqr", 128, torch.float32, {"lam": 0.1}, None, False),
                  ("lsmr", 128, torch.float32, {"lam": 0.1}, None, False),
                  ("lslq", 128, torch.float32, {"lam": 0.1}, None, False),
                  ("lsmr", 128, torch.float32, {"window": 12}, None, False),
                  ("lslq", 128, torch.float32, {"sigma": 0.1}, None, False),
                  ("lslq", 128, torch.float32, {"transfer": True}, None,
                   False),
                  ("lslq", 128, torch.float32, {"rtol": 1e-6}, 44, False),
                  ("lsqr", 128, torch.float64, {"rtol": 1e-6}, 20, False)]
        systems = {}
        gen = np.random.default_rng(SEED + 14)
        for method, N, dt, kw, want_code, to_report in cases:
            kw = dict(kw)
            zero_rhs = kw.pop("zero_rhs", False)
            if (N, dt) not in systems:
                A = shifted_dia(N, dt)
                pd = dia_align(A.data, A.offsets, A.shape[0])
                pda, offa = kt.dia_align_adjoint(pd, A.offsets, A.shape[0])
                systems[N, dt] = (pd, offsets_tensor(A.offsets, dev), pda,
                                  offsets_tensor(offa, dev),
                                  rhs(N ** 3, dt, gen))
                del A
            pd, ot, pda, ota, b = systems[N, dt]
            if zero_rhs:
                b = torch.zeros_like(b)
            n = b.shape[0]
            args, kwargs = gk_args(method, dt, n, **kw)
            kernel = getattr(cf, method + "_dia_fused")
            plain = getattr(cf, method + "_dia_fused_ref")
            head = (pd, pda, ot, ota, b)
            k = kernel(*head, *args, **kwargs)
            r = plain(*head, *args, **kwargs)
            torch.cuda.synchronize()
            kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
            rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
            err = float((k[0] - r[0]).abs().max())
            rel = err / max(float(r[0].abs().max()), 1e-300)
            res_k = ls_residuals(pd, ot, pda, ota, b, k[0])
            res_p = ls_residuals(pd, ot, pda, ota, b, r[0])
            f32 = dt == torch.float32
            label = (f"{method}_dia {kw or 'default'}"
                     f"{' b = 0' if zero_rhs else ''} {N}^3 "
                     f"{'f32' if f32 else 'f64'}")
            to_report = to_report and f32
            ms, plain_ms, times = case_times(
                lambda: kernel(*head, *args, **kwargs),
                lambda: plain(*head, *args, **kwargs), to_report, kints[0])
            it_bytes = (2 * pd.numel() * pd.element_size()
                        + nvecs[method] * n * b.element_size())
            bound_ms = kints[0] * it_bytes / bw * 1e3
            print(f"  {label}: kernel niter={kints[0]} codes={kints[1:]}; "
                  f"plain niter={rints[0]} codes={rints[1:]}; max_abs_err="
                  f"{err:.3e} rel={rel:.3e}; true_res kernel "
                  f"{res_k[0]:.3e} plain {res_p[0]:.3e}; ||A^H r|| kernel "
                  f"{res_k[1]:.3e} plain {res_p[1]:.3e}; bound_ms="
                  f"{bound_ms:.3f} ({it_bytes / 1e6:.1f} MB per iteration x "
                  f"{kints[0]}){times}", flush=True)
            if f32:
                check(kints[1] == rints[1],
                      f"{label}: same status as the plain version")
            else:
                check(kints[1:] == rints[1:],
                      f"{label}: same status and flags as the plain version")
            check(abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0]),
                  f"{label}: niter {kints[0]} within ±max(2, 10%) of "
                  f"{rints[0]}")
            if zero_rhs:
                check(kints[0] == 0 and not bool(k[0].any())
                      and kints[1] == 2,
                      f"{label}: x = 0, zero residual, no iteration")
            elif f32:
                check(res_k[0] <= 1.5 * res_p[0],
                      f"{label}: true residual {res_k[0]:.2e} no worse than "
                      f"1.5 x the plain version's {res_p[0]:.2e}")
            else:
                check(rel <= 1e-7, f"{label}: x agrees ({rel:.2e} <= 1e-7)")
            if want_code is not None:
                check(kints[1] == want_code,
                      f"{label}: stopped on code {want_code}")
            if to_report:
                report[method + "_dia"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="bytes", library_ms=None)
            del k, r
        del systems

    with Phase("3i least-norm kernels vs plain", 240):
        # CRAIG, CRAIGMR, LNLQ and CGNE/CRMR (by variant) on the
        # convection-diffusion stencil with 0.5 on its main diagonal at the
        # entry points' default tolerances, 64^3 f64 and 128^3 f32 (the
        # full-width path), each kernel against its plain version on the
        # same inputs: every int output (status, niter) equal but niter,
        # which is held to +-max(2, 10%); the true relative residual
        # ||b - Ax|| / ||b|| (f64, the plain SpMV) no worse than 1.5 times
        # the plain version's; in f64 also x (and y) within 1e-6 relative.
        # Variants at 128^3 f32: lambda = 0.3, b = 0 and LNLQ without the
        # transfer to the CRAIG point.  In f32 CRAIG stops on its
        # backward-error test at about 5e-3 true residual, as the JAX
        # package's kernel does (ROADMAP.md watch list).  Bounds count
        # bytes: the diagonals of A and A^H once each and the vectors each
        # method must read and write -- CRAIG u, v, x, w, y; CRAIGMR also
        # d, w_bar; LNLQ u, v, x, y, w_bar; CGNE/CRMR p, r, x; each read
        # and written, and with lambda w2, q or s besides (the headers of
        # csrc/*.cu).  ms, plain ms and the bound for the default f32
        # cases.
        ln_nvecs = {"craig": 10, "craigmr": 14, "lnlq": 10, "cgne_crmr": 6}
        ln_cases = {"craig": ("craig", {}), "craigmr": ("craigmr", {}),
                    "lnlq": ("lnlq", {}),
                    "cgne": ("cgne_crmr", {"variant": "cgne"}),
                    "crmr": ("cgne_crmr", {"variant": "crmr"})}

        def ln_args(kernel, dt, n, lam=0.0):
            """The arguments after (pd, pda, ot, ota, b) of a least-norm
            kernel at the entry points' defaults: sqrt eps(T) for atol,
            rtol (and CRAIG's btol), conlim 1e8, itmax m + n."""
            tol = rt.default_tol(None, dt)
            if kernel == "craig":
                return (lam, tol, tol, tol, 1e8, 2 * n)
            return (lam, tol, tol, 2 * n)

        cases = [(m, 64, torch.float64, {}) for m in ln_cases]
        cases += [(m, 128, torch.float32, {}) for m in ln_cases]
        cases += [(m, 128, torch.float32, {"lam": 0.3}) for m in ln_cases]
        cases += [(m, 128, torch.float32, {"zero_rhs": True})
                  for m in ("craig", "craigmr", "lnlq", "cgne")]
        cases += [("lnlq", 128, torch.float32, {"transfer_to_craig": False})]
        systems = {}
        gen = np.random.default_rng(SEED + 16)
        for method, N, dt, kw in cases:
            kw = dict(kw)
            zero_rhs = kw.pop("zero_rhs", False)
            lam = kw.pop("lam", 0.0)
            kernel_name, kwargs = ln_cases[method]
            kwargs = dict(kwargs, **kw)
            if lam > 0 and kernel_name != "cgne_crmr":
                kwargs["use_lam"] = True
            if (N, dt) not in systems:
                A = shifted_dia(N, dt)
                pd = dia_align(A.data, A.offsets, A.shape[0])
                pda, offa = kt.dia_align_adjoint(pd, A.offsets, A.shape[0])
                systems[N, dt] = (pd, offsets_tensor(A.offsets, dev), pda,
                                  offsets_tensor(offa, dev),
                                  rhs(N ** 3, dt, gen))
                del A
            pd, ot, pda, ota, b = systems[N, dt]
            if zero_rhs:
                b = torch.zeros_like(b)
            n = b.shape[0]
            args = ln_args(kernel_name, dt, n, lam)
            kernel = getattr(cf, kernel_name + "_dia_fused")
            plain = getattr(cf, kernel_name + "_dia_fused_ref")
            head = (pd, pda, ot, ota, b)
            nvec = 1 if kernel_name == "cgne_crmr" else 2
            k = kernel(*head, *args, **kwargs)
            r = plain(*head, *args, **kwargs)
            torch.cuda.synchronize()
            kints = [int(v) for v in k[nvec:] if v.dtype == torch.int32]
            rints = [int(v) for v in r[nvec:] if v.dtype == torch.int32]
            err = max(float((a - w).abs().max())
                      for a, w in zip(k[:nvec], r[:nvec]))
            rel = max(float((a - w).abs().max())
                      / max(float(w.abs().max()), 1e-300)
                      for a, w in zip(k[:nvec], r[:nvec]))
            f32 = dt == torch.float32
            label = (f"{method} {f'{kw} ' if kw else ''}"
                     f"{'lam = 0.3 ' if lam else ''}"
                     f"{'b = 0 ' if zero_rhs else ''}{N}^3 "
                     f"{'f32' if f32 else 'f64'}")
            timed = f32 and not (kw or lam or zero_rhs)
            line = (f"  {label}: kernel niter={kints[0]} codes={kints[1:]}; "
                    f"plain niter={rints[0]} codes={rints[1:]}; "
                    f"max_abs_err={err:.3e} rel={rel:.3e}")
            if not zero_rhs:
                res_k = true_rel_residual(pd, ot, b, k[0])
                res_p = true_rel_residual(pd, ot, b, r[0])
                line += f"; true_res kernel {res_k:.3e} plain {res_p:.3e}"
            if timed:
                ms = event_ms(lambda: kernel(*head, *args, **kwargs), reps=3,
                              warmup=0)
                plain_ms = event_ms(lambda: plain(*head, *args, **kwargs),
                                    reps=1, warmup=0)
                it_bytes = (2 * pd.numel() * pd.element_size()
                            + ln_nvecs[kernel_name] * n * b.element_size())
                bound_ms = kints[0] * it_bytes / bw * 1e3
                line += (f"; ms={ms:.3f} plain_ms={plain_ms:.3f} "
                         f"bound_ms={bound_ms:.3f} ({it_bytes / 1e6:.1f} MB "
                         f"per iteration x {kints[0]}; "
                         f"{1e3 * ms / max(kints[0], 1):.1f} us/iter)")
            print(line, flush=True)
            check(kints[1:] == rints[1:],
                  f"{label}: same status and flags as the plain version")
            check(abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0]),
                  f"{label}: niter {kints[0]} within ±max(2, 10%) of "
                  f"{rints[0]}")
            if zero_rhs:
                check(kints[0] == 0 and kints[1] == 2
                      and not any(bool(v.any()) for v in k[:nvec]),
                      f"{label}: x = 0, zero residual, no iteration")
            else:
                check(res_k <= 1.5 * res_p,
                      f"{label}: true residual {res_k:.2e} no worse than "
                      f"1.5 x the plain version's {res_p:.2e}")
                if not f32:
                    check(rel <= 1e-6, f"{label}: x agrees ({rel:.2e} <= "
                          "1e-6)")
            if timed and method != "crmr":
                report[kernel_name + "_dia"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="bytes", library_ms=None)
            del k, r
        del systems

    def ne_residual(pd, ot, pda, ota, b, x, lam):
        """||A^H (b - Ax) - lam x|| / ||A^H b|| in f64 with the plain SpMV:
        the optimality residual of min ||b - Ax||^2 + lam ||x||^2 (0/0
        read as 0 where b = 0)."""
        xd = x.double()
        g = dia_spmv_aligned_ref(pda.double(), ota, b.double()
                                 - dia_spmv_aligned_ref(pd.double(), ot, xd))
        nb = float(dia_spmv_aligned_ref(pda.double(), ota,
                                        b.double()).norm())
        r = float((g - lam * xd).norm())
        return r / nb if nb > 0 else r

    def block_residual(pd, ot, pda, ota, b, c, x, y, tau, nu):
        """||[b; c] - [tau I A; A^H nu I][x; y]|| / ||[b; c]|| in f64 with
        the plain SpMV: TriCG's true relative residual."""
        xd, yd = x.double(), y.double()
        top = b.double() - (tau * xd + dia_spmv_aligned_ref(pd.double(), ot,
                                                            yd))
        bot = c.double() - (dia_spmv_aligned_ref(pda.double(), ota, xd)
                            + nu * yd)
        nbc = float(torch.sqrt(b.double().norm() ** 2
                               + c.double().norm() ** 2))
        r = float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))
        return r / nbc if nbc > 0 else r

    nq_shifts = [0.1, 1.0]

    def nq_system(N, dt, poisson, gen):
        """(pd, ot, pda, ota, b, c): convdiff_dia(N), or poisson_dia(N) for
        TriCG, its aligned diagonals and those of A^H, b and c seeded."""
        A = (kt.poisson_dia if poisson else kt.convdiff_dia)(N, dtype=dt)
        pd = dia_align(A.data, A.offsets, A.shape[0])
        pda, offa = kt.dia_align_adjoint(pd, A.offsets, A.shape[0])
        out = (pd, offsets_tensor(A.offsets, dev), pda,
               offsets_tensor(offa, dev), rhs(N ** 3, dt, gen),
               rhs(N ** 3, dt, gen))
        del A
        return out

    with Phase("3j normal-equation and TriCG kernels vs plain", 240):
        # CGLS, CRLS and CGLS-Lanczos-shift (shifts 0.1 and 1) on the
        # convection-diffusion stencil and TriCG on the Poisson stencil,
        # at 64^3 f64 and 128^3 f32 (the full-width path), at the entry
        # points' default tolerances (sqrt eps), each kernel against its
        # plain version on the same inputs: every int output (status,
        # indefinite flags) equal but niter, which is held to +-max(2,
        # 10%) (TriCG's to +-max(3, 10%): its stop moves by 1 to 3
        # iterations near the threshold, tests/test_fused.py:1145-1149);
        # in f64 x (and y) within 1e-6 relative; the true relative
        # residual (f64, the plain SpMV: the normal-equation residual
        # ||A^H (b - Ax) - lam x|| / ||A^H b|| for the CGLS family, every
        # shift's, and the block residual for TriCG) no worse than 1.5
        # times the plain version's.  Variants: lam = 0 (lam = 0.1 is the
        # main path's), b = 0, and TriCG's spd and flip presets; spd
        # ([I A; A I], indefinite for the Poisson stencil, 48274
        # iterations at 64^3 in f64) is capped at 200 iterations and held
        # to the capped trajectory.  Bounds count bytes: the diagonals of
        # A and A^H once each per iteration and the vectors each method
        # must read and write -- CGLS x, r, p; CRLS x, r, Ar, p, Ap, q;
        # each read and written; the shift solver v and v_prev read and
        # the next v written, and each shift's x and p read and written
        # while it is active (a shift's active iterations are those of the
        # same solve with that shift alone); TriCG v_k, u_k, v_{k-1},
        # u_{k-1}, the four directions, x and y read, and v_{k+1}, u_{k+1},
        # the directions, x and y written (the headers of csrc/*.cu).  ms,
        # plain ms and the bound for the main path's cases (128^3 f32,
        # lam = 0.1, TriCG's default preset).
        nq_nvecs = {"cgls": 6, "crls": 12, "cgls_lanczos_shift": 3,
                    "tricg": 18}
        nq_cases = []
        for N, dt in ((64, torch.float64), (128, torch.float32)):
            for name in ("cgls", "crls", "cgls_lanczos_shift", "tricg"):
                nq_cases.append((name, N, dt, {}))
                nq_cases.append((name, N, dt, {"zero_rhs": True}))
            nq_cases += [("cgls", N, dt, {"lam": 0.0}),
                         ("crls", N, dt, {"lam": 0.0}),
                         ("tricg", N, dt, {"preset": "flip"}),
                         ("tricg", N, dt, {"preset": "spd"})]
        presets = {None: (1.0, -1.0), "flip": (-1.0, 1.0), "spd": (1.0, 1.0)}
        systems = {}
        gen = np.random.default_rng(SEED + 18)
        for name, N, dt, kw in nq_cases:
            kw = dict(kw)
            zero_rhs = kw.pop("zero_rhs", False)
            lam = kw.pop("lam", 0.1)
            preset = kw.pop("preset", None)
            tricg = name == "tricg"
            if (N, dt, tricg) not in systems:
                systems[N, dt, tricg] = nq_system(N, dt, tricg, gen)
            pd, ot, pda, ota, b, c = systems[N, dt, tricg]
            if zero_rhs:
                b, c = torch.zeros_like(b), torch.zeros_like(c)
            n = b.shape[0]
            tol = rt.default_tol(None, dt)
            itmax = 200 if preset == "spd" else 2 * n
            shifts_t = torch.tensor(nq_shifts, dtype=dt, device=dev)
            if tricg:
                tau, nu = presets[preset]
                head, args = (pd, pda, ot, ota, b, c), (tau, nu, tol, tol,
                                                        itmax)
                nvec, ncode = 2, 4
            else:
                head = (pd, pda, ot, ota, b)
                args = ((shifts_t if name == "cgls_lanczos_shift" else lam),
                        tol, tol, itmax)
                nvec, ncode = 1, (3 if name == "cgls_lanczos_shift" else 4)
            kernel = getattr(cf, name + "_dia_fused")
            plain = getattr(cf, name + "_dia_fused_ref")
            k = kernel(*head, *args)
            r = plain(*head, *args)
            torch.cuda.synchronize()
            it_k, it_r = int(k[nvec]), int(r[nvec])
            codes_k = [int(k[ncode])] + (k[4].tolist() if ncode == 3 else [])
            codes_r = [int(r[ncode])] + (r[4].tolist() if ncode == 3 else [])
            err = max(float((a - w).abs().max())
                      for a, w in zip(k[:nvec], r[:nvec]))
            rel = max(float((a - w).abs().max())
                      / max(float(w.abs().max()), 1e-300)
                      for a, w in zip(k[:nvec], r[:nvec]))
            f32 = dt == torch.float32
            label = (f"{name} {'lam = 0 ' if lam == 0 and not tricg else ''}"
                     f"{f'{preset} ' if preset else ''}"
                     f"{'b = 0 ' if zero_rhs else ''}{N}^3 "
                     f"{'f32' if f32 else 'f64'}")
            timed = f32 and not zero_rhs and lam == 0.1 and preset is None
            line = (f"  {label}: kernel niter={it_k} codes={codes_k}; "
                    f"plain niter={it_r} codes={codes_r}; "
                    f"max_abs_err={err:.3e} rel={rel:.3e}")
            if tricg:
                res_k = block_residual(pd, ot, pda, ota, b, c, k[0], k[1],
                                       tau, nu)
                res_p = block_residual(pd, ot, pda, ota, b, c, r[0], r[1],
                                       tau, nu)
            elif name == "cgls_lanczos_shift":
                res_k = max(ne_residual(pd, ot, pda, ota, b, k[0][i], lm)
                            for i, lm in enumerate(nq_shifts))
                res_p = max(ne_residual(pd, ot, pda, ota, b, r[0][i], lm)
                            for i, lm in enumerate(nq_shifts))
            else:
                res_k = ne_residual(pd, ot, pda, ota, b, k[0], lam)
                res_p = ne_residual(pd, ot, pda, ota, b, r[0], lam)
            line += f"; true_res kernel {res_k:.3e} plain {res_p:.3e}"
            if timed:
                ms = event_ms(lambda: kernel(*head, *args), reps=3,
                              warmup=0)
                plain_ms = event_ms(lambda: plain(*head, *args), reps=1,
                                    warmup=0)
                vec = n * b.element_size()
                bound_bytes = it_k * (2 * pd.numel() * pd.element_size()
                                      + nq_nvecs[name] * vec)
                if name == "cgls_lanczos_shift":
                    active = sum(int(kernel(*head, shifts_t[i:i + 1],
                                            *args[1:])[1])
                                 for i in range(len(nq_shifts)))
                    bound_bytes += active * 4 * vec
                    line += f"; shift-iterations active {active}"
                bound_ms = bound_bytes / bw * 1e3
                line += (f"; ms={ms:.3f} plain_ms={plain_ms:.3f} "
                         f"bound_ms={bound_ms:.3f} ({bound_bytes / 1e6:.1f} "
                         f"MB; {1e3 * ms / max(it_k, 1):.1f} us/iter)")
            print(line, flush=True)
            check(codes_k == codes_r,
                  f"{label}: same status and flags as the plain version")
            band = max(3 if tricg else 2, 0.1 * it_r)
            check(abs(it_k - it_r) <= band,
                  f"{label}: niter {it_k} within ±{band:g} of {it_r}")
            if zero_rhs:
                check(it_k == 0 and codes_k[0] == 2
                      and not any(bool(v.any()) for v in k[:nvec]),
                      f"{label}: x = 0, zero residual, no iteration")
                continue
            check(res_k <= 1.5 * res_p,
                  f"{label}: true residual {res_k:.2e} no worse than 1.5 x "
                  f"the plain version's {res_p:.2e}")
            if not f32:
                check(rel <= 1e-6, f"{label}: x agrees ({rel:.2e} <= 1e-6)")
            if timed:
                report[name + "_dia"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="bytes", library_ms=None)
            del k, r
        del systems

    def scaled_poisson(N, dtype):
        """K = 0.1 (P + I) (tools/exp_fused_all_tpu.py:72-85) and K^H from
        adjoint_dia(), the true transpose, as DIA operators: GPMR's cell."""
        P = kt.poisson_dia(N, dtype=dtype)
        P.data[P.offsets.index(0)] += 1.0
        K = kt.DIAOperator(kt.DIAMatrix(0.1 * P.data, P.offsets, P.shape))
        del P
        data, offs = K.adjoint_dia()
        return K, kt.DIAOperator(kt.DIAMatrix(data, offs, K.shape))

    def shifted_poisson(N, dtype, shift):
        """poisson_dia(N) + shift I as a DIA operator: block MINRES's cell
        (bench.py:485-497 with shift 0.5; tests/test_fused.py:335-348 with
        shift -1.5)."""
        P = kt.poisson_dia(N, dtype=dtype)
        P.data[P.offsets.index(0)] += shift
        return kt.DIAOperator(P)

    def stacked_residual(K, KH, b, c, x, y, lam, mu):
        """||[b; c] - [lam I K; K^H mu I][x; y]|| / ||[b; c]|| in f64 with
        the plain SpMV: GPMR's true relative residual."""
        xd, yd = x.double(), y.double()
        top = b.double() - (lam * xd + dia_spmv_aligned_ref(
            K._pd.double(), K._offsets, yd))
        bot = c.double() - (dia_spmv_aligned_ref(KH._pd.double(),
                                                 KH._offsets, xd) + mu * yd)
        nbc = float(torch.sqrt(b.double().norm() ** 2
                               + c.double().norm() ** 2))
        r = float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))
        return r / nbc if nbc > 0 else r

    def block_rel_residual(A, B, X):
        """||B - AX||_F / ||B||_F in f64 with the plain SpMV."""
        pd = A._pd.double()
        R = B.double() - torch.stack(
            [dia_spmv_aligned_ref(pd, A._offsets, X[:, j].double()
                                  .contiguous())
             for j in range(B.shape[1])], 1)
        return float(R.norm() / B.double().norm())

    with Phase("3k TriMR, GPMR and block MINRES kernels vs plain", 240):
        # TriMR on the Poisson stencil (tau = 1, nu = -1, and the flip
        # preset; tools/exp_fused_all_tpu.py:320-322), GPMR on
        # K = 0.1 (P + I) and K^H from adjoint_dia() (lam = 1, mu = -1,
        # memory 48, itmax 48; :323-326) and block MINRES on P + 0.5 I with
        # a seeded normal B of 4 columns (bench.py:485-497), and on the
        # indefinite P - 1.5 I at 64^3 f64 (tests/test_fused.py:335-348;
        # capped at 200 iterations and held to that trajectory: it
        # converges slowly at this size),
        # at 64^3 f64 and 128^3 f32, at the entry points' default
        # tolerances (sqrt eps), each kernel against its plain version on
        # the same inputs: the same status (and GPMR's inconsistent flag),
        # niter within +-3 (TriMR), +-1 (GPMR) and +-2 (block MINRES), the
        # JAX package's own spreads (tests/test_fused.py:1147, 1514, 345);
        # in f64 x (and y, X) within 1e-6 relative; the true relative
        # residual (f64, the plain SpMV: the block residual, the stacked
        # residual, ||B - AX||_F / ||B||_F) no worse than 1.5 times the
        # plain version's.  Bounds count bytes (the headers of the .cu
        # files): TriMR the two stencils and 14 vectors read, 8 written
        # per iteration; GPMR per iteration k the two stencils, the 2k
        # basis vectors read and the two new ones written, and after the
        # loop the 2 niter basis vectors read and x, y written; block
        # MINRES the stencil once and 8p vectors per iteration, and B read
        # and V_1 written at the start.  ms, plain ms and the bound for
        # the main path's cases (128^3 f32: TriMR's default preset, GPMR,
        # block MINRES with P + 0.5 I).
        sl_cases = []
        for N, dt in ((64, torch.float64), (128, torch.float32)):
            sl_cases += [("trimr", N, dt, None), ("trimr", N, dt, "flip"),
                         ("gpmr", N, dt, None), ("block_minres", N, dt, 0.5)]
        sl_cases.append(("block_minres", 64, torch.float64, -1.5))
        gen = np.random.default_rng(SEED + 20)
        for name, N, dt, variant in sl_cases:
            n = N ** 3
            tol = rt.default_tol(None, dt)
            f32 = dt == torch.float32
            if name == "trimr":
                pd, ot, pda, ota, b, c = nq_system(N, dt, True, gen)
                tau, nu = (-1.0, 1.0) if variant == "flip" else (1.0, -1.0)
                head = (pd, pda, ot, ota, b, c)
                args, kw = (tau, nu, tol, tol, 2 * n), {}
                nvec, ncode, band = 2, 4, 3
                nd2 = 2 * pd.numel() * pd.element_size()
            elif name == "gpmr":
                K, KH = scaled_poisson(N, dt)
                b, c = rhs(n, dt, gen), rhs(n, dt, gen)
                head = (K._pd, KH._pd, K._offsets, KH._offsets, b, c)
                args, kw = (1.0, -1.0, tol, tol, 48), {"mem": 48}
                nvec, ncode, band = 2, 4, 1
                nd2 = (K._pd.numel() + KH._pd.numel()) * K._pd.element_size()
            else:
                A = shifted_poisson(N, dt, variant)
                gb = torch.as_tensor(gen.standard_normal((n, 4)))
                B = gb.to(dev, dt)
                head = (A._pd, A._offsets, B)
                # the indefinite system converges slowly at 64^3 (1.2e-2
                # relative after 3000 iterations), so it runs 200
                args = (tol, tol, 200 if variant < 0 else 2 * (n // 4))
                kw, nvec, ncode, band = {}, 1, 3, 2
            kernel = getattr(cf, name + "_dia_fused")
            plain = getattr(cf, name + "_dia_fused_ref")
            k = kernel(*head, *args, **kw)
            r = plain(*head, *args, **kw)
            torch.cuda.synchronize()
            it_k, it_r = int(k[nvec]), int(r[nvec])
            codes_k = [int(k[ncode])] + ([int(k[5])] if name == "gpmr"
                                         else [])
            codes_r = [int(r[ncode])] + ([int(r[5])] if name == "gpmr"
                                         else [])
            err = max(float((a - w).abs().max())
                      for a, w in zip(k[:nvec], r[:nvec]))
            rel = max(float((a - w).abs().max())
                      / max(float(w.abs().max()), 1e-300)
                      for a, w in zip(k[:nvec], r[:nvec]))
            if name == "trimr":
                res_k = block_residual(pd, ot, pda, ota, b, c, k[0], k[1],
                                       tau, nu)
                res_p = block_residual(pd, ot, pda, ota, b, c, r[0], r[1],
                                       tau, nu)
            elif name == "gpmr":
                res_k = stacked_residual(K, KH, b, c, k[0], k[1], 1.0, -1.0)
                res_p = stacked_residual(K, KH, b, c, r[0], r[1], 1.0, -1.0)
            else:
                res_k = block_rel_residual(A, B, k[0])
                res_p = block_rel_residual(A, B, r[0])
            label = (f"{name} {f'{variant} ' if variant else ''}{N}^3 "
                     f"{'f32' if f32 else 'f64'}")
            line = (f"  {label}: kernel niter={it_k} codes={codes_k}; "
                    f"plain niter={it_r} codes={codes_r}; max_abs_err="
                    f"{err:.3e} rel={rel:.3e}; true_res kernel {res_k:.3e} "
                    f"plain {res_p:.3e}")
            timed = f32 and variant in (None, 0.5)
            if timed:
                ms = event_ms(lambda: kernel(*head, *args, **kw), reps=3,
                              warmup=0)
                plain_ms = event_ms(lambda: plain(*head, *args, **kw),
                                    reps=1, warmup=0)
                vec = n * dt.itemsize
                if name == "trimr":
                    bound_bytes = it_k * (nd2 + 22 * vec)
                elif name == "gpmr":
                    bound_bytes = (sum(nd2 + (2 * j + 2) * vec
                                       for j in range(1, it_k + 1))
                                   + (2 * it_k + 2) * vec)
                else:
                    bound_bytes = (it_k * (A._pd.numel()
                                           * A._pd.element_size()
                                           + 8 * 4 * vec) + 2 * 4 * vec)
                bound_ms = bound_bytes / bw * 1e3
                line += (f"; ms={ms:.3f} plain_ms={plain_ms:.3f} "
                         f"bound_ms={bound_ms:.3f} ({bound_bytes / 1e6:.1f} "
                         f"MB; {1e3 * ms / max(it_k, 1):.1f} us/iter)")
            print(line, flush=True)
            check(codes_k == codes_r,
                  f"{label}: same status and flags as the plain version")
            check(abs(it_k - it_r) <= band,
                  f"{label}: niter {it_k} within ±{band} of {it_r}")
            check(res_k <= 1.5 * res_p,
                  f"{label}: true residual {res_k:.2e} no worse than 1.5 x "
                  f"the plain version's {res_p:.2e}")
            if not f32:
                check(rel <= 1e-6, f"{label}: x agrees ({rel:.2e} <= 1e-6)")
            if timed:
                report[name + "_dia"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="bytes", library_ms=None)
            del k, r, head

    from krylov_tpu_torch.ops import cuda_spmv as cspmv

    def bg_bound_bytes(A, n, p, mem, niter, dt):
        """Block GMRES's least bytes (csrc/block_gmres.cuh's header) for a
        solve of niter iterations whose passes end at k = mem - 1: at
        iteration k the diagonals, V_k, three sweeps over the (k+1)p
        basis vectors, W and V_{k+1}; at a pass end the kk p basis
        vectors and X read and written, and at a restart B and X read,
        V_0 written and the diagonals; at the start B read and V_0
        written."""
        s = dt.itemsize
        diag = A._pd.numel() * A._pd.element_size()
        total = 2 * p * n * s
        for j in range(niter):
            k = j % mem
            total += diag + n * p * s * (3 * (k + 1) + 3)
            if k == mem - 1 or j == niter - 1:
                total += n * p * s * (k + 1 + 2)
                if j < niter - 1:
                    total += diag + 3 * n * p * s
        return total

    with Phase("3l block GMRES and block-ELL kernels vs plain", 240):
        # Block GMRES on the 128^3 Poisson stencil + 0.5 I, B seeded
        # normal with 4 columns, memory 32 with restarts (bench.py:
        # 483-497's block_gmres_shifted_poisson cell at the flagship
        # size), at the default tolerances in f32, in f64 and in f32 with
        # a bf16 basis, and at memory 8 with rtol 1e-8 in f64 (restarts);
        # the kernel against its plain version on the same inputs: the
        # same status and inconsistent flag, niter and the pass count
        # within ±2 (the dots and the back substitution summed in other
        # orders), in f64 with an f64 basis X within 1e-6 of max(|X|,
        # |B|), ‖B − AX‖_F (f64, the plain SpMV) no worse than 1.5 times
        # the plain version's; the f64 restart run passes a restart.
        # Then bell_spmv and bell_spmm (p = 4 and 8) on the SPD
        # block-tridiagonal BELL at nb = 1024 block rows of 128 (201.3 MB
        # of f32 blocks, four times the L2) and at bench.py:714-728's
        # nb = 96, in f32 and f64: max |Δ| ≤ 1e-5 max|y| (f32), 1e-12
        # max|y| (f64), BELLOperator's bound plan bit for bit the public
        # wrapper's; ms by CUDA events, device ms by the profiler and host
        # us per call (BELLOperator's and the public wrapper's), the plain
        # version's ms and the library yardstick's (a BSR product of the
        # same blocks).  Bounds count bytes: the blocks, their indices, x
        # and y once.
        gen = np.random.default_rng(SEED + 30)
        n = 128 ** 3
        for dt, mem, basis, rtol in ((torch.float32, 32, None, None),
                                     (torch.float64, 32, None, None),
                                     (torch.float32, 32, torch.bfloat16,
                                      None),
                                     (torch.float64, 8, None, 1e-8)):
            A = shifted_poisson(128, dt, 0.5)
            B = torch.as_tensor(gen.standard_normal((n, 4))).to(dev, dt)
            tol = rt.default_tol(None, dt)
            args = (A._pd, A._offsets, B, tol, tol if rtol is None else rtol,
                    2 * (n // 4), mem, basis)
            k = cf.block_gmres_dia_fused(*args)
            r = cf.block_gmres_dia_fused_ref(*args)
            torch.cuda.synchronize()
            it_k, code_k, inc_k, np_k = (int(v) for v in (k[1], k[3], k[4],
                                                          k[5]))
            it_r, code_r, inc_r, np_r = (int(v) for v in (r[1], r[3], r[4],
                                                          r[5]))
            err = float((k[0] - r[0]).abs().max())
            scale = max(float(r[0].abs().max()), float(B.abs().max()))
            res_k = block_rel_residual(A, B, k[0])
            res_p = block_rel_residual(A, B, r[0])
            f32 = dt == torch.float32
            label = (f"block_gmres {'f32' if f32 else 'f64'} memory {mem}"
                     f"{' bf16 basis' if basis else ''}"
                     f"{f' rtol {rtol}' if rtol else ''}")
            line = (f"  {label}: kernel niter={it_k} status={code_k} "
                    f"incons={inc_k} npass={np_k}; plain niter={it_r} "
                    f"status={code_r} incons={inc_r} npass={np_r}; "
                    f"max_abs_err={err:.3e} rel={err / scale:.3e}; true_res"
                    f" kernel {res_k:.3e} plain {res_p:.3e}")
            timed = f32 and basis is None
            if timed:
                ms = event_ms(lambda: cf.block_gmres_dia_fused(*args), reps=3,
                              warmup=0)
                plain_ms = event_ms(lambda: cf.block_gmres_dia_fused_ref(
                    *args), reps=1, warmup=0)
                bound_bytes = bg_bound_bytes(A, n, 4, mem, it_k, dt)
                bound_ms = bound_bytes / bw * 1e3
                line += (f"; ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms="
                         f"{bound_ms:.3f} ({bound_bytes / 1e6:.1f} MB; "
                         f"{1e3 * ms / max(it_k, 1):.1f} us/iter)")
                report["block_gmres_dia"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by="bytes", library_ms=None)
            print(line, flush=True)
            check([code_k, inc_k] == [code_r, inc_r],
                  f"{label}: the plain version's status and flag")
            check(abs(it_k - it_r) <= 2 and abs(np_k - np_r) <= 2,
                  f"{label}: niter {it_k} and passes {np_k} within ±2 of "
                  f"{it_r} and {np_r}")
            check(res_k <= 1.5 * res_p,
                  f"{label}: true residual {res_k:.2e} no worse than 1.5 x "
                  f"the plain version's {res_p:.2e}")
            if not f32 and basis is None:
                check(err <= 1e-6 * scale,
                      f"{label}: X agrees ({err / scale:.2e} <= 1e-6)")
            if mem == 8:
                check(np_k >= 2, f"{label}: restarted ({np_k} passes)")
            del A, B, k, r
        bell_dev = bell_device_ms_in_own_process()
        for nb, dt in BELL_CASES:
            Ab = bell_tridiagonal(kt, nb, dt, SEED + 31)
            nB = nb * 128
            tol = 1e-5 if dt == torch.float32 else 1e-12
            blocks = Ab.data.numel() * Ab.data.element_size() \
                + Ab.indices.numel() * 4
            bsr = bsr_of(Ab)
            op = kt.BELLOperator(Ab)
            for p in (1, 4, 8):
                S = torch.as_tensor(gen.standard_normal(
                    (nB, p) if p > 1 else nB)).to(dev, dt)
                name = "bell_spmv" if p == 1 else "bell_spmm"
                kern = getattr(kt, name)
                plain = getattr(cspmv, name + "_ref")
                bound_call = op.matvec if p == 1 else op.matmat
                y, y_r = kern(Ab, S), plain(Ab, S)
                torch.cuda.synchronize()
                err = float((y - y_r).abs().max())
                ymax = float(y_r.abs().max())
                check(torch.equal(bound_call(S), y), f"{name} p={p}: "
                      "BELLOperator's bound plan gives the wrapper's bits")
                label = bell_label(p, nb, dt)
                ms = event_ms(lambda: kern(Ab, S))
                dev_ms = bell_dev.get(label)
                us = host_us(lambda: bound_call(S))
                us_public = host_us(lambda: kern(Ab, S))
                plain_ms = event_ms(lambda: plain(Ab, S), reps=5)
                S2 = S if p > 1 else S[:, None]
                library_ms = event_ms(lambda: bsr @ S2, reps=5)
                bound_ms = bell_bound_ms(Ab, S, bw)
                print(f"  {label}: max_abs_err={err:.3e} (max|y| "
                      f"{ymax:.3e}); ms={ms:.4f} device_ms={fmt(dev_ms)} "
                      f"host_us={us:.1f} (BELLOperator; public "
                      f"{us_public:.1f}) plain_ms={plain_ms:.4f} "
                      f"library_ms={library_ms:.4f} (BSR @) bound_ms="
                      f"{bound_ms:.4f} ({blocks / 1e6:.1f} MB of blocks"
                      f"{on_device(bound_ms, dev_ms)})", flush=True)
                check(err <= tol * ymax, f"{label}: agrees with the plain "
                      f"version ({err / ymax:.2e} <= {tol})")
                if nb == 1024 and dt == torch.float32 and p in (1, 4):
                    report[name] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by="bytes",
                        library_ms=library_ms)
            del Ab, bsr, op

    with Phase("4 krylov_tpu_torch.cg end to end", 120):
        problems = {N: (kt.poisson_dia(N), rhs(N ** 3)) for N in (128, 256)}
        rtol = float(np.sqrt(np.finfo(np.float32).eps))
        torch.cuda.synchronize()
        reset_counts()
        runs = [("128^3 default", 128, {}, "cg_dia"),
                ("128^3 history=True", 128, {"history": True}, "dia_spmv"),
                ("256^3 default", 256, {}, "cg_dia")]
        for label, N, kw, kernel in runs:
            A, b = problems[N]
            before = kt.kernel_launches()[kernel]
            t = time.perf_counter()
            x, stats = kt.cg(A, b, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            pd = dia_align(A.data, A.offsets, A.shape[0])
            res = true_rel_residual(pd, offsets_tensor(A.offsets, dev), b, x)
            print(f"  {label}: niter={stats.niter} status='{stats.status}' "
                  f"true_res={res:.3e} ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(stats.niter, 1):.2f}", flush=True)
            del pd
            check(stats.status == "solution good enough given atol and rtol",
                  f"cg {label} solved")
            check(x.shape == b.shape and bool(torch.isfinite(x).all()),
                  f"cg {label}: finite x of shape {tuple(x.shape)}")
            check(res <= 1.5 * rtol,
                  f"cg {label}: true residual {res:.2e} <= 1.5·rtol")
            check(kt.kernel_launches()[kernel] > before,
                  f"cg {label} launched {kernel}")
        launches = {k: v for k, v in kt.kernel_launches().items()
                    if k in ("dia_spmv", "cg_dia")}
        print(f"  main-path launches: {launches}", flush=True)
        for name, count in launches.items():
            check(count > 0, f"main path launched {name} ({count} times)")

    with Phase("4b profile of one 128^3 solve", 60):
        profile_solve(lambda: kt.cg(*problems[128]))
    del problems

    with Phase("5 cg (Chebyshev M), cr, car, minres end to end", 150):
        # Each path through the public entry points at 128^3 f32 with the
        # default options, against the plain version of its kernel on the
        # same inputs: solved, the same status, and a true relative
        # residual no worse than 1.5 times the plain version's; then one
        # general-route solve (history=True) through the DIA SpMV kernel.
        # The counts are set to 0 just before each path and read after.
        A = kt.DIAOperator(kt.poisson_dia(128))
        b = rhs(A.shape[0])
        n = b.shape[0]
        pd, ot = A._pd, A._offsets
        tol = rt.default_tol(None, torch.float32)
        overrides = {cf.ZERO_CURV_B: "b is a zero-curvature direction",
                     cf.NUMERICAL: "solver encountered numerical issues"}
        cheb = {}

        def cheb_solve(**kw):
            return kt.cg(A, b, M=cheb["M"], **kw)

        def cheb_plain():
            M = cheb["M"]
            return cf.cg_cheby_dia_fused_ref(pd, ot, b, tol, tol, 2 * n,
                                             M.lmin, M.lmax, M.degree)

        # (kernel, label, the public call, its kernel's plain version on
        # the same inputs, the index of the status in that one's outputs)
        paths = [
            ("cg_cheby_dia", "cg, M = ChebyshevPreconditioner(A)",
             cheb_solve, cheb_plain, 3),
            ("cr_dia", "cr", lambda **kw: kt.cr(A, b, **kw),
             lambda: cf.cr_dia_fused_ref(pd, ot, b, tol, tol, 2 * n), 3),
            ("car_dia", "car", lambda **kw: kt.car(A, b, **kw),
             lambda: cf.car_dia_fused_ref(pd, ot, b, tol, tol, 2 * n), 4),
            ("minres_dia", "minres", lambda **kw: kt.minres(A, b, **kw),
             lambda: cf.minres_dia_fused_ref(pd, ot, b, tol, tol, tol, 1e-8,
                                             0.0, 2 * n), 3)]
        for name, label, solve, plain, status_at in paths:
            torch.cuda.synchronize()
            reset_counts()
            if name == "cg_cheby_dia":
                # lmax from power_bound: 20 SpMV launches on the card
                cheb["M"] = kt.ChebyshevPreconditioner(A)
            t = time.perf_counter()
            x, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            xh, sh = solve(history=True)
            torch.cuda.synchronize()
            counts = kt.kernel_launches()
            ref = plain()
            code = rt.final_status_code(ref[status_at], 0, 1, False)
            want = rt.decode_status(code, overrides)
            res = true_rel_residual(pd, ot, b, x)
            res_p = true_rel_residual(pd, ot, b, ref[0])
            res_h = true_rel_residual(pd, ot, b, xh)
            print(f"  {label}: niter={stats.niter} status='{stats.status}'"
                  f" true_res={res:.3e} ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(stats.niter, 1):.2f}; plain version: "
                  f"status='{want}' true_res={res_p:.3e}; history=True: "
                  f"niter={sh.niter} true_res={res_h:.3e}; launches "
                  f"{counts}", flush=True)
            check(stats.solved and sh.solved, f"{label} solved (both routes)")
            check(stats.status == want,
                  f"{label}: the plain version's status")
            check(x.shape == b.shape and bool(torch.isfinite(x).all()),
                  f"{label}: finite x of shape {tuple(x.shape)}")
            check(res <= 1.5 * res_p, f"{label}: true residual {res:.3e} <="
                  f" 1.5 x the plain version's")
            check(counts[name] > 0, f"{label} launched {name} "
                  f"({counts[name]} times)")
            check(counts["dia_spmv"] > 0, f"{label} (history=True) launched"
                  f" dia_spmv ({counts['dia_spmv']} times)")
            launches[name] = counts[name]
            del ref

    with Phase("5b profiles of the four 128^3 solves", 90):
        # minres with the default tolerances stops after one iteration on
        # this right-hand side (test2 <= atol + rtol ||b||, ||b|| about
        # 1448), so its profile takes rtol = 1e-7 (about 150 iterations)
        for name, label, solve, _, _ in paths:
            kw = {"rtol": 1e-7} if name == "minres_dia" else {}
            print(f"  {label} {kw}:", flush=True)
            profile_solve(lambda: solve(**kw), top=8)

    with Phase("5c cg_lanczos, cg_lanczos_shift, symmlq end to end", 150):
        # As phase 5, on the same 128^3 f32 system: each default solve
        # through the public entry point reaches its kernel's plain
        # version's status, with a true relative residual no worse than
        # 1.5 times the plain version's for every shift; then one
        # general-route solve (history=True) through the DIA SpMV kernel.
        shifts = [0.0, 0.5, 1.0, 2.0]
        shifts_t = torch.tensor(shifts, device=dev)
        paths_c = [
            ("cg_lanczos_dia", "cg_lanczos",
             lambda **kw: kt.cg_lanczos(A, b, **kw),
             lambda: cf.cg_lanczos_dia_fused_ref(pd, ot, b, tol, tol, 2 * n),
             4, {cf.NEG_CURV: "negative curvature"}, [0.0]),
            ("cg_lanczos_shift_dia", "cg_lanczos_shift",
             lambda **kw: kt.cg_lanczos_shift(A, b, shifts, **kw),
             lambda: cf.cg_lanczos_shift_dia_fused_ref(
                 pd, ot, b, shifts_t, tol, tol, 2 * n), 3, {}, shifts),
            ("symmlq_dia", "symmlq", lambda **kw: kt.symmlq(A, b, **kw),
             lambda: cf.symmlq_dia_fused_ref(pd, ot, b, tol, tol, 1e-8, 0.0,
                                             2 * n), 3, symmlq_status,
             [0.0])]
        for name, label, solve, plain, status_at, over, sigmas in paths_c:
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            x, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            xh, sh = solve(history=True)
            torch.cuda.synchronize()
            counts = kt.kernel_launches()
            ref = plain()
            code = rt.final_status_code(ref[status_at], 0, 1, False)
            want = rt.decode_status(code, over)
            rows = [(sig, x.reshape(len(sigmas), n)[i],
                     ref[0].reshape(len(sigmas), n)[i],
                     xh.reshape(len(sigmas), n)[i])
                    for i, sig in enumerate(sigmas)]
            res = [[true_rel_residual(pd, ot, b, v, sig) for v in vs]
                   for sig, *vs in rows]
            print(f"  {label}: niter={stats.niter} status='{stats.status}'"
                  f" ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(stats.niter, 1):.2f}; plain version: "
                  f"status='{want}'; history=True: niter={sh.niter}; true "
                  f"residuals (kernel, plain, history) per shift "
                  f"{[[f'{r:.3e}' for r in rr] for rr in res]}; launches "
                  f"{counts}", flush=True)
            check(stats.solved and sh.solved, f"{label} solved (both routes)")
            check(stats.status == want,
                  f"{label}: the plain version's status")
            check(x.shape == ref[0].shape and bool(torch.isfinite(x).all()),
                  f"{label}: finite x of shape {tuple(x.shape)}")
            for sig, (rk, rp, _) in zip(sigmas, res):
                check(rk <= 1.5 * rp, f"{label} shift {sig}: true residual "
                      f"{rk:.3e} <= 1.5 x the plain version's")
            check(counts[name] > 0, f"{label} launched {name} "
                  f"({counts[name]} times)")
            check(counts["dia_spmv"] > 0, f"{label} (history=True) launched"
                  f" dia_spmv ({counts['dia_spmv']} times)")
            launches[name] = counts[name]
            del ref

    with Phase("5d profiles of the three 128^3 Lanczos-family solves", 90):
        # symmlq with the default tolerances stops after two iterations on
        # this right-hand side (test1 = ||r|| / (||A|| ||x||) <= atol +
        # rtol ||b||, as minres), so its profile takes atol = 0 and
        # rtol = 1e-6 (about 180 iterations)
        for name, label, solve, *_ in paths_c:
            kw = {"atol": 0.0, "rtol": 1e-6} if name == "symmlq_dia" else {}
            print(f"  {label} {kw}:", flush=True)
            profile_solve(lambda: solve(**kw), top=8)

    with Phase("5f minres_qlp and minares end to end", 150):
        # As phase 5c, on the same 128^3 f32 system: each default solve
        # and each solve with atol = 0, rtol = 1e-6 through the public
        # entry point reaches its kernel's plain version's status, with a
        # true relative residual no worse than 1.5 times the plain
        # version's; then one general-route solve (history=True) through
        # the DIA SpMV kernel.  The counts are set to 0 just before each
        # path and read after.
        paths_q = [
            ("minres_qlp_dia", "minres_qlp",
             lambda **kw: kt.minres_qlp(A, b, **kw),
             cf.minres_qlp_dia_fused_ref, 3, {}),
            ("minares_dia", "minares", lambda **kw: kt.minares(A, b, **kw),
             cf.minares_dia_fused_ref, 4, minares_status)]
        for name, label, solve, plain, status_at, over in paths_q:
            torch.cuda.synchronize()
            reset_counts()
            runs = []
            for kw in ({}, {"atol": 0.0, "rtol": 1e-6}):
                t = time.perf_counter()
                x, stats = solve(**kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                runs.append((kw, x, stats, ms))
            counts_fused = kt.kernel_launches()
            xh, sh = solve(history=True)
            torch.cuda.synchronize()
            counts = kt.kernel_launches()
            res_h = true_rel_residual(pd, ot, b, xh)
            for kw, x, stats, ms in runs:
                ref = plain(pd, ot, b, kw.get("atol", tol),
                            kw.get("rtol", tol), tol, 0.0, 2 * n)
                code = rt.final_status_code(ref[status_at], 0, 1, False)
                want = rt.decode_status(code, over)
                res = true_rel_residual(pd, ot, b, x)
                res_p = true_rel_residual(pd, ot, b, ref[0])
                print(f"  {label} {kw}: niter={stats.niter} status="
                      f"'{stats.status}' true_res={res:.3e} ms/solve="
                      f"{ms:.2f} us/iter={1e3 * ms / max(stats.niter, 1):.2f}"
                      f"; plain version: niter={int(ref[1])} status="
                      f"'{want}' true_res={res_p:.3e}", flush=True)
                check(stats.solved, f"{label} {kw} solved")
                check(stats.status == want,
                      f"{label} {kw}: the plain version's status")
                check(x.shape == b.shape and bool(torch.isfinite(x).all()),
                      f"{label} {kw}: finite x of shape {tuple(x.shape)}")
                check(res <= 1.5 * res_p, f"{label} {kw}: true residual "
                      f"{res:.3e} <= 1.5 x the plain version's")
                del ref
            print(f"  {label} history=True: niter={sh.niter} status="
                  f"'{sh.status}' true_res={res_h:.3e}; launches {counts}",
                  flush=True)
            check(sh.solved and sh.residuals.size == sh.niter + 1,
                  f"{label} (history=True) solved with its history")
            check(counts_fused[name] > 0, f"{label} default calls launched "
                  f"{name} ({counts_fused[name]} times)")
            check(counts["dia_spmv"] > 0, f"{label} (history=True) launched"
                  f" dia_spmv ({counts['dia_spmv']} times)")
            launches[name] = counts[name]

    with Phase("5g profiles of the two 128^3 solves", 60):
        # atol = 0, rtol = 1e-6 and Artol = 0: with the default
        # tolerances the relative tests (MINRES-QLP's backward error,
        # MINARES's ||Ar|| against Artol ||Ar_0||) may stop these solves
        # early, as minres and symmlq (phases 5b and 5d)
        kw = {"atol": 0.0, "rtol": 1e-6, "Artol": 0.0}
        for name, label, solve, *_ in paths_q:
            print(f"  {label} {kw}:", flush=True)
            profile_solve(lambda: solve(**kw), top=8)
    del A, b, pd, ot

    with Phase("5i gmres, fgmres, fom, bicgstab, cgs end to end", 240):
        # The convection-diffusion stencil at 128^3 f32 with a seeded
        # normal right-hand side: each default path through the public
        # entry points reaches its kernel's plain version's status on the
        # same inputs, with a true relative residual (f64, the plain
        # SpMV) no worse than 1.5 times the plain version's; then the
        # same call with history=True, and gmres and bicgstab with the
        # Jacobi M of bench.py:423-437 (M = I/6), on the general route
        # through the DIA SpMV kernel, held to the same residual.  The
        # counts are set to 0 just before each path and read after.
        A = kt.DIAOperator(kt.convdiff_dia(128))
        b = rhs(A.shape[0], gen=np.random.default_rng(SEED + 7))
        n = b.shape[0]
        pd, ot = A._pd, A._offsets
        tol = rt.default_tol(None, torch.float32)
        jacobi = kt.DiagonalOperator(torch.full_like(b, 1.0 / 6.0))
        # CGS in f64 (phase 3e says why)
        A64 = kt.DIAOperator(kt.convdiff_dia(128, dtype=torch.float64))
        b64, tol64 = b.double(), rt.default_tol(None, torch.float64)
        paths_n = [
            ("gmres_dia", "gmres, memory 20, restart",
             lambda **kw: kt.gmres(A, b, memory=20, restart=True, **kw),
             lambda: cf.gmres_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20),
             {}, True),
            ("gmres_dia", "gmres", lambda **kw: kt.gmres(A, b, **kw),
             lambda: cf.gmres_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 512),
             {}, False),
            ("gmres_dia", "fgmres, memory 20, restart",
             lambda **kw: kt.fgmres(A, b, memory=20, restart=True, **kw),
             lambda: cf.gmres_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20),
             {}, False),
            ("fom_dia", "fom, memory 20, restart",
             lambda **kw: kt.fom(A, b, memory=20, restart=True, **kw),
             lambda: cf.fom_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20),
             fom_status, True),
            ("bicgstab_dia", "bicgstab", lambda **kw: kt.bicgstab(A, b, **kw),
             lambda: cf.bicgstab_dia_fused_ref(pd, ot, b, tol, tol, 2 * n),
             biortho_status, True),
            ("cgs_dia", "cgs (f64)", lambda **kw: kt.cgs(A64, b64, **kw),
             lambda: cf.cgs_dia_fused_ref(A64._pd, ot, b64, tol64, tol64,
                                          2 * n), biortho_status, True)]
        # (kernel, label, the public call, its kernel's plain version on
        # the same inputs, status overrides, whether it is the kernel's
        # main path: the run whose launches the kernels line reports and
        # the solve phase 5j profiles)
        for name, label, solve, plain, over, main_path in paths_n:
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            x, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts_fused = kt.kernel_launches()
            t = time.perf_counter()
            xh, sh = solve(history=True)
            torch.cuda.synchronize()
            ms_h = (time.perf_counter() - t) * 1e3
            counts = kt.kernel_launches()
            ref = plain()
            code = rt.final_status_code(ref[3], 0, 1, False)
            want = rt.decode_status(code, over)
            bb, pdb = (b64, A64._pd) if x.dtype == torch.float64 else (b, pd)
            res = true_rel_residual(pdb, ot, bb, x)
            res_p = true_rel_residual(pdb, ot, bb, ref[0])
            res_h = true_rel_residual(pdb, ot, bb, xh)
            print(f"  {label}: niter={stats.niter} status='{stats.status}'"
                  f" true_res={res:.3e} ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(stats.niter, 1):.2f}; plain version: "
                  f"niter={int(ref[1])} status='{want}' true_res={res_p:.3e}"
                  f"; history=True: niter={sh.niter} true_res={res_h:.3e} "
                  f"ms={ms_h:.1f}; launches {counts}", flush=True)
            check(stats.solved and sh.solved, f"{label} solved (both routes)")
            check(stats.status == want,
                  f"{label}: the plain version's status")
            check(x.shape == bb.shape and bool(torch.isfinite(x).all()),
                  f"{label}: finite x of shape {tuple(x.shape)}")
            check(res <= 1.5 * res_p and res_h <= 1.5 * res_p,
                  f"{label}: true residuals {res:.3e}, {res_h:.3e} (history)"
                  f" <= 1.5 x the plain version's")
            check(sh.residuals.size == sh.niter + 1,
                  f"{label} (history=True) kept its history")
            check(counts_fused[name] > 0, f"{label} launched {name} "
                  f"({counts_fused[name]} times)")
            check(counts["dia_spmv"] > 0, f"{label} (history=True) launched"
                  f" dia_spmv ({counts['dia_spmv']} times)")
            if main_path:
                launches[name] = counts_fused[name]
            del ref
        for label, solve in (
                ("gmres, Jacobi M, memory 20, restart",
                 lambda: kt.gmres(A, b, M=jacobi, memory=20, restart=True)),
                ("bicgstab, Jacobi M", lambda: kt.bicgstab(A, b, M=jacobi))):
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            x, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts = kt.kernel_launches()
            ref = (cf.gmres_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20)
                   if label.startswith("gmres")
                   else cf.bicgstab_dia_fused_ref(pd, ot, b, tol, tol, 2 * n))
            res = true_rel_residual(pd, ot, b, x)
            res_p = true_rel_residual(pd, ot, b, ref[0])
            print(f"  {label}: niter={stats.niter} status='{stats.status}' "
                  f"true_res={res:.3e} ms/solve={ms:.2f}; plain version "
                  f"(M = I) true_res={res_p:.3e}; launches {counts}",
                  flush=True)
            check(stats.solved and bool(torch.isfinite(x).all()),
                  f"{label} solved")
            check(res <= 1.5 * res_p, f"{label}: true residual {res:.3e} <= "
                  "1.5 x the plain version's (M = I)")
            check(counts["dia_spmv"] > 0, f"{label} launched dia_spmv "
                  f"({counts['dia_spmv']} times)")
            del ref

    with Phase("5j profiles of the four 128^3 non-symmetric solves", 90):
        for name, label, solve, _, _, main_path in paths_n:
            if main_path:
                print(f"  {label}:", flush=True)
                profile_solve(solve, top=8)
    del A, b, pd, ot, jacobi, A64, b64

    with Phase("5k diom, dqgmres, bilq, qmr, bilqr end to end", 240):
        # The convection-diffusion stencil at 128^3 with a seeded normal
        # right-hand side (and, for bilqr, a second seeded c), in f32 for
        # diom and dqgmres and in f64 for bilq, qmr and bilqr (phase 3f
        # and PERF.md section 7 say why): each default path through
        # the public entry points reaches its kernel's plain version's
        # status on the same inputs, with true relative residuals (f64,
        # the plain SpMV; for bilqr also ||c - A^H y|| / ||c||) no worse
        # than 1.5 times the plain version's; then the same call with
        # history=True, on the general route through the DIA SpMV kernel
        # (and its adjoint), held to the same residuals.  The counts are
        # set to 0 just before each path and read after.
        A = kt.DIAOperator(kt.convdiff_dia(128))
        gen = np.random.default_rng(SEED + 9)
        b = rhs(A.shape[0], gen=gen)
        c = rhs(A.shape[0], gen=gen)
        n = b.shape[0]
        pd, ot = A._pd, A._offsets
        pda, offa = A.aligned_adjoint()
        ota = offsets_tensor(offa, dev)
        tol = rt.default_tol(None, torch.float32)
        A64 = kt.DIAOperator(kt.convdiff_dia(128, dtype=torch.float64))
        b64, c64 = b.double(), c.double()
        tol64 = rt.default_tol(None, torch.float64)
        pda64 = A64.aligned_adjoint()[0]
        from krylov_tpu_torch.solvers.bilq import (_STATUS as bilq_status,
                                                   _Flags, _bilqr_status)
        paths_t = [
            ("trunc_dia", "diom", lambda **kw: kt.diom(A, b, **kw),
             lambda: cf.trunc_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20,
                                            "diom"), False),
            ("trunc_dia", "dqgmres", lambda **kw: kt.dqgmres(A, b, **kw),
             lambda: cf.trunc_dia_fused_ref(pd, ot, b, tol, tol, 2 * n, 20,
                                            "dqgmres"), True),
            ("bilq_dia", "bilq (f64)", lambda **kw: kt.bilq(A64, b64, **kw),
             lambda: cf.bilq_dia_fused_ref(A64._pd, pda64, ot, ota, b64,
                                           tol64, tol64, 2 * n), True),
            ("qmr_dia", "qmr (f64)", lambda **kw: kt.qmr(A64, b64, **kw),
             lambda: cf.qmr_dia_fused_ref(A64._pd, pda64, ot, ota, b64,
                                          tol64, tol64, 2 * n), True),
            ("bilqr_dia", "bilqr (f64)",
             lambda **kw: kt.bilqr(A64, b64, c64, **kw),
             lambda: cf.bilqr_dia_fused_ref(A64._pd, pda64, ot, ota, b64,
                                            c64, tol64, tol64, 2 * n), True)]
        # (kernel, label, the public call, its kernel's plain version on
        # the same inputs, whether it is the kernel's main path: the run
        # whose launches the kernels line reports and the solve phase 5l
        # profiles)
        for name, label, solve, plain, main_path in paths_t:
            two = name == "bilqr_dia"
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            *xs, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts_fused = kt.kernel_launches()
            t = time.perf_counter()
            *xh, sh = solve(history=True)
            torch.cuda.synchronize()
            ms_h = (time.perf_counter() - t) * 1e3
            counts = kt.kernel_launches()
            ref = plain()
            bb = b64 if xs[0].dtype == torch.float64 else b
            if two:
                code = rt.final_status_code(ref[5], 0, 1, False)
                want = _bilqr_status(_Flags(*(bool(v) for v in
                                              ref[6].tolist())), code)
                sols = [(pd, ot, b64, 0, 0), (pda, ota, c64, 1, 1)]
            else:
                code = rt.final_status_code(ref[3], 0, 1, False)
                want = rt.decode_status(code, bilq_status)
                sols = [(pd, ot, bb, 0, 0)]
            res = [true_rel_residual(d, o, v, xs[i]) for d, o, v, i, _ in sols]
            res_p = [true_rel_residual(d, o, v, ref[j])
                     for d, o, v, _, j in sols]
            res_h = [true_rel_residual(d, o, v, xh[i])
                     for d, o, v, i, _ in sols]
            print(f"  {label}: niter={stats.niter} status='{stats.status}'"
                  f" true_res={[f'{v:.3e}' for v in res]} ms/solve={ms:.2f}"
                  f" us/iter={1e3 * ms / max(stats.niter, 1):.2f}; plain "
                  f"version: niter={int(ref[2 if two else 1])} status="
                  f"'{want}' true_res={[f'{v:.3e}' for v in res_p]}; "
                  f"history=True: niter={sh.niter} true_res="
                  f"{[f'{v:.3e}' for v in res_h]} ms={ms_h:.1f}; launches "
                  f"{counts}", flush=True)
            check(stats.solved and sh.solved, f"{label} solved (both routes)")
            check(stats.status == want,
                  f"{label}: the plain version's status")
            check(all(x.shape == b.shape and bool(torch.isfinite(x).all())
                      for x in xs),
                  f"{label}: finite solutions of shape {tuple(b.shape)}")
            check(all(a <= 1.5 * p and h <= 1.5 * p
                      for a, p, h in zip(res, res_p, res_h)),
                  f"{label}: true residuals {[f'{v:.3e}' for v in res]}, "
                  f"{[f'{v:.3e}' for v in res_h]} (history) <= 1.5 x the "
                  f"plain version's")
            hist = (sh.residuals_primal if two else sh.residuals)
            check(hist.size >= 1 and (two or hist.size == sh.niter + 1),
                  f"{label} (history=True) kept its history")
            check(counts_fused[name] > 0, f"{label} launched {name} "
                  f"({counts_fused[name]} times)")
            check(counts["dia_spmv"] > 0, f"{label} (history=True) launched"
                  f" dia_spmv ({counts['dia_spmv']} times)")
            if main_path:
                launches[name] = counts_fused[name]
            del ref

    with Phase("5l profiles of the four 128^3 kernels' solves", 90):
        for name, label, solve, _, main_path in paths_t:
            if main_path:
                print(f"  {label}:", flush=True)
                profile_solve(lambda: (None, solve()[-1]), top=8)
    del A, b, c, pd, ot, pda, ota, A64, b64, c64, pda64

    with Phase("5m usymlq, usymqr, trilqr, usymlqr end to end", 240):
        # The convection-diffusion stencil with 0.5 on its main diagonal at
        # 128^3, f32, b and c seeded normal: each public entry point with
        # its default options (the whole-solve kernel), then with
        # history=True (the general route through the DIA SpMV kernel and
        # its adjoint).  ms per solve, niter and us per iteration; the
        # true relative residuals (f64, the plain SpMV, ssy_residuals)
        # no worse than 1.5 times those of the kernel's plain version on
        # the same inputs, on both routes; the status the plain version
        # gives; and the launch counts, set to 0 just before each path and
        # read after.  TriLQR also prints the dual's true residual beside
        # its status (PERF.md section 7: "dual system inconsistent").
        A = kt.DIAOperator(shifted_dia(128))
        gen = np.random.default_rng(SEED + 12)
        b = rhs(A.shape[0], gen=gen)
        c = rhs(A.shape[0], gen=gen)
        n = b.shape[0]
        pd, ot = A._pd, A._offsets
        pda, offa = A.aligned_adjoint()
        ota = offsets_tensor(offa, dev)
        tol = rt.default_tol(None, torch.float32)
        from krylov_tpu_torch.solvers.usymlq import (_STATUS as usym_status,
                                                     _Flags as tri_flags,
                                                     _trilqr_status)
        paths_s = [(m, lambda m=m, **kw: getattr(kt, m)(A, b, c, **kw))
                   for m in ("usymlq", "usymqr", "trilqr", "usymlqr")]
        for method, solve in paths_s:
            name = method + "_dia"
            nsol = 2 if method in ("trilqr", "usymlqr") else 1
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            *xs, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts_fused = kt.kernel_launches()
            t = time.perf_counter()
            *xh, sh = solve(history=True)
            torch.cuda.synchronize()
            ms_h = (time.perf_counter() - t) * 1e3
            counts = kt.kernel_launches()
            ref = getattr(cf, name + "_fused_ref")(pd, pda, ot, ota, b, c,
                                                   tol, tol, 2 * n)
            code = rt.final_status_code(ref[{"usymlq": 3, "usymqr": 4}.get(
                method, 5)], 0, 1, False)
            if method == "trilqr":
                want = _trilqr_status(tri_flags(*(bool(v) for v in
                                                  ref[6].tolist())), code)
            else:
                want = rt.decode_status(code, usym_status)
            res = ssy_residuals(name, pd, ot, pda, ota, b, c, xs)
            res_p = ssy_residuals(name, pd, ot, pda, ota, b, c, ref)
            res_h = ssy_residuals(name, pd, ot, pda, ota, b, c, xh)
            print(f"  {method}: niter={stats.niter} status='{stats.status}'"
                  f" true_res={[f'{v:.3e}' for v in res]} ms/solve={ms:.2f}"
                  f" us/iter={1e3 * ms / max(stats.niter, 1):.2f}; plain "
                  f"version: niter={int(ref[nsol])} status='{want}' "
                  f"true_res={[f'{v:.3e}' for v in res_p]}; history=True: "
                  f"niter={sh.niter} status='{sh.status}' true_res="
                  f"{[f'{v:.3e}' for v in res_h]} ms={ms_h:.1f}; launches "
                  f"{counts_fused[name]} ({name}), {counts['dia_spmv']} "
                  "(dia_spmv, history)", flush=True)
            solved = (stats.solved or stats.inconsistent) and \
                (sh.solved or sh.inconsistent)
            check(solved, f"{method} stopped solved (both routes)")
            check(stats.status == want,
                  f"{method}: the plain version's status")
            check(all(x.shape == b.shape and bool(torch.isfinite(x).all())
                      for x in xs),
                  f"{method}: finite solutions of shape {tuple(b.shape)}")
            check(all(a <= 1.5 * p and h <= 1.5 * p
                      for a, p, h in zip(res, res_p, res_h)),
                  f"{method}: true residuals {[f'{v:.3e}' for v in res]}, "
                  f"{[f'{v:.3e}' for v in res_h]} (history) <= 1.5 x the "
                  f"plain version's")
            hist = sh.residuals_primal if method == "trilqr" \
                else sh.residuals
            check(hist.size >= 1, f"{method} (history=True) kept its "
                  "history")
            check(counts_fused[name] > 0, f"{method} launched {name} "
                  f"({counts_fused[name]} times)")
            check(counts["dia_spmv"] > 0, f"{method} (history=True) "
                  f"launched dia_spmv ({counts['dia_spmv']} times)")
            launches[name] = counts_fused[name]
            del ref

    with Phase("5n profiles of the four 128^3 SSY solves", 90):
        for method, solve in paths_s:
            print(f"  {method}:", flush=True)
            profile_solve(lambda: (None, solve()[-1]), top=8)
    del A, b, c, pd, ot, pda, ota

    with Phase("5o lsqr, lsmr, lslq end to end", 240):
        # The convection-diffusion stencil with 0.5 on its main diagonal at
        # 128^3, b seeded normal, in f32 and in f64: each public entry
        # point with its default options (the whole-solve kernel), then
        # with history=True (the general route through the DIA SpMV kernel
        # and its adjoint).  ms per solve, niter and us per iteration; the
        # true relative residual ||b - Ax|| / ||b|| and ||A^H (b - Ax)||
        # (f64, the plain SpMV), the first no worse than 1.5 times that of
        # the kernel's plain version on the same inputs, on both routes;
        # the status the plain version gives; and the launch counts, set
        # to 0 just before each path and read after.  The kernels line
        # takes the launches of the f32 default solves.
        from krylov_tpu_torch.solvers.lslq import _STATUS as lslq_status
        gk_ops = {}
        for dt in (torch.float32, torch.float64):
            A = kt.DIAOperator(shifted_dia(128, dt))
            b = rhs(A.shape[0], dt, gen=np.random.default_rng(SEED + 15))
            n = b.shape[0]
            pd, ot = A._pd, A._offsets
            pda, offa = A.aligned_adjoint()
            ota = offsets_tensor(offa, dev)
            f32 = dt == torch.float32
            for method in ("lsqr", "lsmr", "lslq"):
                name = method + "_dia"
                solve = (lambda m=method, A=A, b=b, **kw:
                         getattr(kt, m)(A, b, **kw))
                gk_ops[method, f32] = solve
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                x, stats = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                counts_fused = kt.kernel_launches()
                t = time.perf_counter()
                xh, sh = solve(history=True)
                torch.cuda.synchronize()
                ms_h = (time.perf_counter() - t) * 1e3
                counts = kt.kernel_launches()
                args, kwargs = gk_args(method, dt, n)
                ref = getattr(cf, name + "_fused_ref")(pd, pda, ot, ota, b,
                                                       *args, **kwargs)
                code = rt.final_status_code(
                    [v for v in ref[1:] if v.dtype == torch.int32][1], 0, 1,
                    False)
                want = rt.decode_status(code, lslq_status)
                res = ls_residuals(pd, ot, pda, ota, b, x)
                res_p = ls_residuals(pd, ot, pda, ota, b, ref[0])
                res_h = ls_residuals(pd, ot, pda, ota, b, xh)
                label = f"{method} {'f32' if f32 else 'f64'}"
                print(f"  {label}: niter={stats.niter} status="
                      f"'{stats.status}' true_res={res[0]:.3e} ||A^H r||="
                      f"{res[1]:.3e} ms/solve={ms:.2f} us/iter="
                      f"{1e3 * ms / max(stats.niter, 1):.2f}; plain "
                      f"version: niter={int(ref[1])} status='{want}' "
                      f"true_res={res_p[0]:.3e}; history=True: niter="
                      f"{sh.niter} status='{sh.status}' true_res="
                      f"{res_h[0]:.3e} ms={ms_h:.1f}; launches "
                      f"{counts_fused[name]} ({name}), "
                      f"{counts['dia_spmv']} (dia_spmv, history)",
                      flush=True)
                check(stats.solved and sh.solved,
                      f"{label} stopped solved (both routes)")
                check(stats.status == want,
                      f"{label}: the plain version's status")
                check(x.shape == b.shape and x.dtype == dt
                      and bool(torch.isfinite(x).all()),
                      f"{label}: finite x of shape {tuple(b.shape)}")
                check(res[0] <= 1.5 * res_p[0] and res_h[0] <= 1.5 * res_p[0],
                      f"{label}: true residuals {res[0]:.3e}, {res_h[0]:.3e} "
                      f"(history) <= 1.5 x the plain version's")
                check(sh.residuals.size == sh.niter + 1,
                      f"{label} (history=True) kept its history")
                check(counts_fused[name] > 0, f"{label} launched {name} "
                      f"({counts_fused[name]} times)")
                check(counts["dia_spmv"] > 0, f"{label} (history=True) "
                      f"launched dia_spmv ({counts['dia_spmv']} times)")
                if f32:
                    launches[name] = counts_fused[name]
                del ref, x, xh
            del A, b, pd, ot, pda, ota

    with Phase("5p profiles of the three 128^3 Golub-Kahan solves", 90):
        for method in ("lsqr", "lsmr", "lslq"):
            print(f"  {method} f64:", flush=True)
            profile_solve(gk_ops[method, False], top=6)
    del gk_ops

    with Phase("5q craig, craigmr, lnlq, cgne, crmr end to end", 240):
        # The convection-diffusion stencil with 0.5 on its main diagonal at
        # 128^3, b seeded normal, in f32 and in f64: each public entry
        # point with its default options (the whole-solve kernel), then
        # with history=True (the general route through the DIA SpMV kernel
        # and its adjoint).  ms per solve, niter and us per iteration; the
        # true relative residual ||b - Ax|| / ||b|| (f64, the plain SpMV),
        # no worse than 1.5 times that of the kernel's plain version on the
        # same inputs, on both routes; the status the plain version gives;
        # and the launch counts, set to 0 just before each path and read
        # after.  The kernels line takes the launches of the f32 default
        # solves (CGNE's and CRMR's summed for their shared kernel).
        from krylov_tpu_torch.solvers.craig import _STATUS as craig_status
        from krylov_tpu_torch.solvers.cgne import _STATUS as cgne_status
        ln_status = {**craig_status, **cgne_status}
        ln_ops = {}
        for dt in (torch.float32, torch.float64):
            A = kt.DIAOperator(shifted_dia(128, dt))
            b = rhs(A.shape[0], dt, gen=np.random.default_rng(SEED + 17))
            n = b.shape[0]
            pd, ot = A._pd, A._offsets
            pda, offa = A.aligned_adjoint()
            ota = offsets_tensor(offa, dev)
            f32 = dt == torch.float32
            for method, (kernel_name, kwargs) in ln_cases.items():
                name = kernel_name + "_dia"
                solve = (lambda m=method, A=A, b=b, **kw:
                         getattr(kt, m)(A, b, **kw))
                ln_ops[method, f32] = solve
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                *_, stats = out = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                counts_fused = kt.kernel_launches()
                x = out[0]
                t = time.perf_counter()
                *_, sh = out_h = solve(history=True)
                torch.cuda.synchronize()
                ms_h = (time.perf_counter() - t) * 1e3
                counts = kt.kernel_launches()
                ref = getattr(cf, name + "_fused_ref")(
                    pd, pda, ot, ota, b, *ln_args(kernel_name, dt, n),
                    **kwargs)
                nvec = 1 if kernel_name == "cgne_crmr" else 2
                ref_niter, ref_code = [int(v) for v in ref[nvec:]
                                       if v.dtype == torch.int32]
                want = rt.decode_status(
                    rt.final_status_code(ref_code, 0, 1, False), ln_status)
                res = true_rel_residual(pd, ot, b, x)
                res_p = true_rel_residual(pd, ot, b, ref[0])
                res_h = true_rel_residual(pd, ot, b, out_h[0])
                label = f"{method} {'f32' if f32 else 'f64'}"
                print(f"  {label}: niter={stats.niter} status="
                      f"'{stats.status}' true_res={res:.3e} ms/solve="
                      f"{ms:.2f} us/iter={1e3 * ms / max(stats.niter, 1):.2f}"
                      f"; plain version: niter={ref_niter} status='{want}' "
                      f"true_res={res_p:.3e}; history=True: "
                      f"niter={sh.niter} status='{sh.status}' true_res="
                      f"{res_h:.3e} ms={ms_h:.1f}; launches "
                      f"{counts_fused[name]} ({name}), "
                      f"{counts['dia_spmv']} (dia_spmv, history)",
                      flush=True)
                check(stats.solved and sh.solved,
                      f"{label} stopped solved (both routes)")
                check(stats.status == want,
                      f"{label}: the plain version's status")
                check(all(v.shape == b.shape and v.dtype == dt
                          and bool(torch.isfinite(v).all())
                          for v in out[:-1]),
                      f"{label}: finite solutions of shape {tuple(b.shape)}")
                check(res <= 1.5 * res_p and res_h <= 1.5 * res_p,
                      f"{label}: true residuals {res:.3e}, {res_h:.3e} "
                      f"(history) <= 1.5 x the plain version's")
                check(sh.residuals.size == sh.niter + 1,
                      f"{label} (history=True) kept its history")
                check(counts_fused[name] > 0, f"{label} launched {name} "
                      f"({counts_fused[name]} times)")
                check(counts["dia_spmv"] > 0, f"{label} (history=True) "
                      f"launched dia_spmv ({counts['dia_spmv']} times)")
                if f32:
                    launches[name] = (launches.get(name, 0)
                                      + counts_fused[name])
                del ref, out, out_h, x
            del A, b, pd, ot, pda, ota

    with Phase("5r profiles of the five 128^3 least-norm solves", 120):
        for method in ln_cases:
            print(f"  {method} f64:", flush=True)
            profile_solve(lambda m=method: (None, ln_ops[m, False]()[-1]),
                          top=6)
    del ln_ops

    with Phase("5s cgls, crls, cgls_lanczos_shift, tricg end to end", 240):
        # The main path of the normal-equation family and TriCG at 128^3,
        # b and c seeded normal, in f32 and in f64: cgls(A, b, lam=0.1),
        # crls(A, b, lam=0.1) and cgls_lanczos_shift(A, b, [0.1, 1]) on
        # the convection-diffusion stencil and tricg(P, b, c) (tau = 1,
        # nu = -1) on the Poisson stencil, each public entry point with
        # its default options (the whole-solve kernel), then with
        # history=True (the general route through the DIA SpMV kernel and
        # its adjoint).  ms per solve, niter and us per iteration; the
        # true relative residual (f64, the plain SpMV: the normal-equation
        # residual ||A^H (b - Ax) - lam x|| / ||A^H b||, the largest over
        # the shifts, and TriCG's block residual), no worse than 1.5 times
        # that of the kernel's plain version on the same inputs, on both
        # routes; the plain version's status; niter equal to the plain
        # version's in f64 and within +-max(2, 10%) in f32; and the launch
        # counts, set to 0 just before each path and read after.  The
        # kernels line takes the launches of the f32 default solves.
        from krylov_tpu_torch.solvers.cgls import _CRLS_STATUS
        from krylov_tpu_torch.solvers.tricg import _STATUS as tricg_status
        nq_status = {**_CRLS_STATUS, **tricg_status}
        nq_ops = {}
        for dt in (torch.float32, torch.float64):
            gen = np.random.default_rng(SEED + 19)
            C = kt.DIAOperator(kt.convdiff_dia(128, dtype=dt))
            P = kt.DIAOperator(kt.poisson_dia(128, dtype=dt))
            b, c = rhs(128 ** 3, dt, gen), rhs(128 ** 3, dt, gen)
            n = b.shape[0]
            tol = rt.default_tol(None, dt)
            f32 = dt == torch.float32
            runs = {"cgls": (C, (b,), {"lam": 0.1}, (0.1, tol, tol, 2 * n)),
                    "crls": (C, (b,), {"lam": 0.1}, (0.1, tol, tol, 2 * n)),
                    "cgls_lanczos_shift": (
                        C, (b, nq_shifts), {},
                        (torch.tensor(nq_shifts, dtype=dt, device=dev), tol,
                         tol, 2 * n)),
                    "tricg": (P, (b, c), {}, (1.0, -1.0, tol, tol, 2 * n))}
            for method, (op, args, kw, ref_args) in runs.items():
                name = method + "_dia"
                pda, offa = op.aligned_adjoint()
                ota = offsets_tensor(offa, dev)
                head = (op._pd, pda, op._offsets, ota)
                tricg = method == "tricg"

                def res_of(out, op=op, pda=pda, ota=ota, tricg=tricg,
                           method=method, kw=kw):
                    if tricg:
                        return block_residual(op._pd, op._offsets, pda, ota,
                                              b, c, out[0], out[1], 1.0,
                                              -1.0)
                    lams = (nq_shifts if method == "cgls_lanczos_shift"
                            else [kw["lam"]])
                    X = out[0] if len(lams) > 1 else out[0][None]
                    return max(ne_residual(op._pd, op._offsets, pda, ota, b,
                                           X[i], lm)
                               for i, lm in enumerate(lams))

                solve = (lambda m=method, op=op, args=args, kw=kw, **extra:
                         getattr(kt, m)(op, *args, **kw, **extra))
                nq_ops[method, f32] = solve
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                *_, stats = out = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                counts_fused = kt.kernel_launches()
                t = time.perf_counter()
                *_, sh = out_h = solve(history=True)
                torch.cuda.synchronize()
                ms_h = (time.perf_counter() - t) * 1e3
                counts = kt.kernel_launches()
                ref = getattr(cf, name + "_fused_ref")(
                    *head, *((b, c) if tricg else (b,)), *ref_args)
                nvec = 2 if tricg else 1
                ref_niter = int(ref[nvec])
                ref_code = int(ref[3] if method == "cgls_lanczos_shift"
                               else ref[4])
                want = rt.decode_status(
                    rt.final_status_code(ref_code, 0, 1, False), nq_status)
                res, res_p, res_h = res_of(out), res_of(ref), res_of(out_h)
                label = f"{method} {'f32' if f32 else 'f64'}"
                print(f"  {label}: niter={stats.niter} status="
                      f"'{stats.status}' true_res={res:.3e} ms/solve="
                      f"{ms:.2f} us/iter={1e3 * ms / max(stats.niter, 1):.2f}"
                      f"; plain version: niter={ref_niter} status='{want}' "
                      f"true_res={res_p:.3e}; history=True: "
                      f"niter={sh.niter} status='{sh.status}' true_res="
                      f"{res_h:.3e} ms={ms_h:.1f}; launches "
                      f"{counts_fused[name]} ({name}), "
                      f"{counts['dia_spmv']} (dia_spmv, history)",
                      flush=True)
                check(stats.solved and sh.solved,
                      f"{label} stopped solved (both routes)")
                check(stats.status == want,
                      f"{label}: the plain version's status")
                band = 0 if not f32 else max(2, 0.1 * ref_niter)
                check(abs(stats.niter - ref_niter) <= band,
                      f"{label}: niter {stats.niter} within ±{band:g} of the "
                      f"plain version's {ref_niter}")
                check(all(bool(torch.isfinite(v).all())
                          and v.dtype == dt and v.shape[-1] == n
                          for v in out[:-1]),
                      f"{label}: finite solutions of width {n}")
                check(res <= 1.5 * res_p and res_h <= 1.5 * res_p,
                      f"{label}: true residuals {res:.3e}, {res_h:.3e} "
                      f"(history) <= 1.5 x the plain version's")
                hist = (sh.residuals if method != "cgls_lanczos_shift"
                        else sh.residuals[0])
                check(len(hist) >= 1, f"{label} (history=True) kept its "
                      "history")
                check(counts_fused[name] > 0, f"{label} launched {name} "
                      f"({counts_fused[name]} times)")
                check(counts["dia_spmv"] > 0, f"{label} (history=True) "
                      f"launched dia_spmv ({counts['dia_spmv']} times)")
                if f32:
                    launches[name] = counts_fused[name]
                del ref, out, out_h
            del C, P, b, c

    with Phase("5t profiles of the four 128^3 normal-equation and TriCG "
               "solves", 120):
        for method in ("cgls", "crls", "cgls_lanczos_shift", "tricg"):
            print(f"  {method} f64:", flush=True)
            profile_solve(lambda m=method: (None, nq_ops[m, False]()[-1]),
                          top=6)
    del nq_ops

    with Phase("5u trimr, gpmr, block_minres end to end", 240):
        # The main path of the eleventh slice at 128^3, right-hand sides
        # seeded normal, in f32 and in f64: trimr(P, b, c) (tau = 1,
        # nu = -1) on the Poisson stencil, gpmr(K, K^H, b, c, lam=1, mu=-1,
        # memory=48, itmax=48) with K = 0.1 (P + I) and K^H from
        # adjoint_dia(), block_minres(P + 0.5 I, B) with B of 4 columns,
        # each public entry point with its default options (the
        # whole-solve kernel), then with history=True (the general route
        # through the DIA SpMV kernel).  ms per solve, niter and us per
        # iteration; the plain version's status; niter within +-3
        # (TriMR), +-1 (GPMR) and +-2 (block MINRES) of the plain
        # version's; the true relative residual (f64, the plain SpMV) of
        # both routes no worse than 1.5 times the plain version's; the
        # launch counts, set to 0 just before each path and read after.
        # The kernels line takes the launches of the f32 default solves.
        from krylov_tpu_torch.solvers.tricg import _STATUS as tri_status
        sl_ops = {}
        for dt in (torch.float32, torch.float64):
            gen = np.random.default_rng(SEED + 21)
            n = 128 ** 3
            P = kt.DIAOperator(kt.poisson_dia(128, dtype=dt))
            K, KH = scaled_poisson(128, dt)
            A = shifted_poisson(128, dt, 0.5)
            b, c = rhs(n, dt, gen), rhs(n, dt, gen)
            B = torch.as_tensor(gen.standard_normal((n, 4))).to(dev, dt)
            tol = rt.default_tol(None, dt)
            f32 = dt == torch.float32
            pda, offa = P.aligned_adjoint()
            ota = offsets_tensor(offa, dev)
            runs = {
                "trimr": ((P, b, c), {}, 3,
                          lambda: cf.trimr_dia_fused_ref(
                              P._pd, pda, P._offsets, ota, b, c, 1.0, -1.0,
                              tol, tol, 2 * n),
                          lambda out: block_residual(
                              P._pd, P._offsets, pda, ota, b, c, out[0],
                              out[1], 1.0, -1.0)),
                "gpmr": ((K, KH, b, c), {"lam": 1.0, "mu": -1.0,
                                         "memory": 48, "itmax": 48}, 1,
                         lambda: cf.gpmr_dia_fused_ref(
                             K._pd, KH._pd, K._offsets, KH._offsets, b, c,
                             1.0, -1.0, tol, tol, 48, 48),
                         lambda out: stacked_residual(K, KH, b, c, out[0],
                                                      out[1], 1.0, -1.0)),
                "block_minres": ((A, B), {}, 2,
                                 lambda: cf.block_minres_dia_fused_ref(
                                     A._pd, A._offsets, B, tol, tol,
                                     2 * (n // 4)),
                                 lambda out: block_rel_residual(A, B,
                                                                out[0]))}
            for method, (args, kw, band, plain, res_of) in runs.items():
                name = method + "_dia"
                solve = (lambda m=method, args=args, kw=kw, **extra:
                         getattr(kt, m)(*args, **kw, **extra))
                sl_ops[method, f32] = solve
                torch.cuda.synchronize()
                reset_counts()
                t = time.perf_counter()
                *_, stats = out = solve()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t) * 1e3
                counts_fused = kt.kernel_launches()
                reset_counts()
                t = time.perf_counter()
                *_, sh = out_h = solve(history=True)
                torch.cuda.synchronize()
                ms_h = (time.perf_counter() - t) * 1e3
                counts = kt.kernel_launches()
                ref = plain()
                nvec = 1 if method == "block_minres" else 2
                ref_niter = int(ref[nvec])
                ref_code = rt.final_status_code(int(ref[nvec + 2]), 0, 1,
                                                False)
                if method == "gpmr" and int(ref[5]) and ref_code != 1:
                    ref_code = rt.INCONSISTENT
                want = rt.decode_status(ref_code, tri_status
                                        if method == "trimr" else None)
                res, res_p, res_h = res_of(out), res_of(ref), res_of(out_h)
                label = f"{method} {'f32' if f32 else 'f64'}"
                print(f"  {label}: niter={stats.niter} status="
                      f"'{stats.status}' true_res={res:.3e} ms/solve="
                      f"{ms:.2f} us/iter={1e3 * ms / max(stats.niter, 1):.2f}"
                      f"; plain version: niter={ref_niter} status='{want}' "
                      f"true_res={res_p:.3e}; history=True: "
                      f"niter={sh.niter} status='{sh.status}' true_res="
                      f"{res_h:.3e} ms={ms_h:.1f}; launches "
                      f"{counts_fused[name]} ({name}), "
                      f"{counts['dia_spmv']} (dia_spmv, history)",
                      flush=True)
                check(stats.solved and sh.solved,
                      f"{label} stopped solved (both routes)")
                check(stats.status == want,
                      f"{label}: the plain version's status")
                check(abs(stats.niter - ref_niter) <= band,
                      f"{label}: niter {stats.niter} within ±{band} of the "
                      f"plain version's {ref_niter}")
                check(all(bool(torch.isfinite(v).all()) and v.dtype == dt
                          and v.shape[0] == n for v in out[:-1]),
                      f"{label}: finite solutions of height {n}")
                check(res <= 1.5 * res_p and res_h <= 1.5 * res_p,
                      f"{label}: true residuals {res:.3e}, {res_h:.3e} "
                      f"(history) <= 1.5 x the plain version's")
                check(len(sh.residuals) >= 1, f"{label} (history=True) kept "
                      "its history")
                check(counts_fused[name] > 0, f"{label} launched {name} "
                      f"({counts_fused[name]} times)")
                check(counts["dia_spmv"] > 0 and counts[name] == 0,
                      f"{label} (history=True) launched dia_spmv "
                      f"({counts['dia_spmv']} times) and not {name}")
                if f32:
                    launches[name] = counts_fused[name]
                del ref, out, out_h
            del P, K, KH, A, b, c, B

    with Phase("5v profiles of the three 128^3 eleventh-slice solves", 120):
        for method in ("trimr", "gpmr", "block_minres"):
            print(f"  {method} f64:", flush=True)
            profile_solve(lambda m=method: (None, sl_ops[m, False]()[-1]),
                          top=6)
    del sl_ops

    with Phase("5w block_gmres end to end; BELL solves", 240):
        # The main path of the twelfth slice: block_gmres(P + 0.5 I, B,
        # memory=32, restart=True) at 128^3, B seeded normal with four
        # columns, in f32 and f64, by its whole-solve kernel (the default
        # options) and by the general core with history=True; a rank-1 B
        # (the full-rank probe sends it to the general core); then on the
        # block-tridiagonal BELL operator at nb = 1024 (131,072 unknowns,
        # f32) cg (bell_spmv on every product) and block_gmres and
        # block_minres with four columns (bell_spmm through matmat).  Each
        # solve's launch counts are set to 0 just before it and read
        # after; its true relative residual (f64, the plain products) is
        # held to 1.5 times the plain version's: the kernel's plain
        # version for block_gmres on DIA, the same solve on a matrix-free
        # operator through the plain BELL products for the BELL solves.
        # The kernels line takes the launches of the f32 default solve
        # and of the BELL solves.
        bg_ops = {}
        n = 128 ** 3
        for dt in (torch.float32, torch.float64):
            gen = np.random.default_rng(SEED + 32)
            A = shifted_poisson(128, dt, 0.5)
            B = torch.as_tensor(gen.standard_normal((n, 4))).to(dev, dt)
            tol = rt.default_tol(None, dt)
            f32 = dt == torch.float32
            label = f"block_gmres {'f32' if f32 else 'f64'}"

            def solve(A=A, B=B, **extra):
                return kt.block_gmres(A, B, memory=32, restart=True, **extra)

            bg_ops[f32] = solve
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            X, stats = solve()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            counts_fused = kt.kernel_launches()
            reset_counts()
            t = time.perf_counter()
            Xh, sh = solve(history=True)
            torch.cuda.synchronize()
            ms_h = (time.perf_counter() - t) * 1e3
            counts = kt.kernel_launches()
            ref = cf.block_gmres_dia_fused_ref(A._pd, A._offsets, B, tol,
                                               tol, 2 * (n // 4), 32)
            want = rt.decode_status(rt.final_status_code(int(ref[3]), 0, 1,
                                                         False))
            res, res_p, res_h = (block_rel_residual(A, B, v)
                                 for v in (X, ref[0], Xh))
            print(f"  {label}: niter={stats.niter} status='{stats.status}' "
                  f"true_res={res:.3e} ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(stats.niter, 1):.2f}; plain version: "
                  f"niter={int(ref[1])} status='{want}' true_res="
                  f"{res_p:.3e}; history=True: niter={sh.niter} status="
                  f"'{sh.status}' true_res={res_h:.3e} ms={ms_h:.1f}; "
                  f"launches {counts_fused['block_gmres_dia']} "
                  f"(block_gmres_dia), {counts['dia_spmv']} (dia_spmv, "
                  f"history)", flush=True)
            check(stats.solved and sh.solved,
                  f"{label} stopped solved (both routes)")
            check(stats.status == want, f"{label}: the plain version's "
                  "status")
            check(abs(stats.niter - int(ref[1])) <= 2,
                  f"{label}: niter {stats.niter} within ±2 of the plain "
                  f"version's {int(ref[1])}")
            check(bool(torch.isfinite(X).all()) and X.dtype == dt
                  and tuple(X.shape) == (n, 4),
                  f"{label}: a finite X of shape ({n}, 4)")
            check(res <= 1.5 * res_p and res_h <= 1.5 * res_p,
                  f"{label}: true residuals {res:.3e}, {res_h:.3e} "
                  f"(history) <= 1.5 x the plain version's")
            check(counts_fused["block_gmres_dia"] > 0
                  and counts_fused["dia_spmv"] == 0,
                  f"{label} launched block_gmres_dia "
                  f"({counts_fused['block_gmres_dia']} times) and not the "
                  "general core")
            check(counts["dia_spmv"] > 0 and counts["block_gmres_dia"] == 0
                  and len(sh.residuals) == sh.niter + 1,
                  f"{label} (history=True) launched dia_spmv "
                  f"({counts['dia_spmv']} times), not block_gmres_dia, and "
                  "kept its history")
            if f32:
                launches["block_gmres_dia"] = counts_fused["block_gmres_dia"]
                B1 = B[:, :1].repeat(1, 4).contiguous()
                reset_counts()
                X1, s1 = solve(B=B1)
                counts = kt.kernel_launches()
                res1 = block_rel_residual(A, B1, X1)
                print(f"  block_gmres f32, rank-1 B: niter={s1.niter} status="
                      f"'{s1.status}' true_res={res1:.3e}; launches "
                      f"{counts['block_gmres_dia']} (block_gmres_dia), "
                      f"{counts['dia_spmv']} (dia_spmv)", flush=True)
                check(s1.solved and counts["block_gmres_dia"] == 0
                      and counts["dia_spmv"] > 0 and res1 <= 1.5 * tol,
                      "a rank-1 B took the general core and solved")
            del A, B, X, Xh, ref
        Ab = bell_tridiagonal(kt, 1024, torch.float32, SEED + 33)
        Ab64 = kt.BELLMatrix(Ab.data.double(), Ab.indices, Ab.shape, 128)
        nB = Ab.shape[0]
        op = kt.BELLOperator(Ab)
        plain_op = kt.FunctionOperator(
            lambda v: cspmv.bell_spmv_ref(Ab, v), Ab.shape, torch.float32)
        gen = np.random.default_rng(SEED + 34)
        b = torch.as_tensor(gen.standard_normal(nB)).to(dev, torch.float32)
        B = torch.as_tensor(gen.standard_normal((nB, 4))).to(
            dev, torch.float32)

        def bell_res(S, Y):
            S2, Y2 = (S, Y) if S.dim() == 2 else (S[:, None], Y[:, None])
            R = S2.double() - cspmv.bell_spmm_ref(Ab64, Y2.double())
            return float(R.norm() / S2.double().norm())

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        launches["bell_spmm"] = 0
        for method, rhs_, name in (("cg", b, "bell_spmv"),
                                   ("block_gmres", B, "bell_spmm"),
                                   ("block_minres", B, "bell_spmm")):
            solve = getattr(kt, method)
            # each route once untimed (the operator's first products bind
            # its plan), then three rounds of the kernel route and the
            # plain products one after the other; the first round's kernel
            # solve is the main path's, driven with the counts set to 0
            solve(op, rhs_)
            solve(plain_op, rhs_)
            rounds = []
            for r in range(3):
                if r == 0:
                    torch.cuda.synchronize()
                    reset_counts()
                (Y, st), ms = timed(lambda: solve(op, rhs_))
                if r == 0:
                    counts = kt.kernel_launches()
                    Y0, st0 = Y, st
                (Yp, sp), ms_p = timed(lambda: solve(plain_op, rhs_))
                rounds.append((ms, ms_p))
            Y, st = Y0, st0
            res, res_p = bell_res(rhs_, Y), bell_res(rhs_, Yp)
            ms = statistics.median(r[0] for r in rounds)
            pairs = ", ".join(f"{k:.2f}/{q:.2f}" for k, q in rounds)
            print(f"  {method} on BELL nb=1024 f32: niter={st.niter} status="
                  f"'{st.status}' true_res={res:.3e} ms/solve={ms:.2f} "
                  f"({1e3 * ms / max(st.niter, 1):.1f} us/iter; "
                  f"{counts[name]} products); plain products: niter="
                  f"{sp.niter} true_res={res_p:.3e} ms/solve="
                  f"{statistics.median(r[1] for r in rounds):.2f}; ms per "
                  f"round, kernel/plain: {pairs}", flush=True)
            profile_solve(lambda: solve(op, rhs_), top=4)
            check(st.solved and st.status == sp.status
                  and abs(st.niter - sp.niter) <= 2,
                  f"{method} on BELL solved as with the plain products")
            check(res <= 1.5 * res_p, f"{method} on BELL: true residual "
                  f"{res:.3e} <= 1.5 x the plain products' {res_p:.3e}")
            check(counts[name] > 0, f"{method} on BELL launched {name} "
                  f"({counts[name]} times)")
            if name == "bell_spmv":
                launches[name] = counts[name]
            else:
                launches[name] += counts[name]
        del Ab, Ab64, op, plain_op

    with Phase("5x profiles of the 128^3 block GMRES solves", 60):
        for f32 in (True, False):
            print(f"  block_gmres {'f32' if f32 else 'f64'}:", flush=True)
            profile_solve(lambda f32=f32: bg_ops[f32](), top=12)
    del bg_ops

    with Phase("5y general-sparse solves through the CSR routing", 240):
        # The main path of the thirteenth slice: kt.cg(csr, b) with the
        # default options on the SPD FEM band of phase 2c (n = 2^17, f32):
        # solve_inputs -> as_operator -> the HybridOperator analysed in
        # 2c and cached on the matrix -> the general CG core ->
        # hybrid_spmv -> dia_spmv on the diagonal and sell_spmv on the
        # rest.  Held against the same solve through CSROperator (gather
        # and index_add_): the same status, niter within ±max(2, 10%),
        # a true relative residual (f64, the plain CSR product) no worse
        # than 1.5 times its.  Then bicgstab on the unsymmetric band with
        # its dominant diagonal (f32), lsqr on it in f64 (the adjoint's
        # analysis replaces the cached operator; sell_spmv runs on A^H's
        # SELL), and the 3-D Poisson stencil at 64^3 handed over as CSR
        # (pure DIA: dia_spmv, no sell_spmv, the niter of
        # cg(DIAOperator, history=True)).  Each solve's counts are set to
        # 0 just before it and read just after; host analysis times on
        # their own lines (not part of the solve times).
        from krylov_tpu_torch.ops.sparse import CSRMatrix, spmv as csr_spmv

        def csr_rel_residual(csr, b, x):
            c64 = CSRMatrix(csr.data.double(), csr.indices, csr.indptr,
                            csr.rows, csr.shape)
            r = b.double() - csr_spmv(c64, x.double())
            return float(r.norm() / b.double().norm())

        def timed(fn):
            torch.cuda.synchronize()
            reset_counts()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3, kt.kernel_launches()

        gen = np.random.default_rng(SEED + 41)
        b32 = torch.as_tensor(gen.standard_normal(nf)).to(dev, torch.float32)
        ur, uc, uv = dominant(fr, fc, fv, nf, False)
        t = time.perf_counter()
        fem_u = kt.csr_from_coo(ur, uc, uv.astype(np.float32), (nf, nf))
        kt.as_operator(fem_u)
        t_u = time.perf_counter() - t
        def spd_solve():
            return kt.cg(fem_spd, b32)

        solves = [("cg SPD band f32", spd_solve,
                   lambda: kt.cg(kt.CSROperator(fem_spd), b32), fem_spd,
                   b32),
                  ("bicgstab unsymmetric band f32",
                   lambda: kt.bicgstab(fem_u, b32),
                   lambda: kt.bicgstab(kt.CSROperator(fem_u), b32), fem_u,
                   b32)]
        t = time.perf_counter()
        fem_u64 = kt.csr_from_coo(ur, uc, uv, (nf, nf))
        b64 = b32.double()
        u64_op = kt.as_operator(fem_u64).with_adjoint()
        t_u64 = time.perf_counter() - t
        print(f"  host analysis: SPD band {t_spd:.2f} s (phase 2c); "
              f"unsymmetric band {t_u:.2f} s; in f64 with its adjoint "
              f"{t_u64:.2f} s", flush=True)
        check(fem_u64._hybrid_op is u64_op and u64_op.hyb_h is not None
              and u64_op.hyb_h.sell is not None,
              "the adjoint-capable operator replaced the cached one")
        hybrid_vs_plain("unsymmetric band f32", fem_u._hybrid_op, fem_u, b32,
                        1e-5)
        hybrid_vs_plain("unsymmetric band f64", u64_op, fem_u64, b64, 1e-12)
        solves.append(("lsqr unsymmetric band f64",
                       lambda: kt.lsqr(fem_u64, b64),
                       lambda: kt.lsqr(kt.CSROperator(fem_u64), b64),
                       fem_u64, b64))
        for label, solve, plain, csr, b in solves:
            # three solves each, in turns; the median time of each
            runs = [(timed(solve), timed(plain)) for _ in range(3)]
            (x, st), _, counts = runs[0][0]
            (xc, sc), _, _ = runs[0][1]
            ms = statistics.median(r[0][1] for r in runs)
            ms_c = statistics.median(r[1][1] for r in runs)
            res, res_c = csr_rel_residual(csr, b, x), csr_rel_residual(
                csr, b, xc)
            per_it = (counts["dia_spmv"] + counts["sell_spmv"]) / max(
                st.niter, 1)
            print(f"  {label}: niter={st.niter} status='{st.status}' "
                  f"true_res={res:.3e} ms/solve={ms:.2f} us/iter="
                  f"{1e3 * ms / max(st.niter, 1):.2f} launches dia_spmv="
                  f"{counts['dia_spmv']} sell_spmv={counts['sell_spmv']} "
                  f"({per_it:.2f} SpMV launches per iteration); "
                  f"CSROperator: niter={sc.niter} status='{sc.status}' "
                  f"true_res={res_c:.3e} ms/solve={ms_c:.2f}; ratio "
                  f"{ms / ms_c:.3f}", flush=True)
            check(st.status == sc.status and abs(st.niter - sc.niter)
                  <= max(2, 0.1 * sc.niter),
                  f"{label}: CSROperator's status, niter {st.niter} within "
                  f"±max(2, 10%) of {sc.niter}")
            check(bool(torch.isfinite(x).all()) and x.shape == b.shape
                  and res <= 1.5 * res_c,
                  f"{label}: true residual {res:.3e} <= 1.5 x "
                  f"CSROperator's {res_c:.3e}")
            check(counts["dia_spmv"] > 0 and counts["sell_spmv"] > 0,
                  f"{label} launched dia_spmv ({counts['dia_spmv']}) and "
                  f"sell_spmv ({counts['sell_spmv']})")
            if label.startswith("cg"):
                launches["sell_spmv"] = counts["sell_spmv"]
        check(fem_u64._hybrid_op is u64_op,
              "lsqr ran on the cached adjoint-capable operator")
        del fem_u, fem_u64, u64_op, b64
        P = kt.poisson_dia(64)
        n64 = P.shape[0]
        pdata = P.data.cpu().numpy()
        pr, pc, pv = [], [], []
        for d, k in enumerate(P.offsets):
            i = np.arange(max(0, -k), min(n64, n64 - k))
            v = pdata[d, i + k]
            pr.append(i[v != 0])
            pc.append(i[v != 0] + k)
            pv.append(v[v != 0])
        p_csr = kt.csr_from_coo(np.concatenate(pr), np.concatenate(pc),
                                np.concatenate(pv), (n64, n64))
        t = time.perf_counter()
        p_op = kt.as_operator(p_csr)
        print(f"  host analysis: 64^3 Poisson as CSR "
              f"({p_csr.nnz} nonzeros) {time.perf_counter() - t:.2f} s",
              flush=True)
        check(p_op.hyb.sell is None and p_op.hyb.dia.offsets == P.offsets,
              "the 64^3 Poisson CSR analyses to pure DIA with the "
              "stencil's offsets")
        bp = torch.as_tensor(gen.standard_normal(n64)).to(dev,
                                                          torch.float32)
        (xp, sp_), ms, counts = timed(lambda: kt.cg(p_csr, bp))
        (_, sd), _, _ = timed(lambda: kt.cg(P, bp, history=True))
        print(f"  cg 64^3 Poisson as CSR: niter={sp_.niter} status="
              f"'{sp_.status}' ms/solve={ms:.2f} launches dia_spmv="
              f"{counts['dia_spmv']} sell_spmv={counts['sell_spmv']}; "
              f"cg(DIAOperator, history=True): niter={sd.niter}",
              flush=True)
        check(sp_.solved and sp_.niter == sd.niter
              and counts["dia_spmv"] > 0 and counts["sell_spmv"] == 0,
              "cg on the Poisson CSR solved in the niter of the DIA "
              "operator's general route, through dia_spmv and no sell_spmv")
        del P, p_csr, p_op, xp, bp
        print("  profile of the SPD band cg solve:", flush=True)
        profile_solve(spd_solve)
        print("  profile of the same solve through CSROperator:", flush=True)
        profile_solve(lambda: kt.cg(kt.CSROperator(fem_spd), b32))
    del fem_spd, spd_op, b32

    with Phase("5e dtype and device repairs on the card (64^3)", 90):
        # An f64 numpy b on f32 diagonals (the general route, through the
        # (f64, f32) SpMV), a complex128 cr (through the (c128, f64)
        # SpMV) and a Jacobi M built from numpy d beside a card system
        # (the CG kernel with dinv), each solved to its default tolerance
        # with a true relative residual within 1.5 x rtol.
        nb = np.random.default_rng(SEED + 3).standard_normal(64 ** 3)
        A32 = kt.poisson_dia(64)
        A64 = kt.poisson_dia(64, dtype=torch.float64)
        pd64 = dia_align(A64.data, A64.offsets, A64.shape[0])
        ot = offsets_tensor(A64.offsets, dev)
        runs = [("cg, f64 numpy b on f32 diagonals", "dia_spmv",
                 lambda: kt.cg(A32, nb), torch.from_numpy(nb)),
                ("cr, complex128", "dia_spmv",
                 lambda: kt.cr(A64, torch.as_tensor(nb * (1.0 + 0.5j),
                                                    device=dev)),
                 torch.from_numpy(nb * (1.0 + 0.5j))),
                ("cg, Jacobi M from numpy d", "cg_dia",
                 lambda: kt.cg(kt.DIAOperator(A32), nb.astype(np.float32),
                               M=kt.DiagonalOperator(np.full(
                                   64 ** 3, 1.0 / 6.0, np.float32))),
                 torch.from_numpy(nb.astype(np.float32)))]
        for label, kernel, solve, b_host in runs:
            torch.cuda.synchronize()
            reset_counts()
            x, stats = solve()
            torch.cuda.synchronize()
            count = kt.kernel_launches()[kernel]
            bd = b_host.to(dev)
            res = true_rel_residual(pd64, ot, bd, x)
            rtol = rt.default_tol(None, bd.dtype)
            print(f"  {label}: x {x.dtype} on {x.device} niter={stats.niter}"
                  f" status='{stats.status}' true_res={res:.3e} {kernel} "
                  f"launches={count}", flush=True)
            check(x.is_cuda and x.dtype == bd.dtype and stats.solved,
                  f"{label} solved on the card")
            check(res <= 1.5 * rtol, f"{label}: true residual {res:.2e} <= "
                  "1.5·rtol")
            check(count > 0, f"{label} launched {kernel} ({count} times)")
        del A32, A64, pd64

    with Phase("5h krylov_solve and workspaces on the card (64^3)", 90):
        # Each of the thirty-nine methods through krylov_solve (the
        # non-symmetric ten, CGLS, CRLS and CGLS-Lanczos-shift on the
        # convection-diffusion stencil, CGS and BiLQR in f64, the four SSY
        # methods, LSQR, LSMR, LSLQ, CRAIG, CRAIGMR, LNLQ, CGNE and CRMR on
        # the stencil with 0.5 on its main diagonal, TriCG and TriMR on the
        # Poisson stencil, GPMR on K = 0.1 (P + I) and K^H, block MINRES on
        # the Poisson stencil with two columns, block GMRES (memory 32,
        # restart) on the shifted stencil with two columns), against a direct
        # call of its solver on the same inputs: the same status, niter and
        # x (and y) (bit for bit: the kernels sum in a fixed order); then a
        # BiLQR and a TriLQR workspace, and one workspace round trip
        # (krylov_workspace, warm_start, krylov_solve_inplace) whose
        # show_workspace reports the GPU.
        A = kt.DIAOperator(kt.poisson_dia(64))
        Acd = kt.DIAOperator(kt.convdiff_dia(64))
        Acd64 = kt.DIAOperator(kt.convdiff_dia(64, dtype=torch.float64))
        b = rhs(64 ** 3, gen=np.random.default_rng(SEED + 5))
        c64 = rhs(64 ** 3, torch.float64,
                  gen=np.random.default_rng(SEED + 10))
        Ash = kt.DIAOperator(shifted_dia(64))
        c32 = rhs(64 ** 3, gen=np.random.default_rng(SEED + 13))
        K64, KH64 = scaled_poisson(64, torch.float32)
        for method in ("cg", "cr", "car", "cg_lanczos", "cg_lanczos_shift",
                       "symmlq", "minres", "minres_qlp", "minares", "gmres",
                       "fgmres", "fom", "bicgstab", "cgs", "diom", "dqgmres",
                       "bilq", "qmr", "bilqr", "usymlq", "usymqr", "trilqr",
                       "usymlqr", "lsqr", "lsmr", "lslq", "craig", "craigmr",
                       "lnlq", "cgne", "crmr", "cgls", "crls",
                       "cgls_lanczos_shift", "tricg", "trimr", "gpmr",
                       "block_minres", "block_gmres"):
            extra = ([0.0, 1.0],) if method == "cg_lanczos_shift" else ()
            op, bm = (Acd if method in ("gmres", "fgmres", "fom",
                                        "bicgstab", "diom", "dqgmres",
                                        "bilq", "qmr", "cgls", "crls",
                                        "cgls_lanczos_shift") else A), b
            if method == "cgls_lanczos_shift":
                extra = (nq_shifts,)
            if method in ("tricg", "trimr"):
                extra = (c32,)
            if method == "gpmr":
                op, bm, extra = K64, KH64, (b, c32)
            if method in ("block_minres", "block_gmres"):
                bm = torch.stack([b, c32], 1)
            if method == "block_gmres":
                op = Ash
            if method in ("cgs", "bilqr"):   # in f64, as phase 3e says
                op, bm = Acd64, b.double()
            if method == "bilqr":
                extra = (c64,)
            if method in ("usymlq", "usymqr", "trilqr", "usymlqr"):
                op, extra = Ash, (c32,)
            if method in ("lsqr", "lsmr", "lslq", "craig", "craigmr", "lnlq",
                          "cgne", "crmr"):
                op = Ash
            kw = ({"lam": 1.0, "mu": -1.0, "memory": 48, "itmax": 48}
                  if method == "gpmr" else {"memory": 32, "restart": True}
                  if method == "block_gmres" else {})
            *xs, st = kt.krylov_solve(method, op, bm, *extra, **kw)
            *xd, sd = getattr(kt, method)(op, bm, *extra, **kw)
            torch.cuda.synchronize()
            print(f"  {method}: niter={st.niter} status='{st.status}'",
                  flush=True)
            check(all(x.is_cuda for x in xs) and st.status == sd.status
                  and st.niter == sd.niter
                  and all(torch.equal(x, y) for x, y in zip(xs, xd)),
                  f"krylov_solve('{method}') equals {method}(A, b)")
        ws = kt.krylov_workspace("bilqr", Acd64, b.double())
        kt.krylov_solve_inplace(ws, Acd64, b.double(), c64)
        check(kt.issolved_primal(ws) and kt.issolved_dual(ws)
              and kt.Aprod_count(ws) == kt.Atprod_count(ws)
              == kt.iteration_count(ws) and len(kt.solution(ws)) == 2,
              "a BiLQR workspace: both solved, one A and one A^H product "
              "per iteration, two solutions")
        ws = kt.krylov_workspace("minres_qlp", A, b)
        x0 = 0.5 * kt.minres_qlp(A, b)[0]
        kt.warm_start(ws, x0)
        kt.krylov_solve_inplace(ws, A, b)
        torch.cuda.synchronize()
        shown = kt.show_workspace(ws)
        print(shown, flush=True)
        res = true_rel_residual(A._pd, A._offsets, b, kt.solution(ws))
        check(kt.issolved(ws) and kt.iteration_count(ws) >= 1,
              f"workspace round trip solved ({kt.iteration_count(ws)} "
              f"iterations from the warm start, true residual {res:.2e})")
        check("architecture       GPU" in shown,
              "show_workspace reports the GPU")
        ws = kt.krylov_workspace("trilqr", Ash, b)
        kt.krylov_solve_inplace(ws, Ash, b, c32)
        check(kt.issolved_primal(ws) and kt.issolved_dual(ws)
              and kt.Aprod_count(ws) == kt.Atprod_count(ws)
              == kt.iteration_count(ws) and len(kt.solution(ws)) == 2,
              "a TriLQR workspace: both solved, one A and one A^H product "
              "per iteration, two solutions")
        del A, Acd, Acd64, Ash, b, c32, c64, K64, KH64

    launches["dia_spmv_padded"] = launches_padded
    sources = {"dia_spmv": ("krylov_tpu_torch/csrc/dia_spmv.cu",
                            "krylov_tpu/ops/pallas_dia.py:105"),
               "dia_spmv_padded": ("krylov_tpu_torch/csrc/dia_spmv.cu",
                                   "krylov_tpu/ops/pallas_dia.py:226"),
               "cg_dia": ("krylov_tpu_torch/csrc/cg_dia.cu",
                          "krylov_tpu/ops/pallas_fused.py:73"),
               "cg_cheby_dia": ("krylov_tpu_torch/csrc/cg_cheby_dia.cu",
                                "krylov_tpu/ops/pallas_fused.py:261"),
               "minres_dia": ("krylov_tpu_torch/csrc/minres_dia.cu",
                              "krylov_tpu/ops/pallas_fused.py:465"),
               "cr_dia": ("krylov_tpu_torch/csrc/cr_dia.cu",
                          "krylov_tpu/ops/pallas_fused.py:727"),
               "car_dia": ("krylov_tpu_torch/csrc/car_dia.cu",
                           "krylov_tpu/ops/pallas_fused.py:879"),
               "cg_lanczos_dia": ("krylov_tpu_torch/csrc/cg_lanczos_dia.cu",
                                  "krylov_tpu/ops/pallas_fused.py:1021"),
               "cg_lanczos_shift_dia": (
                   "krylov_tpu_torch/csrc/cg_lanczos_shift_dia.cu",
                   "krylov_tpu/ops/pallas_fused.py:1181"),
               "symmlq_dia": ("krylov_tpu_torch/csrc/symmlq_dia.cu",
                              "krylov_tpu/ops/pallas_fused.py:3722"),
               "minres_qlp_dia": ("krylov_tpu_torch/csrc/minres_qlp_dia.cu",
                                  "krylov_tpu/ops/pallas_fused.py:3935"),
               "minares_dia": ("krylov_tpu_torch/csrc/minares_dia.cu",
                               "krylov_tpu/ops/pallas_fused.py:4217"),
               "gmres_dia": ("krylov_tpu_torch/csrc/gmres_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:1922"),
               "fom_dia": ("krylov_tpu_torch/csrc/fom_dia.cu",
                           "krylov_tpu/ops/pallas_fused.py:4933"),
               "bicgstab_dia": ("krylov_tpu_torch/csrc/bicgstab_dia.cu",
                                "krylov_tpu/ops/pallas_fused.py:3016"),
               "cgs_dia": ("krylov_tpu_torch/csrc/cgs_dia.cu",
                           "krylov_tpu/ops/pallas_fused.py:3149"),
               "trunc_dia": ("krylov_tpu_torch/csrc/trunc_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:5160"),
               "bilq_dia": ("krylov_tpu_torch/csrc/bilq_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:4545"),
               "qmr_dia": ("krylov_tpu_torch/csrc/qmr_dia.cu",
                           "krylov_tpu/ops/pallas_fused.py:4755"),
               "bilqr_dia": ("krylov_tpu_torch/csrc/bilqr_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:7400"),
               "usymlq_dia": ("krylov_tpu_torch/csrc/usymlq_dia.cu",
                              "krylov_tpu/ops/pallas_fused.py:6565"),
               "usymqr_dia": ("krylov_tpu_torch/csrc/usymqr_dia.cu",
                              "krylov_tpu/ops/pallas_fused.py:6756"),
               "trilqr_dia": ("krylov_tpu_torch/csrc/trilqr_dia.cu",
                              "krylov_tpu/ops/pallas_fused.py:7695"),
               "usymlqr_dia": ("krylov_tpu_torch/csrc/usymlqr_dia.cu",
                               "krylov_tpu/ops/pallas_fused.py:7968"),
               "lsqr_dia": ("krylov_tpu_torch/csrc/lsqr_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:1394"),
               "lsmr_dia": ("krylov_tpu_torch/csrc/lsmr_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:1641"),
               "lslq_dia": ("krylov_tpu_torch/csrc/lslq_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:6942"),
               "cgne_crmr_dia": ("krylov_tpu_torch/csrc/cgne_crmr_dia.cu",
                                 "krylov_tpu/ops/pallas_fused.py:3571"),
               "craig_dia": ("krylov_tpu_torch/csrc/craig_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:5922"),
               "craigmr_dia": ("krylov_tpu_torch/csrc/craigmr_dia.cu",
                               "krylov_tpu/ops/pallas_fused.py:6132"),
               "lnlq_dia": ("krylov_tpu_torch/csrc/lnlq_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:6345"),
               "cgls_dia": ("krylov_tpu_torch/csrc/cgls_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:3309"),
               "crls_dia": ("krylov_tpu_torch/csrc/crls_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:3429"),
               "cgls_lanczos_shift_dia": (
                   "krylov_tpu_torch/csrc/cgls_lanczos_shift_dia.cu",
                   "krylov_tpu/ops/pallas_fused.py:7217"),
               "tricg_dia": ("krylov_tpu_torch/csrc/tricg_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:5427"),
               "trimr_dia": ("krylov_tpu_torch/csrc/trimr_dia.cu",
                             "krylov_tpu/ops/pallas_fused.py:5639"),
               "gpmr_dia": ("krylov_tpu_torch/csrc/gpmr_dia.cu",
                            "krylov_tpu/ops/pallas_fused.py:8220"),
               "block_minres_dia": (
                   "krylov_tpu_torch/csrc/block_minres_dia.cu",
                   "krylov_tpu/ops/pallas_fused.py:2669"),
               "block_gmres_dia": (
                   "krylov_tpu_torch/csrc/block_gmres_dia.cu",
                   "krylov_tpu/ops/pallas_fused.py:2221"),
               "bell_spmv": ("krylov_tpu_torch/csrc/bell_spmv.cu",
                             "krylov_tpu/ops/pallas_spmv.py:172"),
               "bell_spmm": ("krylov_tpu_torch/csrc/bell_spmv.cu",
                             "krylov_tpu/ops/pallas_spmv.py:236"),
               "sell_spmv": ("krylov_tpu_torch/csrc/sell_spmv.cu",
                             "krylov_tpu/ops/pallas_sell.py:335")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **report[name])
               for name, (src, rep) in sources.items()]
    kernels = [{k: kern[k] for k in ("name", "route", "source", "replaces",
                                     "launches", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")} for kern in kernels]
    elapsed = time.perf_counter() - T0
    print(f"[6] elapsed {elapsed:.1f} s", flush=True)
    if elapsed > TOTAL_LIMIT_S:
        raise RuntimeError(f"run took {elapsed:.0f} s, over "
                           f"{TOTAL_LIMIT_S:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def import_root(root):
    """The krylov_tpu_torch of checkout ROOT, imported in its place of
    this checkout's."""
    from pathlib import Path
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import krylov_tpu_torch as kt
    if Path(kt.__file__).resolve().parent != root / "krylov_tpu_torch":
        raise RuntimeError(f"imported {kt.__file__}, not ROOT's package")
    return root, kt


def two_sided_main(root):
    """``python3 chip_smoke.py --two-sided ROOT``: the BiLQ, QMR and BiLQR
    kernels of the krylov_tpu_torch in checkout ROOT at 128^3 f64 and f32
    and with f32 vectors on bf16 diagonals (itmax 1000), and its DQGMRES
    and DIOM kernels at 128^3 f32 with memory 20, on phase 3f's inputs
    (convdiff_dia(128), its seeded b and c, rtol 1e-10 in f64 and 1e-6 in
    f32, itmax 2n), its GMRES (memory 20, memory 20 with a
    bf16 panel, memory 512) and FOM (memory 20) kernels at 128^3 f32 on
    phase 3c's inputs (the same stencil, that phase's first b, rtol 1e-6,
    itmax 2n), its TriLQR, USYMLQR, USYMLQ and USYMQR kernels at 128^3
    f32 on phase 3g's (convdiff_dia(128) + 0.5 I, that phase's seeded b
    and c, rtol 1e-6, itmax 2n) and its TriCG and TriMR kernels at 128^3
    f32 on phase 3j's and 3k's (poisson_dia(128), tau = 1, nu = -1, each
    phase's seeded b and c, the default tolerances, itmax 2n), as one
    JSON line: each solve's ms by CUDA events (one warm-up, three timed),
    niter, status code, us per iteration and a digest of the bytes of x
    (and y), and from one profiled solve the device's busy share, device
    us, the launched iterations (the most calls of one kernel), device us
    per launched iteration and each kernel's device us and calls.
    ``--compare`` runs it in a process of its own, whose profiler traces
    keep their records (PERF.md section 7)."""
    import hashlib
    _, kt = import_root(root)
    from krylov_tpu_torch import _build
    from krylov_tpu_torch import _runtime as rt
    from krylov_tpu_torch.ops import cuda_fused as cf
    from krylov_tpu_torch.ops.cuda_dia import dia_align, offsets_tensor
    _build.library()
    # phase 3f's draws: b and c of 128^3, of 64^3, then of 128^3 in f64
    gen = np.random.default_rng(SEED + 8)
    n = 128 ** 3
    b32, c32 = (torch.as_tensor(gen.standard_normal(n)).to(
        "cuda", torch.float32) for _ in range(2))
    for m in (64 ** 3, 64 ** 3):
        gen.standard_normal(m)
    dt = torch.float64
    b = torch.as_tensor(gen.standard_normal(n)).to("cuda", dt)
    c = torch.as_tensor(gen.standard_normal(n)).to("cuda", dt)

    def aligned(A):
        pd = dia_align(A.data, A.offsets, n)
        pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
        return (pd, pda, offsets_tensor(A.offsets, "cuda"),
                offsets_tensor(offa, "cuda"))

    def seeded_pair(seed, skip):
        """b and c in f32: the draws after ``skip`` of a phase's seed."""
        g = np.random.default_rng(seed)
        g.standard_normal(skip)
        return tuple(torch.as_tensor(g.standard_normal(n)).to(
            "cuda", torch.float32) for _ in range(2))

    systems = {sdt: aligned(kt.convdiff_dia(128, dtype=sdt))
               for sdt in (torch.float64, torch.float32)}
    pd, pda, ot, ota = systems[dt]
    pd32, pda32, ot32, ota32 = systems[torch.float32]
    tol = (0.0, 1e-10, 2 * n)
    # phase 3f's f32 BiLQ, QMR and BiLQR, and the same on the diagonals
    # rounded to bf16 (at most 1000 iterations)
    two32 = (pd32, pda32, ot32, ota32, b32, c32, 0.0, 1e-6, 2 * n)
    two16 = (pd32.to(torch.bfloat16), pda32.to(torch.bfloat16), ot32, ota32,
             b32, c32, 0.0, 1e-6, 1000)
    tol32 = (0.0, 1e-6, 2 * n, 20)
    # phase 3c's first draw: the b of its 128^3 f32 cases
    bn = torch.as_tensor(np.random.default_rng(SEED + 6).standard_normal(
        n)).to("cuda", torch.float32)
    arnoldi = (pd32, ot32, bn, 0.0, 1e-6, 2 * n)
    # phase 3g's system and its first two draws; phases 3j's and 3k's
    # Poisson system and the draws of their 128^3 f32 TriCG and TriMR
    # cases (after 64^3 x 4 and 128^3 x 2 draws in 3j, 64^3 x 10 in 3k)
    S = kt.convdiff_dia(128, dtype=torch.float32)
    S.data[S.offsets.index(0)] += 0.5
    ssy = aligned(S) + seeded_pair(SEED + 11, 0) + (0.0, 1e-6, 2 * n)
    del S
    poisson = aligned(kt.poisson_dia(128, dtype=torch.float32))
    ptol = rt.default_tol(None, torch.float32)
    tri = (1.0, -1.0, ptol, ptol, 2 * n)
    tricg_rhs = seeded_pair(SEED + 18, 4 * 64 ** 3 + 2 * n)
    trimr_rhs = seeded_pair(SEED + 20, 10 * 64 ** 3)
    # (niter, status) positions of the outputs that differ from
    # (x, niter, rnorm, status); two solutions where niter is third
    where = {"bilqr": (2, 5), "trilqr": (2, 5), "usymlqr": (2, 5),
             "tricg": (2, 4), "trimr": (2, 4), "usymqr": (1, 4)}
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for name, kernel, args in (
            ("bilq", cf.bilq_dia_fused,
             (pd, pda, ot, ota, b) + tol + (True,)),
            ("qmr", cf.qmr_dia_fused, (pd, pda, ot, ota, b) + tol),
            ("bilqr", cf.bilqr_dia_fused,
             (pd, pda, ot, ota, b, c) + tol + (True,)),
            ("bilq f32", cf.bilq_dia_fused, two32[:5] + two32[6:] + (True,)),
            ("qmr f32", cf.qmr_dia_fused, two32[:5] + two32[6:]),
            ("bilqr f32", cf.bilqr_dia_fused, two32 + (True,)),
            ("bilq bf16 diagonals", cf.bilq_dia_fused,
             two16[:5] + two16[6:] + (True,)),
            ("qmr bf16 diagonals", cf.qmr_dia_fused, two16[:5] + two16[6:]),
            ("bilqr bf16 diagonals", cf.bilqr_dia_fused, two16 + (True,)),
            ("dqgmres", cf.trunc_dia_fused,
             (pd32, ot32, b32) + tol32 + ("dqgmres",)),
            ("diom", cf.trunc_dia_fused,
             (pd32, ot32, b32) + tol32 + ("diom",)),
            ("gmres", cf.gmres_dia_fused, arnoldi + (20,)),
            ("gmres bf16 panel", cf.gmres_dia_fused,
             arnoldi + (20, torch.bfloat16)),
            ("gmres memory 512", cf.gmres_dia_fused, arnoldi + (512,)),
            ("fom", cf.fom_dia_fused, arnoldi + (20,)),
            ("trilqr", cf.trilqr_dia_fused, ssy + (True,)),
            ("usymlqr", cf.usymlqr_dia_fused, ssy),
            ("usymlq", cf.usymlq_dia_fused, ssy + (True,)),
            ("usymqr", cf.usymqr_dia_fused, ssy),
            ("tricg", cf.tricg_dia_fused, poisson + tricg_rhs + tri),
            ("trimr", cf.trimr_dia_fused, poisson + trimr_rhs + tri)):
        res = kernel(*args)
        i_niter, i_status = where.get(name.split()[0], (1, 3))
        niter = int(res[i_niter])
        digest = hashlib.sha256(b"".join(
            v.cpu().numpy().tobytes() for v in res[:i_niter])).hexdigest()
        ms = event_ms(lambda: kernel(*args), reps=3, warmup=1)
        prof = solve_profile(lambda: (None, kernel(*args)))
        row = dict(ms=ms, niter=niter, status=int(res[i_status]),
                   us_per_iter=1e3 * ms / max(niter, 1), digest=digest[:16])
        if prof is not None:
            _, wall_us, busy_us, rows = prof
            launched = max(count for _, count, _ in rows)
            row.update(busy_share=busy_us / wall_us, device_us=busy_us,
                       launched_iters=launched,
                       device_us_per_launched_iter=busy_us / launched,
                       kernels={key[:80]: [dev_us, count]
                                for dev_us, count, key in rows[:8]})
        out[name] = row
        del res
    print(json.dumps(out), flush=True)


def two_sided_in_own_process(root):
    """``two_sided_main``'s line for ROOT, from a process of its own; {}
    where that process fails (its error printed)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--two-sided", str(root)], capture_output=True,
                         text=True, timeout=600)
    lines = run.stdout.strip().splitlines()
    if run.returncode != 0 or not lines:
        print(f"  --two-sided failed ({run.returncode}): "
              f"{run.stderr[-2000:]}", file=sys.stderr, flush=True)
        return {}
    return json.loads(lines[-1])


def compare_main(root):
    """``python3 chip_smoke.py --compare ROOT``: the SpMV layer and the
    two-sided whole-solve kernels of the krylov_tpu_torch in checkout
    ROOT (this one, or another commit's package unpacked beside it, to
    compare the two in one run on one card) on the main path's inputs,
    as one JSON line: CUDA-event ms,
    profiled device ms and host us per call of the DIA SpMV at 128^3 f32
    and 64^3 f64 (the public wrapper and DIAOperator.matvec), of the SPD
    FEM band's SELL remainder product and its hybrid product (n = 2^17
    f32), the median ms of three cg(csr, b) solves and three
    CSROperator solves, and the BELL SpMV and SpMM (p = 1, 4, 8) on the
    block-tridiagonal BELL of phase 3l at 1024 and 96 block rows, f32 and
    f64: the public wrapper's and BELLOperator's ms, the latter's device
    ms and host us, the public wrapper's host us, the library's BSR
    product's ms and the byte bound, and the kernel's largest difference
    from the BSR product relative to max |y|; and, under "two-sided",
    ``two_sided_main``'s line: BiLQ, QMR and BiLQR at 128^3 f64, f32 and
    on bf16 diagonals, DQGMRES
    and DIOM at 128^3 f32, memory 20, GMRES (memory 20, a bf16 panel,
    memory 512) and FOM (memory 20), TriLQR, USYMLQR, USYMLQ, USYMQR,
    TriCG and TriMR at 128^3 f32."""
    root, kt = import_root(root)
    from krylov_tpu_torch import _build
    from krylov_tpu_torch.ops import cuda_sell as csell
    from krylov_tpu_torch.ops.cuda_dia import (dia_align, dia_spmv_aligned,
                                               offsets_tensor)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    gen = np.random.default_rng(SEED + 42)
    for N, dt in ((128, torch.float32), (64, torch.float64)):
        A = kt.poisson_dia(N, dtype=dt)
        pd = dia_align(A.data, A.offsets, A.shape[0])
        ot = offsets_tensor(A.offsets, "cuda")
        x = torch.as_tensor(gen.standard_normal(A.shape[0])).to("cuda", dt)
        op = kt.DIAOperator(A)
        out[f"dia_spmv {N}^3"] = dict(
            ms=event_ms(lambda: dia_spmv_aligned(pd, ot, x), reps=50),
            host_us=host_us(lambda: dia_spmv_aligned(pd, ot, x)),
            matvec_ms=event_ms(lambda: op.matvec(x), reps=50),
            matvec_device_ms=device_ms(lambda: op.matvec(x)),
            matvec_host_us=host_us(lambda: op.matvec(x)))
        del A, pd, ot, x, op
    nf = 1 << 17
    sr, sc, sv = dominant(*fem_band(nf), nf, True)
    fem_spd = kt.csr_from_coo(sr, sc, sv.astype(np.float32), (nf, nf))
    op = kt.as_operator(fem_spd)
    S = op.hyb.sell
    x = torch.as_tensor(gen.standard_normal(nf)).to("cuda", torch.float32)
    rem = (lambda: csell.sell_bucketed_spmv(S, x)) if isinstance(
        S, kt.SELLBucketed) else (lambda: kt.sell_spmv(S, x))
    out["sell remainder"] = dict(ms=event_ms(rem, reps=50),
                                 device_ms=device_ms(rem),
                                 host_us=host_us(rem))
    out["hybrid product"] = dict(
        ms=event_ms(lambda: op.matvec(x), reps=50),
        device_ms=device_ms(lambda: op.matvec(x)),
        host_us=host_us(lambda: op.matvec(x)))

    bw = hbm_rate(out["device"])
    for nb in (1024, 96):
        for dt in (torch.float32, torch.float64):
            A = bell_tridiagonal(kt, nb, dt, SEED + 31)
            op, bsr = kt.BELLOperator(A), bsr_of(A)
            for p in (1, 4, 8):
                X = torch.as_tensor(gen.standard_normal(
                    (A.shape[1], p) if p > 1 else A.shape[1])).to("cuda", dt)
                X2 = X if p > 1 else X[:, None]
                pub = (lambda: kt.bell_spmv(A, X)) if p == 1 \
                    else (lambda: kt.bell_spmm(A, X))
                bound = (lambda: op.matvec(X)) if p == 1 \
                    else (lambda: op.matmat(X))
                ref = (bsr @ X2).reshape(pub().shape)
                out[f"bell p={p} nb={nb} {str(dt)[6:]}"] = dict(
                    rel_err=float((pub() - ref).abs().max()
                                  / ref.abs().max()),
                    ms=event_ms(pub, reps=50),
                    matvec_ms=event_ms(bound, reps=50),
                    matvec_device_ms=device_ms(bound),
                    matvec_host_us=host_us(bound), host_us=host_us(pub),
                    library_ms=event_ms(lambda: bsr @ X2, reps=50),
                    bound_ms=bell_bound_ms(A, X, bw))
            del A, op, bsr

    def solve_ms(fn):
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, st = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times[1:]), st.niter

    ms, it = solve_ms(lambda: kt.cg(fem_spd, x))
    ms_c, it_c = solve_ms(lambda: kt.cg(kt.CSROperator(fem_spd), x))
    out["cg(csr, b)"] = dict(ms=ms, niter=it, csroperator_ms=ms_c,
                             csroperator_niter=it_c)
    out["two-sided"] = two_sided_in_own_process(root)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        compare_main(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--two-sided":
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        two_sided_main(sys.argv[2])
    elif sys.argv[1:] == ["--bell-device"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device")
        bell_device_main()
    else:
        main()
