"""The port as a package: what it imports, where it puts data, how its
kernels are built and bound, and the tests that need the card.

This file imports no JAX at module level, so the card tests run on a
machine with PyTorch for CUDA and no JAX:
``python -m pytest --noconftest tests/test_torch_port.py``.  The checks
against the JAX package import it inside the test and skip where it is
missing.  Tolerances are stated at each comparison.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import krylov_tpu_torch as kt
from krylov_tpu_torch import _build
from krylov_tpu_torch import _runtime as rt
from krylov_tpu_torch.convert import dia_from_numpy
from krylov_tpu_torch.ops.cuda_dia import (dia_align, dia_spmv_aligned,
                                           dia_spmv_aligned_ref,
                                           offsets_tensor)
from krylov_tpu_torch.ops import cuda_fused as cf
from krylov_tpu_torch.ops import cuda_spmv as cspmv
from krylov_tpu_torch.ops.cuda_fused import cg_dia_fused, cg_dia_fused_ref

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "krylov_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"):
            yield "__import__"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "krylov_tpu", "__import__"), \
            f"{path.name} imports {mod}"


@pytest.mark.parametrize("make", [
    lambda: kt.poisson_dia(4),
    lambda: kt.convdiff_dia(4),
    lambda: kt.DIAMatrix(np.zeros((1, 4)), (0,), (4, 4)),
    lambda: dia_from_numpy(np.zeros((1, 4)), (0,), (4, 4)),
    lambda: kt.dia_from_scipy(np.eye(4)),
])
def test_constructors_default_to_card_and_raise_without_one(make,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


SOLVERS = ("cg", "cr", "car", "minres", "cg_lanczos", "symmlq",
           "minres_qlp", "minares", "gmres", "fgmres", "fom", "bicgstab",
           "cgs", "diom", "dqgmres", "bilq", "qmr")


@pytest.mark.parametrize("solver", SOLVERS)
def test_numpy_inputs_go_to_card_and_raise_without_one(solver, monkeypatch):
    """An entry point puts inputs that are not tensors on the card: a
    numpy system, or a numpy b beside an operator that holds no tensor,
    raises on a machine without one instead of solving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solve = getattr(kt, solver)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(2.0 * np.eye(4), np.ones(4))
    op = kt.FunctionOperator(lambda v: 2.0 * v, (4, 4), torch.float64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(op, np.ones(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.as_operator(np.eye(4))


@pytest.mark.parametrize("make", [
    lambda **kw: kt.DiagonalOperator(np.full(4, 2.0), **kw),
    lambda **kw: kt.MatrixOperator(2.0 * np.eye(4), **kw),
], ids=["DiagonalOperator", "MatrixOperator"])
def test_numpy_operator_data_goes_to_card(make, monkeypatch):
    """Numpy data in DiagonalOperator and MatrixOperator goes to the card
    by default and raises without one; ``device="cpu"`` keeps it on the
    CPU, and a tensor stays where it is."""
    op = make(device="cpu")
    assert op.device.type == "cpu"
    x, st = kt.cg(op, torch.ones(4, dtype=torch.float64))
    assert x.device.type == "cpu" and st.solved
    kept = type(op)(getattr(op, "d", getattr(op, "A", None)))
    assert kept.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kt.cg(kt.MatrixOperator(2.0 * np.eye(4)), np.ones(4))


@pytest.mark.parametrize("solver", SOLVERS)
def test_numpy_rhs_follows_a_cpu_operator(solver):
    """A numpy b (and x0) next to an operator on the CPU stays on the
    CPU, and a tensor b stays where it is."""
    solve = getattr(kt, solver)
    A = kt.poisson_dia(4, dtype=torch.float64, device="cpu")
    for Aop in (A, kt.DIAOperator(A, use_kernel=True),
                torch.as_tensor(kt.DIAOperator(A).dia.todense())):
        x, st = solve(Aop, np.ones(64), np.zeros(64))
        assert x.device.type == "cpu" and st.solved
    x, st = solve(kt.as_operator(2.0 * np.eye(4), device="cpu"),
                  torch.ones(4, dtype=torch.float64))
    assert x.device.type == "cpu" and st.solved


def test_constructors_on_cpu():
    A = kt.poisson_dia(3, 4, 5, dtype=torch.bfloat16, device="cpu")
    assert A.data.dtype == torch.bfloat16 and A.data.device.type == "cpu"
    assert A.shape == (60, 60) and A.offsets == (-12, -3, -1, 0, 1, 3, 12)
    op = kt.as_operator(A)
    assert isinstance(op, kt.DIAOperator) and not op.use_kernel
    with pytest.raises(ValueError):
        kt.DIAMatrix(np.zeros((2, 4)), (0,), (4, 4), device="cpu")


def test_sources_define_every_bound_entry_point():
    text = "".join(p.read_text() for p in
                   (ROOT / "krylov_tpu_torch" / "csrc").glob("*.cu"))
    defined = set(re.findall(r"\b(ktt_\w+)\b", text))
    for name in _build._SIGNATURES:
        assert name in defined
    assert "ktt_error_string" in defined
    # one nvcc, sm_90a, plain C interface: no PyTorch header, no grid sync
    assert "torch/extension.h" not in text
    assert "grid.sync" not in text and "cudaLaunchCooperativeKernel" \
        not in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _enum(source, name):
    """The members of ``enum name { ... }`` in a csrc file, in order."""
    text = (ROOT / "krylov_tpu_torch" / "csrc" / source).read_text()
    body = re.search(r"enum " + name + r" \{([^}]*)\}", text).group(1)
    return [m.split("=")[0].strip() for m in body.split(",")]


@pytest.mark.parametrize("source,slots", [
    ("minres_qlp_dia.cu", {"ScalarSlot": {"RNORM": cf._QLP_RNORM,
                                          "ARNORM": cf._QLP_ARNORM,
                                          "NSC": cf._QLP_NSC},
                           "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                       "INCON": cf._QLP_INCON,
                                       "NST": cf._QLP_NST}}),
    ("minares_dia.cu", {"ScalarSlot": {"RNORM": cf._MNA_RNORM,
                                       "ARNORM": cf._MNA_ARNORM,
                                       "NSC": cf._MNA_NSC},
                        "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                    "NST": cf._MNA_NST}}),
])
def test_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the wrappers read and the array sizes they allocate are
    the kernels' enum values; the host sets ATOL, RTOL, ARTOL, LAM and
    BTOL in that order."""
    for enum, want in slots.items():
        members = _enum(source, enum)
        for name, slot in want.items():
            assert members.index(name) == slot, (source, name)
    assert _enum(source, "ScalarSlot")[:5] == ["ATOL", "RTOL", "ARTOL",
                                               "LAM", "BTOL"]


@pytest.mark.parametrize("source,slots", [
    ("arnoldi.cuh", {"ScalarSlot": {"ATOL": 0, "RTOL": 1, "BTOL": 2,
                                    "RNORM": cf._AR_RNORM,
                                    "NSC": cf._AR_NSC},
                     "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                 "INCONS": cf._AR_INCONS,
                                 "NPASS": cf._AR_NPASS, "NST": cf._AR_NST}}),
    ("bicgstab_dia.cu", {"ScalarSlot": {"ATOL": 0, "RTOL": 1,
                                        "RNORM": cf._BS_RNORM,
                                        "NSC": cf._BS_NSC},
                         "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                     "NST": cf._BS_NST},
                         "Part": {"NPART": cf._BS_NPART}}),
    ("cgs_dia.cu", {"ScalarSlot": {"ATOL": 0, "RTOL": 1,
                                   "RNORM": cf._CGS_RNORM,
                                   "NSC": cf._CGS_NSC},
                    "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                "NST": cf._CGS_NST},
                    "Part": {"NPART": cf._CGS_NPART}}),
])
def test_nonsymmetric_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the GMRES, FOM, BiCGSTAB and CGS wrappers set and read
    and the array sizes they allocate are the kernels' enum values."""
    for enum, want in slots.items():
        members = _enum(source, enum)
        for name, slot in want.items():
            assert members.index(name) == slot, (source, name)


@pytest.mark.parametrize("mem,grid", [(1, 1), (20, 528), (512, 528),
                                      (900, 33)])
def test_arnoldi_wrapper_layout_matches_kernel(mem, grid):
    """The GMRES and FOM wrapper's scratch array (``_ar_layout``) is
    arnoldi.cuh's ``struct Layout``: the partial rows of the dots cⱼ and
    of the Gram row (mem each), the ‖w‖² row, then the Gram rows (mem ×
    mem); and the wrapper's grid is the wide rows' (four blocks per SM)."""
    got = _layout_offsets("arnoldi.cuh", mem=mem, grid=grid)
    assert got["g_row"] == mem * grid
    assert (got["ww_row"], got["gram"], got["size"]) == \
        cf._ar_layout(mem, grid)
    assert cf._WIDE_BLOCKS_PER_SM == 4
    text = (ROOT / "krylov_tpu_torch" / "csrc" / "arnoldi.cuh").read_text()
    assert "constexpr int kThreads = 256;" in text
    assert cf._THREADS == 256


@pytest.mark.parametrize("source,slots", [
    ("trunc_dia.cu", {"ScalarSlot": {"ATOL": 0, "RTOL": 1,
                                     "RNORM": cf._TR_RNORM,
                                     "NSC": cf._TR_NSC},
                      "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                  "NST": cf._TR_NST}}),
    ("bilq_dia.cu", {"ScalarSlot": {"RNORM": cf._BQ_RNORM,
                                    "NSC": cf._BQ_NSC},
                     "IntSlot": {"NST": cf._BQ_NST},
                     "OwnRow": {"X": cf._BI_X}}),
    ("qmr_dia.cu", {"ScalarSlot": {"RNORM": cf._QM_RNORM,
                                   "NSC": cf._QM_NSC},
                    "IntSlot": {"NST": cf._QM_NST},
                    "OwnRow": {"X": cf._BI_X}}),
    ("bilqr_dia.cu", {"ScalarSlot": {"RNORM": cf._BR_RNORM,
                                     "SNORM": cf._BR_RNORM + 1,
                                     "NSC": cf._BR_NSC},
                      "IntSlot": {"NST": cf._BR_NST,
                                  **dict(zip(("LQ_T", "LQ_M", "CG_T", "CG_M",
                                              "QR_T", "QR_M", "SP", "SD",
                                              "BRK"), cf._BR_FLAGS))},
                      "OwnRow": {"X": cf._BI_X, "Y": cf._BI_X + 1}}),
])
def test_slice6_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the truncated and two-sided wrappers set and read and the
    array sizes they allocate are the kernels' enum values.  The two-sided
    kernels' enums continue those of csrc/bilanczos.cuh (ATOL .. ALPHA,
    IT .. GO, the six rows of v and u), and the shared header's partial
    rows are the wrapper's count."""
    for enum, want in slots.items():
        if source == "trunc_dia.cu":
            members = _enum(source, enum)
            got = {name: members.index(name) for name in want}
        else:
            got = _enum_values(source, enum, header="bilanczos.cuh")
        for name, slot in want.items():
            assert got[name] == slot, (source, name)
    shared = {e: _enum_values(None, e, header="bilanczos.cuh")
              for e in ("SharedSlot", "SharedInt")}
    if source != "trunc_dia.cu":
        for enum, start in zip(("ScalarSlot", "IntSlot"),
                               (len(shared["SharedSlot"]),
                                len(shared["SharedInt"]))):
            assert min(_enum_values(source, enum,
                                    header="bilanczos.cuh").values()) == start
    assert _enum("bilanczos.cuh", "Part")[-1] == "NPART"
    assert len(_enum("bilanczos.cuh", "Part")) - 1 == cf._BI_NPART
    assert _enum("bilanczos.cuh", "SharedSlot")[:2] == ["ATOL", "RTOL"]


def _enum_values(source, name, header="ssy.cuh"):
    """name -> value of ``enum name { ... }`` in a csrc file (the header
    itself where source is None), where each member is the last plus one
    or an expression of earlier members and of the shared enums of its
    header (the SSY header by default), each of which may use those
    before it."""
    env = {}
    text = (ROOT / "krylov_tpu_torch" / "csrc" / header).read_text()
    for enum in ("SharedSlot", "SharedInt", "Row", "Part", "FusedSlot",
                 "FusedInt"):
        if f"enum {enum} {{" in text:
            env.update(_enum_values_in(header, enum, env))
    return _enum_values_in(source or header, name, env)


def _enum_values_in(source, name, env):
    text = (ROOT / "krylov_tpu_torch" / "csrc" / source).read_text()
    body = re.search(r"enum " + name + r" \{([^}]*)\}", text).group(1)
    out, value = {}, -1
    for member in body.split(","):
        key, _, expr = member.partition("=")
        value = eval(expr, {}, {**env, **out}) if expr.strip() else value + 1
        out[key.strip()] = value
    return out


@pytest.mark.parametrize("source,slots", [
    ("usymlq_dia.cu", {"ScalarSlot": {"RNORM": cf._UL_RNORM,
                                      "NSC": cf._UL_NSC},
                       "IntSlot": {"NST": cf._UL_NST},
                       "OwnRow": {"X": cf._SSY_X, "NROWS": 8}}),
    ("usymqr_dia.cu", {"ScalarSlot": {"RNORM": cf._UQ_RNORM,
                                      "ARNORM": cf._UQ_ARNORM,
                                      "NSC": cf._UQ_NSC},
                       "IntSlot": {"INCON": cf._UQ_INCON, "NST": cf._UQ_NST},
                       "OwnRow": {"X": cf._SSY_X, "NROWS": 9}}),
    ("trilqr_dia.cu", {"ScalarSlot": {"RNORM": cf._TL_RNORM,
                                      "SNORM": cf._TL_RNORM + 1,
                                      "NSC": cf._TL_NSC},
                       "IntSlot": {"NST": cf._TL_NST,
                                   **dict(zip(("LQ_T", "LQ_M", "CG_T", "CG_M",
                                               "QR_T", "QR_M", "SP", "SD",
                                               "INCD"), cf._TL_FLAGS))},
                       "OwnRow": {"X": cf._SSY_X, "Y": cf._SSY_X + 1,
                                  "NROWS": 11}}),
    ("usymlqr_dia.cu", {"ScalarSlot": {"RNORM_LS": cf._ULR_RNORM,
                                       "RNORM_LN": cf._ULR_RNORM + 1,
                                       "NSC": cf._ULR_NSC},
                        "IntSlot": {"INCON": cf._ULR_INCON,
                                    "NST": cf._ULR_NST},
                        "OwnRow": {"X": cf._SSY_X, "Y": cf._SSY_X + 1,
                                   "NROWS": 13}}),
    ("tricg_dia.cu", {"ScalarSlot": {"RNORM": cf._TCG_RNORM,
                                     "TAU": cf._TCG_TAU,
                                     "NU": cf._TCG_TAU + 1,
                                     "NSC": cf._TCG_NSC},
                      "IntSlot": {"NST": cf._TCG_NST},
                      "OwnRow": {"X": cf._SSY_X, "Y": cf._SSY_X + 1,
                                 "NROWS": cf._TCG_NROWS}}),
    ("trimr_dia.cu", {"ScalarSlot": {"RNORM": cf._TMR_RNORM,
                                     "TAU": cf._TMR_TAU,
                                     "NU": cf._TMR_TAU + 1,
                                     "NSC": cf._TMR_NSC},
                      "IntSlot": {"NST": cf._TMR_NST},
                      "OwnRow": {"X": cf._SSY_X, "Y": cf._SSY_X + 1,
                                 "NROWS": cf._TMR_NROWS}}),
])
def test_ssy_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the SSY wrappers read, the array sizes they allocate (a
    state and its staging copy) and the work rows are the kernels' enum
    values; the host sets ATOL and RTOL in slots 0 and 1, status is int
    slot 1, and the shared header's partial rows are the wrapper's
    count."""
    for enum, want in slots.items():
        got = _enum_values(source, enum)
        for name, slot in want.items():
            assert got[name] == slot, (source, name)
    shared = _enum_values_in("ssy.cuh", "SharedSlot", {})
    assert (shared["ATOL"], shared["RTOL"]) == (0, 1)
    ints = _enum_values_in("ssy.cuh", "SharedInt", {})
    assert (ints["IT"], ints["STATUS"]) == (cf._IT, cf._STATUS)
    assert _enum_values_in("ssy.cuh", "Part", {})["NPART"] == cf._SSY_NPART


_CTYPES = {"const void*": _build._P, "void*": _build._P, "int": _build._I,
           "long long": _build._L}


@pytest.mark.parametrize("kind", _build._SSY)
def test_ssy_iterate_arguments_match_signature(kind):
    """Each SSY kernel's iterate entry point, as ``ssy.cuh``'s
    KTT_SSY_ITERATE defines it, takes the arguments ``_build`` binds, in
    order (the interiors of A and Aᴴ after their diagonals): a pointer
    bound as an int would be cut to 32 bits."""
    text = (ROOT / "krylov_tpu_torch" / "csrc" / "ssy.cuh").read_text()
    macro = re.search(r"#define KTT_SSY_ITERATE\(NAME, T, P, METHOD\)"
                      r"(.*?)\{", text, re.S).group(1).replace("\\", " ")
    params = re.search(r"NAME\((.*)\)", macro, re.S).group(1).split(",")
    got = tuple(_CTYPES[" ".join(q.split()[:-1])] for q in params)
    for pair in _build._PAIRS:
        assert _build._SIGNATURES[f"ktt_{kind}_dia_iterate_{pair}"] == got
    names = [q.split()[-1] for q in params]
    assert names[6:10] == ["lo", "hi", "lo_a", "hi_a"]
    src = (ROOT / "krylov_tpu_torch" / "csrc" / f"{kind}_dia.cu").read_text()
    assert f"KTT_SSY_ITERATE(ktt_{kind}_dia_iterate_f32_f32" in src


@pytest.mark.parametrize("source,slots", [
    ("lsqr_dia.cu", {"ScalarSlot": {"RNORM": cf._LQ_RNORM,
                                    "ARNORM": cf._LQ_ARNORM,
                                    "NSC": cf._LQ_NSC},
                     "IntSlot": {"NST": cf._LQ_NST},
                     "OwnRow": {"NROWS": 4}}),
    ("lsmr_dia.cu", {"ScalarSlot": dict(zip(("RNORM", "ARNORM", "ACOND",
                                             "ANORM", "XNORM"),
                                            cf._LM_NORMS),
                                        NSC=cf._LM_NSC),
                     "IntSlot": {"NST": cf._LM_NST},
                     "OwnRow": {"NROWS": 5}}),
    ("lslq_dia.cu", {"ScalarSlot": {"RNORM": cf._LL_RNORM,
                                    "ARNORM": cf._LL_ARNORM,
                                    "NSC": cf._LL_NSC},
                     "IntSlot": {"CBND": cf._LL_CBND, "NST": cf._LL_NST},
                     "OwnRow": {"NROWS": 4}}),
])
def test_gk_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the Golub–Kahan wrappers read, the array sizes they
    allocate (a state and its staging copy, the error window after them)
    and the work rows are the kernels' enum values; the host's parameters
    come first in the order the wrappers pass them, and the shared
    header's rows and partials are the wrappers' counts."""
    for enum, want in slots.items():
        got = _enum_values(source, enum, "gk.cuh")
        for name, slot in want.items():
            assert got[name] == slot, (source, name)
    assert _enum("gk.cuh", "SharedSlot") == [
        "LAM", "AXTOL", "BTOL", "ATOL", "RTOL", "ETOL", "CONLIM", "SIGMA",
        "UTOL", "ALPHA"]
    ints = _enum_values_in("gk.cuh", "SharedInt", {})
    assert (ints["IT"], ints["STATUS"], ints["ZR"]) == (cf._IT, cf._STATUS,
                                                        cf._GK_ZR)
    assert _enum_values_in("gk.cuh", "Row", {})["X"] == cf._GK_X
    assert _enum_values_in("gk.cuh", "Part", {})["NPART"] == cf._GK_NPART


@pytest.mark.parametrize("source,slots", [
    ("cgls_dia.cu", {"ScalarSlot": {"LAM": 0, "ATOL": 1, "RTOL": 2,
                                    "RNORM": cf._NQ_RNORM,
                                    "ARNORM": cf._NQ_ARNORM,
                                    "NSC": cf._NQ_NSC},
                     "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                 "NST": cf._NQ_NST},
                     "Row": {"ROW_X": 0, "NROWS": cf._GLS_NROWS},
                     "Part": {"NPART": cf._GLS_NPART}}),
    ("crls_dia.cu", {"ScalarSlot": {"LAM": 0, "ATOL": 1, "RTOL": 2,
                                    "RNORM": cf._NQ_RNORM,
                                    "ARNORM": cf._NQ_ARNORM,
                                    "NSC": cf._NQ_NSC},
                     "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS,
                                 "NST": cf._NQ_NST},
                     "Row": {"ROW_X": 0, "NROWS": cf._RLS_NROWS},
                     "Part": {"NPART": cf._RLS_NPART}}),
    ("cgls_lanczos_shift_dia.cu", {
        "ScalarSlot": {"ATOL": 0, "RTOL": 1, "NSC": cf._LZS_NSC},
        "Shift": {"RNORM": cf._LZS_RNORM, "NSHIFT_BLOCKS": cf._LZS_NBLK},
        "IntSlot": {"IT": cf._IT, "STATUS": cf._STATUS, "NST": cf._LZS_NST},
        "ShiftFlag": {"INDEF": cf._LZS_INDEF, "NFLAG_BLOCKS": 3},
        "Part": {"NPART": cf._LZS_NPART}}),
])
def test_normal_equation_wrapper_slots_match_kernel_enums(source, slots):
    """The slots the CGLS, CRLS and CGLS-Lanczos-shift wrappers set and
    read and the array sizes they allocate are the kernels' enum
    values; the shift kernel's X starts at work row ``_LZS_X``."""
    for enum, want in slots.items():
        members = _enum(source, enum)
        for name, slot in want.items():
            assert members.index(name) == slot, (source, name)
    text = (ROOT / "krylov_tpu_torch" / "csrc" /
            "cgls_lanczos_shift_dia.cu").read_text()
    assert f"constexpr int VX = {cf._LZS_X};" in text


def _layout_offsets(source, **dims):
    """name -> value of each one-line method of ``struct Layout`` in a
    csrc file, evaluated with the file's enums and ``dims`` (mem or p),
    the methods calling each other as names."""
    text = (ROOT / "krylov_tpu_torch" / "csrc" / source).read_text()
    env = dict(dims)
    for enum in ("ScalarSlot", "IntSlot"):
        env.update(_enum_values_in(source, enum, {}))
    body = re.search(r"struct Layout \{(.*?)\n\};", text, re.S).group(1)
    for name, expr in re.findall(
            r"(?:int|long long) (\w+)\(\) const \{\s*return ([^;]+);",
            body):
        expr = re.sub(r"static_cast<long long>\((\w+\(\))\)", r"\1", expr)
        env[name] = eval(re.sub(r"(\w+)\(\)", r"\1", expr), {}, env)
    return env


@pytest.mark.parametrize("mem", [2, 48, 64])
def test_gpmr_wrapper_layout_matches_kernel(mem):
    """The GPMR wrapper's slots and array sizes (``_gp_layout``) are the
    kernel's enums and ``struct Layout``: the fixed scalars, the staging
    copy at the end of the scalars, the rows of x and y, the partial rows
    and the largest mem."""
    got = _layout_offsets("gpmr_dia.cu", mem=mem)
    nsc, nrows, npart = cf._gp_layout(mem)
    assert (got["RNORM"], got["H"], got["INCON"], got["NST"]) == (
        cf._GP_RNORM, cf._GP_H, cf._GP_INCON, cf._GP_NST)
    assert (got["ATOL"], got["RTOL"], got["LAM"], got["MU"]) == (0, 1, 2, 3)
    assert (got["IT"], got["STATUS"]) == (cf._IT, cf._STATUS)
    assert got["s_cols"] + 2 * got["col"] == nsc
    assert (got["x"], got["y"]) == (2 * mem + 4, 2 * mem + 5)
    assert got["y"] + 1 == nrows and got["ppp"] + 1 == npart
    text = (ROOT / "krylov_tpu_torch" / "csrc" / "gpmr_dia.cu").read_text()
    assert f"kMaxMem = {cf._GP_MAXMEM};" in text


@pytest.mark.parametrize("p", [1, 4, 8])
def test_block_minres_wrapper_layout_matches_kernel(p):
    """The block MINRES wrapper's slots and sizes (``_bm_layout``) are the
    kernel's enums and ``struct Layout``; the largest p is the header's."""
    # ntri as csrc/block.cuh has it
    got = _layout_offsets("block_minres.cuh", p=p,
                          ntri=lambda k: k * (k + 1) // 2)
    nsc, nrows, npart = cf._bm_layout(p)
    assert (got["RNORM"], got["PSI"], got["NST"]) == (cf._BM_RNORM,
                                                      cf._BM_PSI, cf._BM_NST)
    assert (got["ATOL"], got["RTOL"], got["IT"], got["STATUS"]) == (
        0, 1, cf._IT, cf._STATUS)
    # the staging copy of RNORM .. state_end, then Ω and R₁
    om = got["state_end"] + got["state_end"] - got["RNORM"]
    assert om + 2 * p * p == nsc
    assert nrows == 6 * p and got["p_g2"] + p * (p + 1) // 2 == npart
    text = (ROOT / "krylov_tpu_torch" / "csrc" / "block.cuh").read_text()
    assert f"kMaxP = {cf._BM_MAXP};" in text


def test_matmat_takes_strided_columns():
    """A DIA operator on the SpMV kernel's route applies ``matmat`` to a
    row-major panel: its columns are strided, and the kernel takes only
    contiguous vectors (it raised before; the block MINRES general core
    and the warm start of its kernel route pass such panels)."""
    A = kt.DIAOperator(kt.poisson_dia(4, dtype=torch.float64, device="cpu"),
                       use_kernel=True)
    X = torch.as_tensor(np.random.default_rng(0).standard_normal((64, 3)))
    assert not X[:, 0].is_contiguous()
    Y = A.matmat(X)
    for j in range(3):
        assert torch.equal(Y[:, j], A.matvec(X[:, j].contiguous()))
    assert torch.equal(A.H.matmat(X), A.rmatmat(X))


def test_build_key_tracks_sources():
    assert _build._key() == _build._key()
    assert len(_build._key()) == 64
    assert _build.LIB_PATH.parent == ROOT / "build" / "krylov_tpu_torch"


def test_kernel_launches_and_exports():
    got = kt.kernel_launches()
    assert set(got) == {"dia_spmv", "dia_spmv_padded", "cg_dia",
                        "cg_cheby_dia", "cr_dia", "car_dia", "minres_dia",
                        "cg_lanczos_dia", "cg_lanczos_shift_dia",
                        "symmlq_dia", "minres_qlp_dia", "minares_dia",
                        "gmres_dia", "fom_dia", "bicgstab_dia", "cgs_dia",
                        "trunc_dia", "bilq_dia", "qmr_dia", "bilqr_dia",
                        "usymlq_dia", "usymqr_dia", "trilqr_dia",
                        "usymlqr_dia", "lsqr_dia", "lsmr_dia", "lslq_dia",
                        "craig_dia", "craigmr_dia", "lnlq_dia",
                        "cgne_crmr_dia", "cgls_dia", "crls_dia",
                        "cgls_lanczos_shift_dia", "tricg_dia", "trimr_dia",
                        "gpmr_dia", "block_minres_dia", "block_gmres_dia",
                        "bell_spmv", "bell_spmm", "sell_spmv"}
    assert got["dia_spmv"] == dia_spmv_aligned.launches
    assert got["dia_spmv_padded"] == kt.dia_spmv_padded.launches
    assert got["cg_dia"] == cg_dia_fused.launches
    for name in ("cg_cheby_dia", "cr_dia", "car_dia", "minres_dia",
                 "cg_lanczos_dia", "cg_lanczos_shift_dia", "symmlq_dia",
                 "minres_qlp_dia", "minares_dia", "gmres_dia", "fom_dia",
                 "bicgstab_dia", "cgs_dia", "trunc_dia", "bilq_dia",
                 "qmr_dia", "bilqr_dia", "usymlq_dia", "usymqr_dia",
                 "trilqr_dia", "usymlqr_dia", "lsqr_dia", "lsmr_dia",
                 "lslq_dia", "craig_dia", "craigmr_dia", "lnlq_dia",
                 "cgne_crmr_dia", "cgls_dia", "crls_dia",
                 "cgls_lanczos_shift_dia", "tricg_dia", "trimr_dia",
                 "gpmr_dia", "block_minres_dia", "block_gmres_dia"):
        assert got[name] == getattr(kt, name + "_fused").launches
    assert got["bell_spmv"] == kt.bell_spmv.launches
    assert got["bell_spmm"] == kt.bell_spmm.launches
    assert got["sell_spmv"] == kt.sell_spmv.launches
    for name in ("cg", "cr", "car", "minres", "cg_lanczos",
                 "cg_lanczos_shift", "symmlq", "minres_qlp", "minares",
                 "gmres", "fgmres", "fom", "bicgstab", "cgs", "diom",
                 "dqgmres", "bilq", "qmr", "bilqr", "usymlq", "usymqr",
                 "trilqr", "usymlqr", "lsqr", "lsmr", "lslq", "craig",
                 "craigmr", "lnlq", "cgne", "crmr", "cgls", "crls",
                 "cgls_lanczos_shift", "tricg", "trimr", "gpmr",
                 "block_minres", "block_gmres", "BELLOperator",
                 "HybridOperator", "HybridMatrix", "hybrid_from_csr",
                 "split_diagonals", "SELLMatrix", "SELLBucketed",
                 "sell_from_csr", "sell_bucketed_from_csr", "sell_spmv",
                 "hermitian_lanczos", "block_montoison_orban",
                 "TrimrWorkspace", "GpmrWorkspace",
                 "BlockMinresWorkspace", "CglsWorkspace",
                 "TricgWorkspace", "LNLQStats",
                 "AdjointStats", "LsmrStats", "LSLQStats", "kdot", "kdotr",
                 "kdotr2", "knorm", "roots_quadratic", "to_boundary",
                 "CgWorkspace", "UsymlqrWorkspace", "__version__",
                 "issolved_primal", "issolved_dual", "CSRMatrix",
                 "CSROperator", "AdjointOperator", "csr_from_coo",
                 "csr_from_dense", "spmv", "spmm", "knorm_elliptic",
                 "dia_align_adjoint",
                 "krylov_solve", "krylov_workspace", "krylov_solve_inplace",
                 "KRYLOV_METHODS", "show_stats", "show_workspace",
                 "kstdout", "KrylovConstructor", "KrylovWorkspace",
                 "BlockKrylovWorkspace", "METHOD_TABLE", "solution",
                 "statistics", "results", "issolved", "iteration_count",
                 "Aprod_count", "Atprod_count", "warm_start",
                 "elapsed_time", "sym_givens",
                 "dia_spmv_padded", "dia_pad_layout", "dia_unpad_layout",
                 "ChebyshevPreconditioner", "power_bound", "poisson_dia",
                 "convdiff_dia", "DIAMatrix", "DIAOperator",
                 "DiagonalOperator", "MatrixOperator", "FunctionOperator",
                 "IdentityOperator", "SimpleStats", "LanczosStats",
                 "LanczosShiftStats", "SymmlqStats"):
        assert hasattr(kt, name)


def test_drive_chunks_and_timemax():
    calls = []

    class S:
        status = torch.tensor(rt.RUNNING)

    def run(state, cap, steps):
        calls.append((cap, steps))
        return S()

    state, over = rt.drive(run, 150, float("inf"))
    assert calls == [(64, 64), (128, 64), (150, 22)] and not over
    calls.clear()
    state, over = rt.drive(run, 150, 0.0, start_time=0.0)
    assert calls == [(64, 64)] and over
    assert rt.final_status_code(rt.RUNNING, 3, 3, False) == rt.TIRED
    assert rt.final_status_code(rt.RUNNING, 3, 9, True) == rt.OVERTIMED


def test_full_fp32_restores_flags():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with rt.full_fp32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_foundation_matches_jax_package():
    """Status codes, strings, tolerances and the stats repr equal the JAX
    package's (exact: these are constants and host-side values)."""
    kj_rt = pytest.importorskip("krylov_tpu._runtime")
    kj_stats = pytest.importorskip("krylov_tpu.stats")
    kj_dt = pytest.importorskip("krylov_tpu._dtypes")
    import jax.numpy as jnp
    codes = {k: v for k, v in vars(kj_rt).items()
             if k.isupper() and isinstance(v, int)}
    for name, code in codes.items():
        assert getattr(rt, name) == code
        assert rt.decode_status(code) == kj_rt.decode_status(code)
        assert rt.is_solved_code(code) == kj_rt.is_solved_code(code)
    assert rt.BASE_STATUS == kj_rt.BASE_STATUS
    for td, jd in ((torch.float32, jnp.float32), (torch.float64, jnp.float64),
                   (torch.complex64, jnp.complex64)):
        assert rt.default_tol(None, td) == kj_rt.default_tol(None, jd)
        assert kt._dtypes.sqrt_eps(td) == kj_dt.sqrt_eps(jd)
    assert rt.resolve_itmax(0, 8) == kj_rt.resolve_itmax(0, 8) == 8
    kw = dict(niter=3, timer=0.5, status="x", solved=True, npc_count=2,
              residuals=np.arange(3.0))
    assert repr(kt.SimpleStats(**kw)) == repr(kj_stats.SimpleStats(**kw))
    assert kt.SimpleStats().npcCount == 0
    kw = dict(niter=3, timer=0.5, status="x", solved=True, Anorm=2.0)
    for name in ("LanczosStats", "LanczosShiftStats", "SymmlqStats"):
        assert repr(getattr(kt, name)(**kw)) == \
            repr(getattr(kj_stats, name)(**kw))


def test_kops_match_jax_package():
    """Dot2 and the trust-region step against the JAX k-ops: Dot2 to
    1e-12 relative in f32 (both recover a double-length sum), the
    boundary roots to 1e-12 relative in f64."""
    kops = pytest.importorskip("krylov_tpu.ops.kops")
    import jax.numpy as jnp
    from krylov_tpu_torch.ops import kops as tk
    rng = np.random.default_rng(21)
    x = rng.standard_normal(1001).astype(np.float32)
    y = rng.standard_normal(1001).astype(np.float32)
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    got = float(tk.kdotr2(torch.as_tensor(x), torch.as_tensor(y)))
    want = float(kops.kdotr2(jnp.asarray(x), jnp.asarray(y)))
    assert abs(got - want) <= 1e-6 * abs(exact)
    assert abs(got - exact) <= 1e-6 * abs(exact)
    for radius in (0.5, 2.0, 10.0):
        xv, dv = 0.01 * rng.standard_normal(50), rng.standard_normal(50)
        t = tk.to_boundary(torch.as_tensor(xv), torch.as_tensor(dv),
                           torch.tensor(radius, dtype=torch.float64))
        j = kops.to_boundary(jnp.asarray(xv), jnp.asarray(dv), radius)
        np.testing.assert_allclose([float(v) for v in t],
                                   [float(v) for v in j], rtol=1e-12)
    for q in ((0.0, 2.0, -4.0), (1.0, -3.0, 2.0), (1e-20, 1.0, 1.0),
              (0.0, 0.0, 0.0)):
        t = tk.roots_quadratic(*(torch.tensor(v, dtype=torch.float64)
                                 for v in q))
        j = kops.roots_quadratic(*(jnp.asarray(v, jnp.float64) for v in q))
        np.testing.assert_allclose([float(v) for v in t],
                                   [float(v) for v in j], rtol=1e-12)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _rel(a, b):
    dt = torch.complex128 if a.is_complex() or b.is_complex() \
        else torch.float64
    a = a.to(dt).cpu()
    b = b.to(dt).cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


# every (x, diagonal) pair of the SpMV kernels, and the tolerance of the
# kernel against its plain version relative to max|y|: the kernel fuses
# each multiply-add, so they differ by a few ulps of max|y| of the
# accumulator, and by one ulp of the narrow type for bf16 and f16 x
SPMV_PAIRS = [
    (torch.float32, torch.float32, 1e-6),
    (torch.float32, torch.bfloat16, 1e-6),
    (torch.float32, torch.float16, 1e-6),
    (torch.float64, torch.float64, 1e-14),
    (torch.float64, torch.float32, 1e-14),
    (torch.bfloat16, torch.bfloat16, 1e-2),
    (torch.float16, torch.float16, 1e-3),
    (torch.complex64, torch.float32, 1e-6),
    (torch.complex64, torch.complex64, 1e-6),
    (torch.complex128, torch.float64, 1e-14),
    (torch.complex128, torch.complex128, 1e-14),
]


def _spmv_operands(xdt, pdt, seed=8):
    rng = np.random.default_rng(seed)
    n, offs = 1080, (-300, -129, -1, 0, 5, 131, 257)
    data = torch.as_tensor(rng.standard_normal((len(offs), n)))
    x = torch.as_tensor(rng.standard_normal(n))
    if pdt.is_complex:
        data = data * (1.0 + 0.5j)
    if xdt.is_complex:
        x = x * (0.5 - 1.0j)
    pd = dia_align(data, offs, n).to("cuda", pdt)
    return pd, offsets_tensor(offs, "cuda"), x.to("cuda", xdt), offs


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,pdt,tol", SPMV_PAIRS,
                         ids=[f"{x}-{p}".replace("torch.", "")
                              for x, p, _ in SPMV_PAIRS])
def test_spmv_kernel_matches_plain_on_card(xdt, pdt, tol):
    """The aligned and the padded kernel against their plain versions on
    the same inputs; the padded one chained twice with NaN halos."""
    _card()
    pd, ot, x, offs = _spmv_operands(xdt, pdt)
    n = x.shape[0]
    before = dia_spmv_aligned.launches
    y = dia_spmv_aligned(pd, ot, x)
    assert dia_spmv_aligned.launches == before + 1
    assert y.dtype == xdt
    assert _rel(y, dia_spmv_aligned_ref(pd, ot, x)) <= tol
    xw = kt.dia_pad_layout(x, offs)
    h = (xw.shape[0] - n) // 2
    xw[:h] = float("nan")
    xw[h + n:] = float("nan")
    before = kt.dia_spmv_padded.launches
    y2w = kt.dia_spmv_padded(pd, ot, kt.dia_spmv_padded(pd, ot, xw, n), n)
    assert kt.dia_spmv_padded.launches == before + 2
    y2 = kt.dia_unpad_layout(y2w, offs, n)
    assert bool(torch.isfinite(torch.view_as_real(y2) if y2.is_complex()
                               else y2).all())
    want = dia_spmv_aligned_ref(pd, ot, dia_spmv_aligned_ref(pd, ot, x))
    assert _rel(y2, want) <= 4 * tol


@pytest.mark.cuda
def test_spmv_kernel_raises_for_other_pairs():
    _card()
    pd, ot, x, _ = _spmv_operands(torch.float32, torch.float64)
    with pytest.raises(ValueError, match="float32 with pd torch.float64"):
        dia_spmv_aligned(pd, ot, x)
    pd, ot, x, _ = _spmv_operands(torch.float32, torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        dia_spmv_aligned(pd, ot, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,jacobi", [(torch.float32, False),
                                          (torch.float32, True),
                                          (torch.float64, False)])
def test_cg_kernel_matches_plain_on_card(dtype, jacobi):
    """Same status, niter within ±max(2, 10%), x to 1e-4 relative."""
    _card()
    A = kt.poisson_dia(16, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(9).standard_normal(n)).to(
        "cuda", dtype)
    dinv = None
    if jacobi:
        dinv = 1.0 / (6.0 + 0.5 * torch.sin(torch.arange(
            n, device="cuda", dtype=dtype)))
    before = cg_dia_fused.launches
    k = cg_dia_fused(pd, ot, b, 0.0, 1e-6, 1000, dinv=dinv)
    assert cg_dia_fused.launches > before
    r = cg_dia_fused_ref(pd, ot, b, 0.0, 1e-6, 1000, dinv=dinv)
    assert int(k[3]) == int(r[3]) == rt.SOLVED
    assert int(k[4]) == int(r[4]) == 0
    assert abs(int(k[1]) - int(r[1])) <= max(2, 0.1 * int(r[1]))
    assert _rel(k[0], r[0]) <= 1e-4


@pytest.mark.cuda
def test_cg_on_card_takes_both_kernels():
    _card()
    A = kt.poisson_dia(16)
    b = torch.as_tensor(np.random.default_rng(13).standard_normal(16 ** 3),
                        dtype=torch.float32, device="cuda")
    n0 = kt.kernel_launches()
    x, st = kt.cg(A, b)
    x2, st2 = kt.cg(A, b, history=True)
    n1 = kt.kernel_launches()
    assert st.status == st2.status == "solution good enough given atol " \
        "and rtol"
    assert n1["cg_dia"] > n0["cg_dia"] and n1["dia_spmv"] > n0["dia_spmv"]
    assert abs(st.niter - st2.niter) <= max(2, 0.1 * st2.niter)


def _poisson_on_card(N, dtype, seed=9):
    A = kt.poisson_dia(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(seed).standard_normal(n)).to(
        "cuda", dtype)
    return A, pd, ot, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["cheby1", "cheby8", "cr", "car",
                                    "minres", "minres_lam",
                                    "minres_jacobi"])
def test_symmetric_kernels_match_plain_on_card(kernel, dtype):
    """Each whole-solve kernel against its plain version on the same
    inputs: same status and flags, niter within ±max(2, 10%) (equal in
    f64), x to 1e-4 relative (1e-10 in f64)."""
    _card()
    _, pd, ot, b = _poisson_on_card(16, dtype)
    n = b.shape[0]
    rtol = 1e-6 if dtype == torch.float32 else 1e-10
    dinv = 1.0 / (6.0 + 0.5 * torch.sin(torch.arange(n, device="cuda",
                                                     dtype=dtype)))
    wrapper, ref, args, kw = {
        "cheby1": (cf.cg_cheby_dia_fused, cf.cg_cheby_dia_fused_ref,
                   (0.0, rtol, 2 * n, 0.4, 12.2, 1), {}),
        "cheby8": (cf.cg_cheby_dia_fused, cf.cg_cheby_dia_fused_ref,
                   (0.0, rtol, 2 * n, 0.4, 12.2, 8), {}),
        "cr": (cf.cr_dia_fused, cf.cr_dia_fused_ref, (0.0, rtol, 2 * n), {}),
        "car": (cf.car_dia_fused, cf.car_dia_fused_ref, (0.0, rtol, 2 * n),
                {}),
        "minres": (cf.minres_dia_fused, cf.minres_dia_fused_ref,
                   (0.0, rtol, rtol, 1e-8, 0.0, 2 * n), {}),
        "minres_lam": (cf.minres_dia_fused, cf.minres_dia_fused_ref,
                       (0.0, rtol, rtol, 1e-8, 0.5, 2 * n), {}),
        "minres_jacobi": (cf.minres_dia_fused, cf.minres_dia_fused_ref,
                          (0.0, rtol, rtol, 1e-8, 0.0, 2 * n),
                          {"dinv": dinv}),
    }[kernel]
    before = wrapper.launches
    k = wrapper(pd, ot, b, *args, **kw)
    assert wrapper.launches > before
    r = ref(pd, ot, b, *args, **kw)
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:] == rints[1:]                   # status and flags
    if dtype == torch.float64:
        assert kints[0] == rints[0]
        assert _rel(k[0], r[0]) <= 1e-10
    else:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        assert _rel(k[0], r[0]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["cg_lanczos", "cg_lanczos_curvature",
                                    "shift", "shift_curvature", "symmlq",
                                    "symmlq_lam", "symmlq_no_transfer",
                                    "symmlq_init_transfer"])
def test_lanczos_kernels_match_plain_on_card(kernel, dtype):
    """The CG-Lanczos, CG-Lanczos-shift and SYMMLQ kernels against their
    plain versions on the same inputs: same status and flags, niter
    within ±max(2, 10%) (equal in f64), x to 1e-4 relative (1e-10 in
    f64)."""
    _card()
    A, pd, ot, b = _poisson_on_card(16, dtype)
    n = b.shape[0]
    rtol = 1e-6 if dtype == torch.float32 else 1e-10
    if kernel.endswith("curvature") and not kernel.startswith("shift"):
        data = A.data.clone()
        data[A.offsets.index(0), : n // 2] *= -1.0
        pd = dia_align(data, A.offsets, n)
    shifts = torch.tensor([-2.0, 0.0, 0.5, 2.0] if kernel ==
                          "shift_curvature" else [0.0, 0.5, 1.0, 2.0],
                          dtype=dtype, device="cuda")
    if kernel == "symmlq_init_transfer":
        b = b / b.norm()
    wrapper, ref, args, kw = {
        "cg_lanczos": (cf.cg_lanczos_dia_fused, cf.cg_lanczos_dia_fused_ref,
                       (0.0, rtol, 2 * n), {}),
        "cg_lanczos_curvature": (cf.cg_lanczos_dia_fused,
                                 cf.cg_lanczos_dia_fused_ref,
                                 (0.0, rtol, 2 * n),
                                 {"check_curvature": True}),
        "shift": (cf.cg_lanczos_shift_dia_fused,
                  cf.cg_lanczos_shift_dia_fused_ref,
                  (shifts, 0.0, rtol, 2 * n), {}),
        "shift_curvature": (cf.cg_lanczos_shift_dia_fused,
                            cf.cg_lanczos_shift_dia_fused_ref,
                            (shifts, 0.0, rtol, 2 * n),
                            {"check_curvature": True}),
        "symmlq": (cf.symmlq_dia_fused, cf.symmlq_dia_fused_ref,
                   (0.0, rtol, 1e-8, 0.0, 2 * n), {}),
        "symmlq_lam": (cf.symmlq_dia_fused, cf.symmlq_dia_fused_ref,
                       (0.0, rtol, 1e-8, 0.5, 2 * n), {}),
        "symmlq_no_transfer": (cf.symmlq_dia_fused, cf.symmlq_dia_fused_ref,
                               (0.0, rtol, 1e-8, 0.0, 2 * n),
                               {"transfer_to_cg": False}),
        "symmlq_init_transfer": (cf.symmlq_dia_fused,
                                 cf.symmlq_dia_fused_ref,
                                 (0.5, 0.0, 1e-8, 0.0, 2 * n), {}),
    }[kernel]
    before = wrapper.launches
    k = wrapper(pd, ot, b, *args, **kw)
    assert wrapper.launches > before
    r = ref(pd, ot, b, *args, **kw)
    kints = [v.tolist() for v in k[1:] if v.dtype == torch.int32]
    rints = [v.tolist() for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:] == rints[1:]                   # status and flags
    if kernel == "symmlq_init_transfer":
        assert kints[0] == 0 and kints[1] == cf.SOLVED_CG_PT
    if dtype == torch.float64:
        assert kints[0] == rints[0]
        assert _rel(k[0], r[0]) <= 1e-10
    else:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        assert _rel(k[0], r[0]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["minres_qlp", "minres_qlp_lam",
                                    "minres_qlp_indefinite",
                                    "minres_qlp_three_eigenvalues",
                                    "minares", "minares_lam",
                                    "minares_indefinite",
                                    "minares_three_eigenvalues"])
def test_qlp_and_minares_kernels_match_plain_on_card(kernel, dtype):
    """The MINRES-QLP and MINARES kernels against their plain versions on
    the same inputs: same status and flags, niter within ±max(2, 10%)
    (equal in f64), x to 1e-4 relative (1e-10 in f64).  λ = −2 makes the
    stencil indefinite; it runs 40 iterations, a tenth of the five
    hundred it needs, where two f32 solves still agree to about 1e-6
    (at 60 they part by 6e-5 in the plain versions' f32 against f64 on
    the CPU).
    The diagonal matrix with three distinct eigenvalues exhausts the
    Krylov space at the third step: MINARES's Lanczos process stops (ℓ)
    while the iteration finishes."""
    _card()
    _, pd, ot, b = _poisson_on_card(16, dtype)
    n = b.shape[0]
    rtol = 1e-6 if dtype == torch.float32 else 1e-10
    artol = 1e-6 if dtype == torch.float32 else 1e-10
    lam, itmax = 0.0, 2 * n
    if kernel.endswith("lam"):
        lam = 0.5
    elif kernel.endswith("indefinite"):
        lam, itmax = -2.0, 40
    elif kernel.endswith("three_eigenvalues"):
        pd = (1.0 + torch.arange(n, device="cuda") % 3).to(dtype)[None]
        ot = offsets_tensor((0,), "cuda")
    name = "minres_qlp" if kernel.startswith("minres_qlp") else "minares"
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    args = (0.0, rtol, artol, lam, itmax)
    before = wrapper.launches
    k = wrapper(pd, ot, b, *args)
    assert wrapper.launches > before
    r = ref(pd, ot, b, *args)
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:] == rints[1:]                   # status and flags
    if kernel.endswith("three_eigenvalues"):
        assert rints[0] <= 4
    if dtype == torch.float64:
        assert kints[0] == rints[0]
        assert _rel(k[0], r[0]) <= 1e-10
    else:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        assert _rel(k[0], r[0]) <= 1e-4


@pytest.mark.cuda
def test_repaired_faults_on_card():
    """An f64 numpy b on f32 diagonals, a complex128 system and a Jacobi
    M built from numpy all solve on the card through the general route's
    SpMV kernel."""
    _card()
    A = kt.poisson_dia(16)
    b = np.random.default_rng(14).standard_normal(16 ** 3)
    n0 = kt.kernel_launches()["dia_spmv"]
    x, st = kt.cg(A, b)
    assert x.is_cuda and x.dtype == torch.float64 and st.solved
    assert kt.kernel_launches()["dia_spmv"] > n0
    A64 = kt.poisson_dia(16, dtype=torch.float64)
    x, st = kt.cr(A64, (1.0 + 0.5j) * b)
    assert x.is_cuda and x.dtype == torch.complex128 and st.solved
    M = kt.DiagonalOperator(np.full(16 ** 3, 1.0 / 6.0, np.float32))
    assert M.d.is_cuda
    x, st = kt.cg(kt.DIAOperator(A), b.astype(np.float32), M=M)
    assert x.is_cuda and st.solved


@pytest.mark.cuda
def test_solvers_on_card_take_their_kernels():
    """cg with a Chebyshev M on the same operator and every other ported
    solver run their kernels on the card; a numpy b beside a card
    operator goes to the card."""
    _card()
    A = kt.DIAOperator(kt.poisson_dia(16))
    b = np.random.default_rng(13).standard_normal(16 ** 3).astype(
        np.float32)
    runs = [("cg_cheby_dia", lambda: kt.cg(
                A, b, M=kt.ChebyshevPreconditioner(A, degree=4))),
            ("cr_dia", lambda: kt.cr(A, b)),
            ("car_dia", lambda: kt.car(A, b)),
            ("minres_dia", lambda: kt.minres(A, b)),
            ("cg_dia", lambda: kt.cg(A, b)),
            ("cg_lanczos_dia", lambda: kt.cg_lanczos(A, b)),
            ("cg_lanczos_shift_dia",
             lambda: kt.cg_lanczos_shift(A, b, [0.0, 1.0])),
            ("symmlq_dia", lambda: kt.symmlq(A, b)),
            ("minres_qlp_dia", lambda: kt.minres_qlp(A, b)),
            ("minares_dia", lambda: kt.minares(A, b)),
            ("gmres_dia", lambda: kt.gmres(A, b, memory=10, restart=True)),
            ("gmres_dia", lambda: kt.fgmres(A, b)),
            ("fom_dia", lambda: kt.fom(A, b, memory=10, restart=True)),
            ("bicgstab_dia", lambda: kt.bicgstab(A, b)),
            ("cgs_dia", lambda: kt.cgs(A, b))]
    for name, run in runs:
        n0 = kt.kernel_launches()[name]
        x, st = run()
        assert x.is_cuda and x.dtype == torch.float32 and st.solved
        assert kt.kernel_launches()[name] > n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["gmres20", "gmres20_bf16", "gmres",
                                    "gmres_zero_rhs", "fom20", "fom_itmax",
                                    "bicgstab", "bicgstab_zero_rhs", "cgs"])
def test_nonsymmetric_kernels_match_plain_on_card(kernel, dtype):
    """The GMRES, FOM, BiCGSTAB and CGS kernels against their plain
    versions on the 16^3 convection-diffusion stencil: same status and
    flags, niter within ±max(2, 10%) (equal in f64), x to 1e-2 relative
    (1e-8 in f64), as chip_smoke.py holds them at 128^3.  "gmres" takes
    the default memory of a solve without restart (512); "fom_itmax"
    stops at itmax = 30 in the middle of its second pass."""
    _card()
    A = kt.convdiff_dia(16, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(n)).to(
        "cuda", dtype)
    if kernel.endswith("zero_rhs"):
        b = torch.zeros_like(b)
    rtol = 1e-6 if dtype == torch.float32 else 1e-10
    name = next(k for k in ("gmres", "fom", "bicgstab", "cgs")
                if kernel.startswith(k))
    args = (0.0, rtol, 30 if kernel.endswith("itmax") else 2 * n)
    if name in ("gmres", "fom"):
        args += (20 if "20" in kernel or name == "fom" else 512,)
    if kernel.endswith("bf16"):
        args += (torch.bfloat16,)
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    before = wrapper.launches
    k = wrapper(pd, ot, b, *args)
    assert wrapper.launches > before
    r = ref(pd, ot, b, *args)
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
    f32 = dtype == torch.float32
    # status and flags; npass (GMRES, FOM) within the niter band in f32
    assert kints[1:3] == rints[1:3]
    if f32:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        assert _rel(k[0], r[0]) <= 1e-2 if rints[0] else \
            bool((k[0] == 0).all())
    else:
        assert kints == rints
        assert _rel(k[0], r[0]) <= 1e-8 if rints[0] else \
            bool((k[0] == 0).all())


def _hold_arnoldi(k, r, f32):
    """The assertions of test_nonsymmetric_kernels_match_plain_on_card on
    a GMRES or FOM kernel's outputs: status and the inconsistent flag
    equal; niter within ±max(2, 10%) and x to 1e-2 relative in f32; every
    int output equal and x to 1e-8 relative in f64."""
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:3] == rints[1:3]
    if f32:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        assert _rel(k[0], r[0]) <= 1e-2
    else:
        assert kints == rints
        assert _rel(k[0], r[0]) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("panel", [torch.bfloat16, torch.float16])
def test_gmres_kernel_panels_match_plain_on_card(panel, dtype):
    """GMRES with a bf16 and an f16 Krylov panel (the stencil reads it 8
    or 4 bytes a thread, the dots and the update widen it to T, the
    normalise narrows v_{k+1}) against its plain version on the 16^3
    convection-diffusion stencil, memory 20, as
    test_nonsymmetric_kernels_match_plain_on_card holds its bf16 case."""
    _card()
    A = kt.convdiff_dia(16, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(n)).to(
        "cuda", dtype)
    f32 = dtype == torch.float32
    args = (pd, ot, b, 0.0, 1e-6 if f32 else 1e-10, 2 * n, 20, panel)
    before = cf.gmres_dia_fused.launches
    k = cf.gmres_dia_fused(*args)
    assert cf.gmres_dia_fused.launches > before
    _hold_arnoldi(k, cf.gmres_dia_fused_ref(*args), f32)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["gmres", "fom"])
@pytest.mark.parametrize("mem", [600, 900])
def test_arnoldi_kernel_large_memories_match_plain_on_card(method, mem):
    """Memories past the stencil's registers at n = 8^3 in f64: the dots
    go in groups of 12 basis vectors, the block walking its rows again
    for each group.  The kernel against its plain version, as
    test_nonsymmetric_kernels_match_plain_on_card holds f64, and
    gmres/fom on a card operator take the kernel."""
    _card()
    A = kt.DIAOperator(kt.convdiff_dia(8, dtype=torch.float64))
    b = torch.as_tensor(np.random.default_rng(21).standard_normal(512),
                        device="cuda")
    pd = dia_align(A.dia.data, A.dia.offsets, 512)
    ot = offsets_tensor(A.dia.offsets, "cuda")
    args = (pd, ot, b, 0.0, 1e-10, 300, mem)
    _hold_arnoldi(getattr(cf, method + "_dia_fused")(*args),
                  getattr(cf, method + "_dia_fused_ref")(*args), False)
    n0 = kt.kernel_launches()
    x, st = getattr(kt, method)(A, b, memory=mem, rtol=1e-10)
    n1 = kt.kernel_launches()
    assert st.solved and n1[method + "_dia"] > n0[method + "_dia"]
    assert _true_res(pd, ot, b, x) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("mem", [900, 4200])
def test_gmres_kernel_long_pass_matches_plain_on_card(mem):
    """One long pass of GMRES in f64 on the 16^3 Poisson stencil with the
    first half of its main diagonal negated (an indefinite system; the
    plain version stops at 572 iterations on the CPU): past k = 512 the
    update takes its h in two chunks, and at memory 4200 the coefficient
    launch builds h in place in the scalar array (past its shared
    memory).  Held as the truncated kernels are (_hold_to_plain): status
    and flags equal, niter within ±max(2, 10%) and a true residual no
    worse than 1.5 times the plain version's, since a stop after some 570
    steps on an indefinite system moves with the order of the sums even
    in f64."""
    _card()
    A = kt.poisson_dia(16, dtype=torch.float64)
    data = A.data.clone()
    data[A.offsets.index(0), :2048] *= -1.0
    pd = dia_align(data, A.offsets, 4096)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(23).standard_normal(4096),
                        device="cuda")
    args = (pd, ot, b, 0.0, 1e-10, 600, mem)
    _hold_to_plain(cf.gmres_dia_fused(*args), cf.gmres_dia_fused_ref(*args),
                   pd, ot, b, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fom_kernel_breakdown_on_card(dtype):
    """FOM's breakdown without convergence ("inconsistent linear
    system", status 28) on the card: a diagonal of 1, 2, 0, 3 repeated
    (16^3 rows) with b = 1 exhausts its Krylov space at the fourth step
    while b keeps a part in the null space.  Status, niter and the
    inconsistent flag equal to the plain version's; x grows along the
    null space by a rounding-dependent amount and is not compared, as
    tests/test_torch_fom.py holds the same case."""
    _card()
    n = 16 ** 3
    data = torch.tensor([1.0, 2.0, 0.0, 3.0], dtype=dtype,
                        device="cuda").repeat(n // 4)[None]
    pd = dia_align(data, (0,), n)
    ot = offsets_tensor((0,), "cuda")
    b = torch.ones(n, dtype=dtype, device="cuda")
    args = (pd, ot, b, 0.0, 1e-6 if dtype == torch.float32 else 1e-10, 100,
            20)
    k = cf.fom_dia_fused(*args)
    r = cf.fom_dia_fused_ref(*args)
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    assert kints == [int(v) for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:3] == [28, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [15, 17])
@pytest.mark.parametrize("method,mem", [("gmres", 20), ("gmres", 512),
                                        ("fom", 20)])
def test_arnoldi_kernel_row_tails_match_plain_on_card(method, mem, N, dtype):
    """GMRES at memory 20 and 512 and FOM at n = 15^3 and 17^3, no
    multiple of the rows a thread owns (4 in f32, 2 in f64), so the
    stencil, update and normalise take their element-wise rows with the
    masked tails; against the plain versions on the convection-diffusion
    stencil as test_nonsymmetric_kernels_match_plain_on_card holds them
    (_hold_arnoldi)."""
    _card()
    A = kt.convdiff_dia(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(n)).to(
        "cuda", dtype)
    f32 = dtype == torch.float32
    args = (pd, ot, b, 0.0, 1e-6 if f32 else 1e-10, 2 * n, mem)
    wrapper = getattr(cf, method + "_dia_fused")
    before = wrapper.launches
    k = wrapper(*args)
    assert wrapper.launches > before
    _hold_arnoldi(k, getattr(cf, method + "_dia_fused_ref")(*args), f32)


@pytest.mark.cuda
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("method,panel", [("gmres", None),
                                          ("gmres", torch.bfloat16),
                                          ("fom", None)])
def test_arnoldi_kernel_narrow_diagonals_match_plain_on_card(method, panel,
                                                             pdt):
    """GMRES (an f32 and a bf16 panel) and FOM with bf16 and f16
    diagonals beside f32 vectors on the 16^3 convection-diffusion
    stencil, memory 20: 8 rows a thread on the wide rows, the group's
    dots in registers beside them.  Against the plain versions on the
    same narrow diagonals as test_nonsymmetric_kernels_match_plain_on_card
    holds f32 (_hold_arnoldi)."""
    _card()
    A = kt.convdiff_dia(16, dtype=torch.float32)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n).to(pdt)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(15).standard_normal(n)).to(
        "cuda", torch.float32)
    args = (pd, ot, b, 0.0, 1e-6, 2 * n, 20)
    if panel is not None:
        args += (panel,)
    wrapper = getattr(cf, method + "_dia_fused")
    before = wrapper.launches
    k = wrapper(*args)
    assert wrapper.launches > before
    _hold_arnoldi(k, getattr(cf, method + "_dia_fused_ref")(*args), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["diom2", "diom6", "diom20", "dqgmres2",
                                    "dqgmres20", "diom_zero_rhs", "bilq",
                                    "bilq_lq", "bilq_zero_rhs", "qmr",
                                    "bilqr", "bilqr_bc"])
def test_slice6_kernels_match_plain_on_card(kernel, dtype):
    """The DIOM/DQGMRES, BiLQ, QMR and BiLQR kernels against their plain
    versions on the 16^3 convection-diffusion stencil: same status (and
    BiLQR's flags), niter within ±max(2, 10%) (equal in f64), x (and y)
    to 1e-2 relative (1e-8 in f64), as chip_smoke.py holds them at
    128^3.  "bilqr_bc" takes a c orthogonal to b (the breakdown
    b'c = 0).  BiLQR in f32 is held to its status and flags only: its two
    recurrences amplify rounding until the kernel and its plain version
    stop hundreds of iterations apart (424 against 245 at 16^3 on the
    card), so its full-width path runs in f64 (PERF.md section 7)."""
    _card()
    A = kt.convdiff_dia(16, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    ot = offsets_tensor(A.offsets, "cuda")
    pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
    ota = offsets_tensor(offa, "cuda")
    rng = np.random.default_rng(16)
    b = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    c = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    if kernel.endswith("zero_rhs"):
        b = torch.zeros_like(b)
    if kernel == "bilqr_bc":
        c = torch.zeros_like(b)
        c[0], c[1] = b[1], -b[0]
    rtol = 1e-6 if dtype == torch.float32 else 1e-10
    tol = (0.0, rtol, 2 * n)
    name = next(k for k in ("diom", "dqgmres", "bilqr", "bilq", "qmr")
                if kernel.startswith(k))
    if name in ("diom", "dqgmres"):
        wrapper, ref = cf.trunc_dia_fused, cf.trunc_dia_fused_ref
        mem = int("".join(ch for ch in kernel if ch.isdigit()) or 20)
        args = (pd, ot, b) + tol + (mem, name)
    else:
        wrapper = getattr(cf, name + "_dia_fused")
        ref = getattr(cf, name + "_dia_fused_ref")
        args = (pd, pda, ot, ota, b) + ((c,) if name == "bilqr" else ()) \
            + tol + (() if name == "qmr" else (kernel != "bilq_lq",))
    before = wrapper.launches
    k = wrapper(*args)
    assert wrapper.launches > before
    r = ref(*args)
    ints = [(v, w) for v, w in zip(k, r) if v.dtype == torch.int32]
    kints = [i for v, _ in ints for i in v.reshape(-1).tolist()]
    rints = [i for _, w in ints for i in w.reshape(-1).tolist()]
    assert kints[1:] == rints[1:]
    vecs = [(v, w) for v, w in zip(k, r) if v.dim() == 1 and v.numel() == n]
    if dtype == torch.float32 and name == "bilqr":
        return
    if dtype == torch.float32:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        tol_x = 1e-2
    else:
        assert kints[0] == rints[0]
        tol_x = 1e-8
    for v, w in vecs:
        assert bool((v == 0).all()) if not w.any() else _rel(v, w) <= tol_x


def _hold_two_sided(k, r, n, f32, status_only=False):
    """A two-sided kernel's outputs against its plain version's, under the
    assertions of test_slice6_kernels_match_plain_on_card: status and
    flags equal, niter equal in f64 (within ±max(2, 10%) in f32), x (and
    y) to 1e-8 relative in f64 (1e-2 in f32)."""
    ints = [(v, w) for v, w in zip(k, r) if v.dtype == torch.int32]
    kints = [i for v, _ in ints for i in v.reshape(-1).tolist()]
    rints = [i for _, w in ints for i in w.reshape(-1).tolist()]
    assert kints[1:] == rints[1:]
    if status_only:
        return
    if f32:
        assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
        tol_x = 1e-2
    else:
        assert kints[0] == rints[0]
        tol_x = 1e-8
    vecs = [(v, w) for v, w in zip(k, r) if v.dim() == 1 and v.numel() == n]
    for v, w in vecs:
        assert bool((v == 0).all()) if not w.any() else _rel(v, w) <= tol_x


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N,dtype,pdt,itmax", [
    ("qmr", 15, torch.float64, None, None),
    ("qmr", 17, torch.float64, None, None),
    ("bilqr", 15, torch.float64, None, None),
    ("bilqr", 17, torch.float64, None, None),
    ("bilqr", 15, torch.float32, None, None),
    ("qmr", 16, torch.float32, torch.bfloat16, None),
    ("qmr", 16, torch.float32, torch.float16, None),
    ("bilqr", 16, torch.float32, torch.float16, None),
    ("qmr", 16, torch.float64, None, 40),
    ("qmr", 16, torch.float64, None, 64),
    ("qmr", 17, torch.float64, None, 64),
    ("qmr", 16, torch.float32, torch.bfloat16, 40),
])
def test_two_sided_fused_design_matches_plain_on_card(kernel, N, dtype, pdt,
                                                      itmax):
    """The QMR and BiLQR kernels against their plain versions, as
    test_slice6_kernels_match_plain_on_card holds them:
    n = 15^3 and 17^3, no multiple of the rows a thread owns, so the
    stencil's scalar path and its masked rows run; bf16 and f16 diagonals
    with f32 vectors (8 rows a thread); and QMR stopped by itmax in the
    middle of its first 64-iteration chunk (40) and on its last
    iteration (64), so that the finishing launch applies the late
    direction and x update at both ends (QMR takes 90 iterations at 16^3
    and 97 at 17^3 in f64).  BiLQR in f32 is held to its status and
    flags only, as there.  f32 QMR at 17^3 and f32 BiLQR on bf16
    diagonals are not held: there the kernel and the plain version stop
    hundreds of iterations apart on estimates that have lost their
    accuracy, as the earlier kernels did (whose iterates these repeat bit
    for bit at 15^3 to 64^3 on f32 and f64 diagonals; PERF.md section
    7)."""
    _card()
    A = kt.convdiff_dia(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
    if pdt is not None:
        pd, pda = pd.to(pdt), pda.to(pdt)
    ot = offsets_tensor(A.offsets, "cuda")
    ota = offsets_tensor(offa, "cuda")
    rng = np.random.default_rng(16)
    b = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    c = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    f32 = dtype == torch.float32
    tol = (0.0, 1e-6 if f32 else 1e-10, itmax or 2 * n)
    wrapper = getattr(cf, kernel + "_dia_fused")
    ref = getattr(cf, kernel + "_dia_fused_ref")
    args = (pd, pda, ot, ota, b) + ((c,) + tol + (True,)
                                    if kernel == "bilqr" else tol)
    before = wrapper.launches
    k = wrapper(*args)
    assert wrapper.launches > before
    r = ref(*args)
    if itmax is not None:
        assert int(k[1]) == int(r[1]) == itmax
    _hold_two_sided(k, r, n, f32, status_only=f32 and kernel == "bilqr")


@pytest.mark.cuda
def test_bilqr_dual_runs_on_after_pq_breakdown_on_card():
    """BiLQR where <p, q> reaches exactly 0 in its first iteration, which
    also solves the primal system (the BiCG point), while the dual runs
    on: A = 2 I as one diagonal, b = 1 and c = 1 on the first four rows,
    c = 0.5 on the next four, so every sum is exact and q = p = 0.  The
    second iteration takes v_2 = v_1 and u_2 = u_1 (the stencil's copy
    path) and solves the dual system (status 15 after 2 iterations in the
    plain version).  Held to the plain version as
    test_slice6_kernels_match_plain_on_card holds BiLQR in f64."""
    _card()
    n = 16 ** 3
    pd = torch.full((1, n), 2.0, dtype=torch.float64, device="cuda")
    ot = offsets_tensor((0,), "cuda")
    b = torch.zeros(n, dtype=torch.float64, device="cuda")
    b[:4] = 1.0
    c = b.clone()
    c[4:8] = 0.5
    args = (pd, pd, ot, ot, b, c, 0.0, 1e-10, 2 * n, True)
    before = cf.bilqr_dia_fused.launches
    k = cf.bilqr_dia_fused(*args)
    assert cf.bilqr_dia_fused.launches > before
    r = cf.bilqr_dia_fused_ref(*args)
    assert (int(r[2]), int(r[5])) == (2, 15)
    _hold_two_sided(k, r, n, False)
    assert _rel(k[1], c / 2) <= 1e-12


def _unaligned(t):
    """A contiguous copy of t whose data starts one element past a
    16-byte boundary, so the kernels take their element-wise paths."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _true_res(pd, ot, b, x):
    """‖b − Ax‖ / ‖b‖ in f64 from the plain SpMV (0 where b = 0)."""
    r = b.double() - dia_spmv_aligned_ref(pd.double(), ot, x.double())
    nb = float(b.double().norm())
    return float(r.norm()) / nb if nb else float(r.norm())


def _hold_to_plain(k, r, pd, ot, b, f64):
    """Status (and flags) equal, niter within ±max(2, 10%), and a true
    residual no worse than 1.5 times the plain version's (with 1e-9 of
    slack in f64, where both sit near rounding level)."""
    ints = [(v, w) for v, w in zip(k, r) if v.dtype == torch.int32]
    kints = [i for v, _ in ints for i in v.reshape(-1).tolist()]
    rints = [i for _, w in ints for i in w.reshape(-1).tolist()]
    assert kints[1:] == rints[1:]
    assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
    slack = 1e-9 if f64 else 0.0
    assert _true_res(pd, ot, b, k[0]) <= \
        1.5 * _true_res(pd, ot, b, r[0]) + slack


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype,transfer,unaligned", [
    (15, torch.float64, True, False),
    (17, torch.float64, False, True),
    (16, torch.float64, True, True),
    (16, torch.float64, False, False),
])
def test_bilq_three_launches_match_plain_on_card(N, dtype, transfer,
                                                 unaligned):
    """BiLQ on the two-sided stencil, its fused launch and the normalising
    launch, with and without the BiCG transfer, at n = 15^3 and 17^3 (no
    multiple of the rows a thread owns, so the masked rows run) and with
    diagonals one element past a 16-byte boundary (the element-wise
    path), against its plain version in f64: status, niter within
    ±max(2, 10%), true residual no worse than 1.5 times the plain
    version's.  (In f32 at 16^3, on other right-hand sides than
    test_slice6_kernels_match_plain_on_card's, the plain version stops
    on an estimate that has lost its accuracy, at a true residual of 11,
    where the kernel stops at 3.6e-4: PERF.md section 7.)"""
    _card()
    A = kt.convdiff_dia(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
    if unaligned:
        pd, pda = _unaligned(pd), _unaligned(pda)
    ot = offsets_tensor(A.offsets, "cuda")
    ota = offsets_tensor(offa, "cuda")
    b = torch.as_tensor(np.random.default_rng(19).standard_normal(n)).to(
        "cuda", dtype)
    f64 = dtype == torch.float64
    args = (pd, pda, ot, ota, b, 0.0, 1e-10 if f64 else 1e-6, 2 * n,
            transfer)
    before = cf.bilq_dia_fused.launches
    k = cf.bilq_dia_fused(*args)
    assert cf.bilq_dia_fused.launches > before
    _hold_to_plain(k, cf.bilq_dia_fused_ref(*args), pd, ot, b, f64)


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", [True, False])
def test_bilq_pq_breakdown_on_card(transfer):
    """BiLQ where <p, q> reaches exactly 0 in its first iteration: A = 2 I
    as one diagonal and b = 1 on the first four rows, so q = p = 0.  With
    the transfer the BiCG point solves it (status 36, x = b / 2), without
    it the solve stops on the breakdown (38); both as the plain
    version."""
    _card()
    n = 16 ** 3
    pd = torch.full((1, n), 2.0, dtype=torch.float64, device="cuda")
    ot = offsets_tensor((0,), "cuda")
    b = torch.zeros(n, dtype=torch.float64, device="cuda")
    b[:4] = 1.0
    args = (pd, pd, ot, ot, b, 0.0, 1e-10, 2 * n, transfer)
    k = cf.bilq_dia_fused(*args)
    r = cf.bilq_dia_fused_ref(*args)
    assert (int(r[1]), int(r[3])) == (1, 36 if transfer else 38)
    assert (int(k[1]), int(k[3])) == (int(r[1]), int(r[3]))
    assert _rel(k[0], r[0]) <= 1e-12
    if transfer:
        assert _rel(k[0], b / 2) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["diom", "dqgmres"])
@pytest.mark.parametrize("mem,N,dtype,pdt,unaligned", [
    (2, 16, torch.float64, None, False),
    (3, 16, torch.float64, None, False),
    (8, 16, torch.float64, None, False),
    (9, 16, torch.float64, None, False),
    (20, 16, torch.float64, None, False),
    (30, 16, torch.float64, None, False),
    (20, 16, torch.float32, None, False),
    (9, 15, torch.float32, None, False),
    (20, 17, torch.float64, None, True),
    (30, 15, torch.float32, None, True),
    (20, 15, torch.float32, torch.bfloat16, False),
    (30, 16, torch.float32, torch.bfloat16, False),
    (20, 16, torch.float32, torch.float16, False),
    (30, 15, torch.float32, torch.float16, False),
])
def test_trunc_kernel_memories_match_plain_on_card(variant, mem, N, dtype,
                                                   pdt, unaligned):
    """The DIOM/DQGMRES kernel at memory 2, 3, 8, 9, 20 and 30 (past the
    24 window slots its stencil sums in registers, so the others take
    each warp's sums in memory), at n = 15^3 and 17^3 (no multiple of
    the rows a thread owns), with diagonals one element past a 16-byte
    boundary (the element-wise path) and with bf16 and f16 diagonals
    beside f32 vectors (8 rows a thread), against its plain version at
    itmax 300: status, niter within ±max(2, 10%), true residual no worse
    than 1.5 times the plain version's."""
    _card()
    A = kt.convdiff_dia(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    if pdt is not None:
        pd = pd.to(pdt)
    if unaligned:
        pd = _unaligned(pd)
    ot = offsets_tensor(A.offsets, "cuda")
    b = torch.as_tensor(np.random.default_rng(20).standard_normal(n)).to(
        "cuda", dtype)
    f64 = dtype == torch.float64
    args = (pd, ot, b, 0.0, 1e-10 if f64 else 1e-6, 300, mem, variant)
    before = cf.trunc_dia_fused.launches
    k = cf.trunc_dia_fused(*args)
    assert cf.trunc_dia_fused.launches > before
    _hold_to_plain(k, cf.trunc_dia_fused_ref(*args), pd, ot, b, f64)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["diom", "dqgmres"])
@pytest.mark.parametrize("mem", [600, 900])
def test_trunc_kernel_large_memories_match_plain_on_card(variant, mem):
    """Memories that the JAX package's gate admits at small n (2 mem + 5
    vectors under 100 MB): at n = 8^3 in f64, 600 takes two chunks of
    window dots in the subtraction launch, and 900 also runs the column
    launch on its rings in place (past its shared-memory limit).  The
    kernel against its plain version, as at the smaller memories, and
    dqgmres/diom on a card operator take the kernel."""
    _card()
    A = kt.DIAOperator(kt.convdiff_dia(8, dtype=torch.float64))
    b = torch.as_tensor(np.random.default_rng(21).standard_normal(512),
                        device="cuda")
    pd = dia_align(A.dia.data, A.dia.offsets, 512)
    ot = offsets_tensor(A.dia.offsets, "cuda")
    args = (pd, ot, b, 0.0, 1e-10, 300, mem, variant)
    _hold_to_plain(cf.trunc_dia_fused(*args), cf.trunc_dia_fused_ref(*args),
                   pd, ot, b, True)
    n0 = kt.kernel_launches()
    x, st = getattr(kt, variant)(A, b, memory=mem, rtol=1e-10)
    n1 = kt.kernel_launches()
    assert st.solved and n1["trunc_dia"] > n0["trunc_dia"]
    assert _true_res(pd, ot, b, x) <= 1e-8


@pytest.mark.cuda
def test_csr_products_on_card_repeat_their_bits():
    """The CSR products on the card sum each row in a fixed order: two
    calls of spmv and of spmm (real and complex) give equal bits, and so
    do two CSROperator solves."""
    _card()
    rng = np.random.default_rng(33)
    n = 1 << 13
    csr = _spd_band_csr(rng, n, np.float64)
    x = torch.as_tensor(rng.standard_normal(n), device="cuda")
    X = torch.as_tensor(rng.standard_normal((n, 3)), device="cuda")
    assert torch.equal(kt.spmv(csr, x), kt.spmv(csr, x))
    assert torch.equal(kt.spmm(csr, X), kt.spmm(csr, X))
    xc = x.to(torch.complex128) * (1 + 0.5j)
    assert torch.equal(kt.spmv(csr, xc), kt.spmv(csr, xc))
    assert _rel(kt.spmv(csr, x), csr.todense() @ x) <= 1e-12
    op = kt.CSROperator(csr)
    x1, s1 = kt.cg(op, x)
    x2, s2 = kt.cg(op, x)
    assert s1.solved and s1.niter == s2.niter
    assert torch.equal(x1, x2)


@pytest.mark.cuda
def test_slice6_solvers_on_card_take_their_kernels():
    """diom, dqgmres, bilq, qmr and bilqr on a card operator run their
    kernels; with history they take the general route through the SpMV
    kernel (and, for the two-sided methods, its adjoint)."""
    _card()
    A = kt.DIAOperator(kt.convdiff_dia(16))
    rng = np.random.default_rng(17)
    b = rng.standard_normal(16 ** 3).astype(np.float32)
    c = rng.standard_normal(16 ** 3).astype(np.float32)
    runs = [("trunc_dia", lambda **kw: kt.diom(A, b, **kw)),
            ("trunc_dia", lambda **kw: kt.dqgmres(A, b, memory=6, **kw)),
            ("bilq_dia", lambda **kw: kt.bilq(A, b, **kw)),
            ("qmr_dia", lambda **kw: kt.qmr(A, b, **kw)),
            ("bilqr_dia", lambda **kw: kt.bilqr(A, b, c, **kw))]
    for name, run in runs:
        for kw, kernel in (({}, name), ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[kernel]
            *xs, st = run(**kw)
            assert all(x.is_cuda and x.dtype == torch.float32 for x in xs)
            assert st.solved
            assert kt.kernel_launches()[kernel] > n0


def _shifted_card(N, dtype):
    """convdiff_dia(N) + 0.5 I on the card, its aligned diagonals and
    those of its adjoint, and b, c drawn from one seed."""
    A = kt.convdiff_dia(N, dtype=dtype)
    A.data[A.offsets.index(0)] += 0.5
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
    rng = np.random.default_rng(18)
    b = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    c = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    return (pd, pda, offsets_tensor(A.offsets, "cuda"),
            offsets_tensor(offa, "cuda"), b, c)


def _hold_ssy(k, r, nvec, b, tol):
    """Same status and flags, niter within ±max(2, 10%), and each
    solution to tol of max(|x|, |b|) (the scale of b, as USYMLQR's x
    holds the least-squares residual, near 0, when ls runs alone)."""
    kints = [i for v in k[nvec:] if v.dtype == torch.int32
             for i in v.reshape(-1).tolist()]
    rints = [i for v in r[nvec:] if v.dtype == torch.int32
             for i in v.reshape(-1).tolist()]
    assert kints[1:] == rints[1:]
    assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
    for v, w in zip(k[:nvec], r[:nvec]):
        scale = max(float(w.abs().max()), float(b.abs().max()))
        assert float((v - w).abs().max()) <= tol * scale


_SSY_KW = {"usymlq_lq": {"transfer_to_usymcg": False},
           "trilqr_lq": {"transfer_to_usymcg": False},
           "usymlqr_ls": {"ln": False},
           "usymlqr_ln": {"ls": False}}


def _chunk_edge_rtol(ref, args, i_rnorm):
    """An rtol at which the plain version's residual estimate first falls
    below rtol ||b|| at iteration 64, the last of the first 64-iteration
    chunk: the geometric mean of its estimates after 63 and 64
    iterations (run with no tolerance), over ||b||.  The estimates before
    it stay at least 4% above it on the shifted stencil at 15^3 to
    17^3."""
    pd, pda, ot, ota, b, c = args
    r63, r64 = (float(ref(pd, pda, ot, ota, b, c, 0.0, 0.0, j)[i_rnorm])
                for j in (63, 64))
    return (r63 * r64) ** 0.5 / float(torch.linalg.norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 15, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["usymlq", "usymlq_lq", "usymqr",
                                    "trilqr", "trilqr_lq", "usymlqr",
                                    "usymlqr_ls", "usymlqr_ln",
                                    "usymlq_zero_rhs", "usymlqr_zero_rhs",
                                    "usymqr_zero_rhs",
                                    *(f"{m}_{cap}"
                                      for m in ("usymlq", "usymqr")
                                      for cap in ("it1", "it2", "it3",
                                                  "it64", "it65", "edge"))])
def test_ssy_kernels_match_plain_on_card(kernel, dtype, N):
    """The USYMLQ, USYMQR, TriLQR and USYMLQR kernels against their plain
    versions on the N^3 convection-diffusion stencil with 0.5 on its main
    diagonal (15^3 and 17^3 end in a partial group of the R rows a
    stencil thread owns, and their odd n leaves the work rows off a
    16-byte boundary, so the stencil takes its scalar path): same status
    and flags, niter within ±max(2, 10%), x (and y) to 1e-2 of max(|x|,
    |b|) in f32 and to 1e-6 in f64 (the SSY process runs without
    reorthogonalisation, and its f64 stops move with the order of the
    sums: tests/test_torch_usym.py says how far), as chip_smoke.py holds
    them at full width.  USYMLQ and USYMQR are also capped at 1, 2, 3, 64
    and 65 iterations (no tolerance) and stopped by their tolerance at
    iteration 64, the last of a 64-iteration chunk, with niter equal:
    USYMQR's last direction and x update runs in the finishing launch,
    USYMLQ's row updates in the stencil's pass."""
    _card()
    pd, pda, ot, ota, b, c = _shifted_card(N, dtype)
    if kernel.endswith("zero_rhs"):
        b = torch.zeros_like(b)
    rtol = 1e-5 if dtype == torch.float32 else 1e-8
    name, cap = kernel.split("_")[0], kernel.split("_")[-1]
    kw = _SSY_KW.get(kernel, {})
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    itmax, niter = 2 * b.shape[0], None
    if cap.startswith("it"):
        rtol, itmax = 0.0, int(cap[2:])
        niter = itmax
    elif cap == "edge":
        rtol, niter = _chunk_edge_rtol(ref, (pd, pda, ot, ota, b, c), 2), 64
    args = (pd, pda, ot, ota, b, c, 0.0, rtol, itmax)
    before = wrapper.launches
    k = wrapper(*args, **kw)
    assert wrapper.launches > before
    r = ref(*args, **kw)
    if niter is not None:
        assert int(k[1]) == int(r[1]) == niter
    _hold_ssy(k, r, 2 if name in ("trilqr", "usymlqr") else 1,
              b, 1e-2 if dtype == torch.float32 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("kernel", ["trilqr", "usymlqr", "usymlqr_ls",
                                    "usymlq", "usymqr"])
def test_ssy_narrow_diagonals_match_plain_on_card(kernel, pdt):
    """TriLQR, USYMLQR, USYMLQ and USYMQR with bf16 and f16 diagonals (f32
    vectors; the stencil reads two 2-byte entries of a diagonal at a
    time) against their plain versions on the same diagonals at 16^3,
    held as the f32 case of test_ssy_kernels_match_plain_on_card."""
    _card()
    pd, pda, ot, ota, b, c = _shifted_card(16, torch.float32)
    pd, pda = pd.to(pdt), pda.to(pdt)
    name = kernel.split("_")[0]
    kw = _SSY_KW.get(kernel, {})
    args = (pd, pda, ot, ota, b, c, 0.0, 1e-5, 2 * b.shape[0])
    wrapper = getattr(cf, name + "_dia_fused")
    before = wrapper.launches
    k = wrapper(*args, **kw)
    assert wrapper.launches > before
    _hold_ssy(k, getattr(cf, name + "_dia_fused_ref")(*args, **kw),
              2 if name in ("trilqr", "usymlqr") else 1, b, 1e-2)


_SSY_ALL = {"usymlq": 1, "usymqr": 1, "trilqr": 2, "usymlqr": 2,
            "tricg": 2, "trimr": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", list(_SSY_ALL))
def test_ssy_scalar_path_gives_the_vector_paths_bits_on_card(kernel, dtype):
    """The six SSY kernels with diagonals one element past a 16-byte
    boundary (the stencil's scalar path) give the bits of the same solve
    on aligned diagonals (its 16-byte path): both paths sum each row's
    diagonals and the dots in one order.  16^3 convection-diffusion + 0.5
    I; TriCG and TriMR with tau = 1, nu = -1."""
    _card()
    pd, pda, ot, ota, b, c = _shifted_card(16, dtype)
    rtol = 1e-5 if dtype == torch.float32 else 1e-8
    tri = (1.0, -1.0) if kernel in ("tricg", "trimr") else ()
    wrapper = getattr(cf, kernel + "_dia_fused")
    tail = tri + (0.0, rtol, 2 * b.shape[0])
    k = wrapper(pd, pda, ot, ota, b, c, *tail)
    u = wrapper(_unaligned(pd), _unaligned(pda), ot, ota, b, c, *tail)
    for v, w in zip(k, u):
        assert torch.equal(v, w)
    assert int(k[_SSY_ALL[kernel]]) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [16, 15])
def test_ssy_stencil_matches_plain_step_on_card(N, dtype):
    """q, p and alpha of the SSY stencil and alpha launches against the
    plain SSY step (``_ssy_ref``) over the first four iterations, on the
    N^3 convection-diffusion stencil + 0.5 I: after k iterations of the
    TriLQR kernel (no tolerance, so it runs k) its work rows hold
    v_{k+1} = q / beta_{k+1} and u_{k+1} = p / gamma_{k+1}, and its
    scalars alpha_k, beta_{k+1} and gamma_{k+1}; each within 1e-5
    relative in f32 and 1e-12 in f64 of the plain step's (whose sums
    take another order)."""
    _card()
    import types
    pd, pda, ot, ota, b, c = _shifted_card(N, dtype)
    slot = _enum_values_in("ssy.cuh", "SharedSlot", {})
    rows = _enum_values_in("ssy.cuh", "Row", {})
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    one, zero = cf._scalar(1, b), cf._scalar(0, b)
    bnorm, cnorm, v1, u1 = cf._ssy_start(b, c)
    s = types.SimpleNamespace(vk=v1, uk=u1, vkm1=torch.zeros_like(b),
                              ukm1=torch.zeros_like(b), beta=bnorm,
                              gamma=cnorm, iter=cf._i32(0, b))
    for k in range(1, 5):
        q, p, alpha, beta1, gamma1 = cf._ssy_ref(pd, ot, pda, ota, s, one,
                                                 zero)
        work, sc, st = cf._ssy_fused(cf.trilqr_dia_fused, "trilqr", pd, pda,
                                     ot, ota, b, c, 0.0, 0.0, k, 11,
                                     cf._TL_NSC, cf._TL_NST, 1, False)
        assert int(st[cf._IT]) == k
        got_q = work[rows["V0"] + k % 3] * sc[slot["BETA"]]
        got_p = work[rows["U0"] + k % 3] * sc[slot["GAMMA"]]
        assert _rel(got_q, q) <= tol and _rel(got_p, p) <= tol
        assert abs(float(sc[slot["ALPHA"]] - alpha)) <= \
            tol * max(abs(float(alpha)), 1.0)
        vk1, uk1 = cf._ssy_next(q, p, beta1, gamma1, s.vk, s.uk, one)
        s = types.SimpleNamespace(vk=vk1, uk=uk1, vkm1=s.vk, ukm1=s.uk,
                                  beta=beta1, gamma=gamma1, iter=s.iter + 1)


@pytest.mark.cuda
def test_ssy_solvers_on_card_take_their_kernels():
    """usymlq, usymqr, trilqr and usymlqr on a card operator run their
    kernels; with history they take the general route through the SpMV
    kernel and its adjoint."""
    _card()
    A = kt.convdiff_dia(16)
    A.data[A.offsets.index(0)] += 0.5
    A = kt.DIAOperator(A)
    rng = np.random.default_rng(19)
    b = rng.standard_normal(16 ** 3).astype(np.float32)
    c = rng.standard_normal(16 ** 3).astype(np.float32)
    for method in ("usymlq", "usymqr", "trilqr", "usymlqr"):
        for kw, kernel in (({}, method + "_dia"),
                           ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[kernel]
            *xs, st = getattr(kt, method)(A, b, c, **kw)
            assert all(x.is_cuda and x.dtype == torch.float32 for x in xs)
            assert st.solved or st.inconsistent
            assert kt.kernel_launches()[kernel] > n0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["lsqr", "lsqr_lam", "lsmr", "lsmr_lam",
                                    "lsmr_window12", "lslq", "lslq_sigma",
                                    "lslq_transfer", "lsqr_zero_rhs",
                                    "lslq_zero_rhs"])
def test_gk_kernels_match_plain_on_card(kernel, dtype):
    """The LSQR, LSMR and LSLQ kernels against their plain versions on the
    16^3 convection-diffusion stencil with 0.5 on its main diagonal, at
    the default tolerances: same status and flags, niter within
    ±max(2, 10%), x to 1e-2 of max(|x|, |b|) in f32 and to 1e-6 in f64
    (Golub–Kahan runs without reorthogonalisation, and its f64 stops move
    with the order of the sums: tests/test_torch_ls.py says how far), as
    chip_smoke.py holds them at full width; with λ = 0.1, a window of 12,
    σ = 0.1, the LSQR transfer and b = 0."""
    _card()
    pd, pda, ot, ota, b, _ = _shifted_card(16, dtype)
    if kernel.endswith("zero_rhs"):
        b = torch.zeros_like(b)
    name = kernel.split("_")[0]
    tol = float(np.sqrt(np.finfo(np.float32 if dtype == torch.float32
                                 else np.float64).eps))
    lam = 0.1 if kernel.endswith("lam") else 0.0
    window = 12 if kernel.endswith("window12") else 5
    if name == "lslq":
        args = (lam, 0.1 if kernel.endswith("sigma") else 0.0, tol, tol, tol,
                tol, tol, 1e8, 2 * b.shape[0])
        kw = {"use_sigma": kernel.endswith("sigma"),
              "transfer_to_lsqr": kernel.endswith("transfer"),
              "window": window}
    else:
        args = (lam, tol, tol, 0.0, 0.0, tol, 1e8, 2 * b.shape[0])
        kw = {"window": window}
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    before = wrapper.launches
    k = wrapper(pd, pda, ot, ota, b, *args, **kw)
    assert wrapper.launches > before
    r = ref(pd, pda, ot, ota, b, *args, **kw)
    kints = [int(v) for v in k[1:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[1:] if v.dtype == torch.int32]
    assert kints[1:] == rints[1:]
    assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
    tol_x = 1e-2 if dtype == torch.float32 else 1e-6
    scale = max(float(r[0].abs().max()), float(b.abs().max()))
    assert float((k[0] - r[0]).abs().max()) <= tol_x * scale


@pytest.mark.cuda
def test_gk_solvers_on_card_take_their_kernels():
    """lsqr, lsmr and lslq on a card operator run their kernels; with
    history they take the general route through the SpMV kernel and its
    adjoint."""
    _card()
    A = kt.convdiff_dia(16)
    A.data[A.offsets.index(0)] += 0.5
    A = kt.DIAOperator(A)
    b = np.random.default_rng(20).standard_normal(16 ** 3).astype(
        np.float32)
    for method in ("lsqr", "lsmr", "lslq"):
        for kw, kernel in (({}, method + "_dia"),
                           ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[kernel]
            x, st = getattr(kt, method)(A, b, **kw)
            assert x.is_cuda and x.dtype == torch.float32
            assert st.solved
            assert kt.kernel_launches()[kernel] > n0


# the least-norm kernels' cases: (kernel, λ, keyword arguments)
LN_CASES = {"craig": ("craig", 0.0, {}),
            "craig_lam": ("craig", 0.3, {"use_lam": True}),
            "craigmr": ("craigmr", 0.0, {}),
            "craigmr_lam": ("craigmr", 0.3, {"use_lam": True}),
            "lnlq": ("lnlq", 0.0, {}),
            "lnlq_lam": ("lnlq", 0.3, {"use_lam": True}),
            "lnlq_no_transfer": ("lnlq", 0.0, {"transfer_to_craig": False}),
            "cgne": ("cgne_crmr", 0.0, {"variant": "cgne"}),
            "cgne_lam": ("cgne_crmr", 0.3, {"variant": "cgne"}),
            "crmr": ("cgne_crmr", 0.0, {"variant": "crmr"}),
            "crmr_lam": ("cgne_crmr", 0.3, {"variant": "crmr"})}


def ln_args(name, lam, dtype, n):
    """The arguments after (pd, pd_adj, offsets, offsets_adj, b) of a
    least-norm kernel at the entry points' defaults: √eps for atol, rtol
    (and CRAIG's btol), conlim 1e8, itmax m + n."""
    tol = float(np.sqrt(np.finfo(np.float32 if dtype == torch.float32
                                 else np.float64).eps))
    if name == "craig":
        return (lam, tol, tol, tol, 1e8, 2 * n)
    return (lam, tol, tol, 2 * n)


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(64, torch.float64),
                                     (128, torch.float32)],
                         ids=["64-f64", "128-f32"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
@pytest.mark.parametrize("case", sorted(LN_CASES))
def test_ln_kernels_match_plain_on_card(case, rhs, N, dtype):
    """The CRAIG, CRAIGMR, LNLQ and CGNE/CRMR kernels against their plain
    versions on the convection-diffusion stencil with 0.5 on its main
    diagonal, at 64^3 f64 and 128^3 f32, with λ = 0.3, LNLQ without the
    transfer, and b = 0: the same status (and every int output), niter
    within ±max(2, 10%); in f64 x (and y) within 1e-6 of max(|x|, |b|)
    (Golub–Kahan and CG on AAᴴ run without reorthogonalisation, and
    their f64 iterates follow the order of the sums: tests/test_torch_ln.py
    says how far); in f32 the true residual ‖b − Ax‖ (f64, the plain SpMV)
    no worse than 1.5 times the plain version's, as chip_smoke.py holds
    them."""
    _card()
    pd, pda, ot, ota, b, _ = _shifted_card(N, dtype)
    if rhs == "zero_b":
        b = torch.zeros_like(b)
    name, lam, kw = LN_CASES[case]
    args = ln_args(name, lam, dtype, b.shape[0])
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    before = wrapper.launches
    k = wrapper(pd, pda, ot, ota, b, *args, **kw)
    assert wrapper.launches > before
    r = ref(pd, pda, ot, ota, b, *args, **kw)
    nvec = 1 if name == "cgne_crmr" else 2
    kints = [int(v) for v in k[nvec:] if v.dtype == torch.int32]
    rints = [int(v) for v in r[nvec:] if v.dtype == torch.int32]
    assert kints[1:] == rints[1:]
    assert abs(kints[0] - rints[0]) <= max(2, 0.1 * rints[0])
    if rhs == "zero_b":
        assert kints == [0, rt.ZERO_RESIDUAL]
        assert not any(bool(v.any()) for v in k[:nvec])
        return
    if dtype == torch.float64:
        for v, w in zip(k[:nvec], r[:nvec]):
            scale = max(float(w.abs().max()), float(b.abs().max()))
            assert float((v - w).abs().max()) <= 1e-6 * scale
        return

    def true_res(x):
        res = b.double() - dia_spmv_aligned_ref(pd.double(), ot, x.double())
        return float(res.norm() / b.double().norm())

    assert true_res(k[0]) <= 1.5 * true_res(r[0])


@pytest.mark.cuda
def test_ln_solvers_on_card_take_their_kernels():
    """craig, craigmr, lnlq, cgne and crmr on a card operator run their
    kernels; with history they take the general route through the SpMV
    kernel and its adjoint; LNLQ's kernel route returns SimpleStats and
    its general route LNLQStats, as the JAX package's do."""
    _card()
    A = kt.convdiff_dia(16)
    A.data[A.offsets.index(0)] += 0.5
    A = kt.DIAOperator(A)
    b = np.random.default_rng(21).standard_normal(16 ** 3).astype(
        np.float32)
    kernels = {"craig": "craig_dia", "craigmr": "craigmr_dia",
               "lnlq": "lnlq_dia", "cgne": "cgne_crmr_dia",
               "crmr": "cgne_crmr_dia"}
    for method, kernel in kernels.items():
        for kw, used in (({}, kernel), ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[used]
            *xs, st = getattr(kt, method)(A, b, **kw)
            assert all(x.is_cuda and x.dtype == torch.float32 for x in xs)
            assert st.solved
            assert kt.kernel_launches()[used] > n0
            if method == "lnlq":
                assert type(st) is (kt.LNLQStats if kw else kt.SimpleStats)


# the normal-equation kernels' cases: (kernel, λ or the shifts)
NQ_CASES = {"cgls": ("cgls", 0.0), "cgls_lam": ("cgls", 0.1),
            "crls": ("crls", 0.0), "crls_lam": ("crls", 0.1),
            "shift": ("cgls_lanczos_shift", [0.1, 1.0]),
            "shift_zero": ("cgls_lanczos_shift", [0.0, 4.0])}


def _card_system(N, dtype, poisson=False):
    """convdiff_dia(N) (or poisson_dia(N)) on the card, its aligned
    diagonals and those of its adjoint, and b, c drawn from one seed."""
    A = (kt.poisson_dia if poisson else kt.convdiff_dia)(N, dtype=dtype)
    n = A.shape[0]
    pd = dia_align(A.data, A.offsets, n)
    pda, offa = kt.dia_align_adjoint(pd, A.offsets, n)
    rng = np.random.default_rng(22)
    b = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    c = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    return (pd, pda, offsets_tensor(A.offsets, "cuda"),
            offsets_tensor(offa, "cuda"), b, c)


def _tol(dtype):
    return float(np.sqrt(np.finfo(np.float32 if dtype == torch.float32
                                  else np.float64).eps))


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(64, torch.float64),
                                     (128, torch.float32)],
                         ids=["64-f64", "128-f32"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
@pytest.mark.parametrize("case", sorted(NQ_CASES))
def test_nq_kernels_match_plain_on_card(case, rhs, N, dtype):
    """The CGLS, CRLS and CGLS-Lanczos-shift kernels against their plain
    versions on the convection-diffusion stencil at 64^3 f64 and 128^3
    f32, at the default tolerances, with λ = 0.1, two shifts (one of
    them 0) and b = 0: the same status (and indefinite flags), niter
    within ±max(2, 10%); in f64 x within 1e-6 of max(|x|, |b|) (CG on AᴴA
    runs without reorthogonalisation and its f64 iterates follow the
    order of the sums: tests/test_torch_cgls.py says how far); in f32 the
    true normal-equation residual ‖Aᴴ(b − Ax) − λx‖ (f64, the plain SpMV)
    no worse than 1.5 times the plain version's."""
    _card()
    pd, pda, ot, ota, b, _ = _card_system(N, dtype)
    if rhs == "zero_b":
        b = torch.zeros_like(b)
    name, lam = NQ_CASES[case]
    tol = _tol(dtype)
    shifted = name == "cgls_lanczos_shift"
    if shifted:
        lam = torch.tensor(lam, dtype=dtype, device="cuda")
    args = (lam, tol, tol, 2 * b.shape[0])
    wrapper = getattr(cf, name + "_dia_fused")
    ref = getattr(cf, name + "_dia_fused_ref")
    before = wrapper.launches
    k = wrapper(pd, pda, ot, ota, b, *args)
    assert wrapper.launches > before
    r = ref(pd, pda, ot, ota, b, *args)
    it_k, it_r = int(k[1]), int(r[1])
    code = 3 if shifted else 4
    assert int(k[code]) == int(r[code])
    assert abs(it_k - it_r) <= max(2, 0.1 * it_r)
    if shifted:
        assert torch.equal(k[4], r[4])
    if rhs == "zero_b":
        assert it_k == 0 and int(k[code]) == rt.ZERO_RESIDUAL
        assert not bool(k[0].any())
        return
    if dtype == torch.float64:
        scale = max(float(r[0].abs().max()), float(b.abs().max()))
        assert float((k[0] - r[0]).abs().max()) <= 1e-6 * scale
        return
    lams = lam.tolist() if shifted else [lam]
    X_k, X_r = (k[0], r[0]) if shifted else (k[0][None], r[0][None])

    def ne_res(x, lam_i):
        x = x.double()
        res = b.double() - dia_spmv_aligned_ref(pd.double(), ot, x)
        g = dia_spmv_aligned_ref(pda.double(), ota, res) - lam_i * x
        return float(g.norm())

    for i, lam_i in enumerate(lams):
        assert ne_res(X_k[i], lam_i) <= 1.5 * ne_res(X_r[i], lam_i) + 1e-30


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(64, torch.float64),
                                     (128, torch.float32)],
                         ids=["64-f64", "128-f32"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
@pytest.mark.parametrize("tau,nu", [(1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)],
                         ids=["default", "spd", "flip"])
def test_tricg_kernel_matches_plain_on_card(tau, nu, rhs, N, dtype):
    """The TriCG kernel against its plain version on the Poisson stencil
    at 64^3 f64 and 128^3 f32, at the default tolerances, under the
    default, spd and flip (τ, ν), and with b = c = 0 (spd's [I A; A I] is
    indefinite for this stencil, 48274 iterations at 64^3 in f64, so it
    runs 200 iterations and is held to that trajectory): the same status,
    niter within ±max(3, 10%) (the stop moves by 1 to 3 iterations near
    the threshold, tests/test_fused.py:1145-1149); in f64 x and y within
    1e-6 of max(|v|, |b|); in f32 the true block residual (f64, the plain
    SpMV) no worse than 1.5 times the plain version's."""
    _card()
    pd, pda, ot, ota, b, c = _card_system(N, dtype, poisson=True)
    if rhs == "zero_b":
        b, c = torch.zeros_like(b), torch.zeros_like(c)
    tol = _tol(dtype)
    itmax = 200 if (tau, nu) == (1.0, 1.0) else 2 * b.shape[0]
    args = (tau, nu, tol, tol, itmax)
    before = cf.tricg_dia_fused.launches
    k = cf.tricg_dia_fused(pd, pda, ot, ota, b, c, *args)
    assert cf.tricg_dia_fused.launches > before
    r = cf.tricg_dia_fused_ref(pd, pda, ot, ota, b, c, *args)
    assert int(k[4]) == int(r[4])
    assert abs(int(k[2]) - int(r[2])) <= max(3, 0.1 * int(r[2]))
    if rhs == "zero_b":
        assert int(k[2]) == 0 and int(k[4]) == rt.ZERO_RESIDUAL
        assert not bool(k[0].any()) and not bool(k[1].any())
        return
    if dtype == torch.float64:
        for v, w in zip(k[:2], r[:2]):
            scale = max(float(w.abs().max()), float(b.abs().max()))
            assert float((v - w).abs().max()) <= 1e-6 * scale
        return

    def block_res(x, y):
        x, y = x.double(), y.double()
        top = b.double() - (tau * x + dia_spmv_aligned_ref(pd.double(), ot,
                                                           y))
        bot = c.double() - (dia_spmv_aligned_ref(pda.double(), ota, x)
                            + nu * y)
        return float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))

    assert block_res(k[0], k[1]) <= 1.5 * block_res(r[0], r[1])


@pytest.mark.cuda
def test_nq_and_tricg_solvers_on_card_take_their_kernels():
    """cgls, crls, cgls_lanczos_shift and tricg on a card operator run
    their kernels; with history they take the general route through the
    SpMV kernel and its adjoint."""
    _card()
    A = kt.DIAOperator(kt.convdiff_dia(16))
    P = kt.DIAOperator(kt.poisson_dia(16))
    rng = np.random.default_rng(23)
    b = rng.standard_normal(16 ** 3).astype(np.float32)
    c = rng.standard_normal(16 ** 3).astype(np.float32)
    runs = {"cgls": (A, (b,), "cgls_dia"), "crls": (A, (b,), "crls_dia"),
            "cgls_lanczos_shift": (A, (b, [0.1, 1.0]),
                                   "cgls_lanczos_shift_dia"),
            "tricg": (P, (b, c), "tricg_dia")}
    for method, (op, args, kernel) in runs.items():
        for kw, used in (({}, kernel), ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[used]
            *xs, st = getattr(kt, method)(op, *args, **kw)
            assert all(x.is_cuda and x.dtype == torch.float32 for x in xs)
            assert st.solved
            assert kt.kernel_launches()[used] > n0


def _scaled_poisson_pair(N, dtype):
    """K = 0.1 (P + I) on the card (tools/exp_fused_all_tpu.py:72-85) and
    Kᴴ from ``adjoint_dia()``, both DIA operators, with their aligned
    diagonals and offsets."""
    P = kt.poisson_dia(N, dtype=dtype)
    P.data[P.offsets.index(0)] += 1.0
    K = kt.DIAOperator(kt.DIAMatrix(0.1 * P.data, P.offsets, P.shape))
    data, offs = K.adjoint_dia()
    KH = kt.DIAOperator(kt.DIAMatrix(data, offs, P.shape))
    return K, KH


def _shifted_poisson(N, dtype, shift):
    P = kt.poisson_dia(N, dtype=dtype)
    P.data[P.offsets.index(0)] += shift
    return kt.DIAOperator(P)


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(64, torch.float64),
                                     (128, torch.float32)],
                         ids=["64-f64", "128-f32"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
@pytest.mark.parametrize("tau,nu", [(1.0, -1.0), (-1.0, 1.0)],
                         ids=["default", "flip"])
def test_trimr_kernel_matches_plain_on_card(tau, nu, rhs, N, dtype):
    """The TriMR kernel against its plain version on the Poisson stencil at
    64^3 f64 and 128^3 f32, at the default tolerances, under the default
    and flip (τ, ν), and with b = c = 0: the same status, niter within
    ±max(3, 10%) (tests/test_fused.py:1145-1149); in f64 x and y within
    1e-6 of max(|v|, |b|); in f32 the true block residual (f64, the plain
    SpMV) no worse than 1.5 times the plain version's."""
    _card()
    pd, pda, ot, ota, b, c = _card_system(N, dtype, poisson=True)
    if rhs == "zero_b":
        b, c = torch.zeros_like(b), torch.zeros_like(c)
    tol = _tol(dtype)
    args = (tau, nu, tol, tol, 2 * b.shape[0])
    before = cf.trimr_dia_fused.launches
    k = cf.trimr_dia_fused(pd, pda, ot, ota, b, c, *args)
    assert cf.trimr_dia_fused.launches > before
    r = cf.trimr_dia_fused_ref(pd, pda, ot, ota, b, c, *args)
    assert int(k[4]) == int(r[4])
    assert abs(int(k[2]) - int(r[2])) <= max(3, 0.1 * int(r[2]))
    if rhs == "zero_b":
        assert int(k[2]) == 0 and int(k[4]) == rt.ZERO_RESIDUAL
        assert not bool(k[0].any()) and not bool(k[1].any())
        return
    if dtype == torch.float64:
        for v, w in zip(k[:2], r[:2]):
            scale = max(float(w.abs().max()), float(b.abs().max()))
            assert float((v - w).abs().max()) <= 1e-6 * scale
        return

    def block_res(x, y):
        x, y = x.double(), y.double()
        top = b.double() - (tau * x + dia_spmv_aligned_ref(pd.double(), ot,
                                                           y))
        bot = c.double() - (dia_spmv_aligned_ref(pda.double(), ota, x)
                            + nu * y)
        return float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))

    assert block_res(k[0], k[1]) <= 1.5 * block_res(r[0], r[1])


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype", [(64, torch.float64),
                                     (128, torch.float32)],
                         ids=["64-f64", "128-f32"])
@pytest.mark.parametrize("rhs", ["b", "zero_b"])
def test_gpmr_kernel_matches_plain_on_card(rhs, N, dtype):
    """The GPMR kernel against its plain version on K = 0.1 (P + I) and
    Kᴴ (the JAX package's cell) at 64^3 f64 and 128^3 f32, λ = 1, μ = −1,
    memory 48, at the default tolerances, and with b = c = 0: the same
    status and flag, niter within ±1 (tests/test_fused.py:1514); in f64 x
    and y within 1e-6 of max(|v|, |b|); in f32 the true stacked residual
    no worse than 1.5 times the plain version's."""
    _card()
    K, KH = _scaled_poisson_pair(N, dtype)
    rng = np.random.default_rng(22)
    n = K.shape[0]
    b = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    c = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    if rhs == "zero_b":
        b, c = torch.zeros_like(b), torch.zeros_like(c)
    tol = _tol(dtype)
    args = (K._pd, KH._pd, K._offsets, KH._offsets, b, c, 1.0, -1.0, tol,
            tol, 48)
    before = cf.gpmr_dia_fused.launches
    k = cf.gpmr_dia_fused(*args, mem=48)
    assert cf.gpmr_dia_fused.launches > before
    r = cf.gpmr_dia_fused_ref(*args, mem=48)
    assert (int(k[4]), int(k[5])) == (int(r[4]), int(r[5]))
    assert abs(int(k[2]) - int(r[2])) <= 1
    if rhs == "zero_b":
        assert int(k[2]) == 0 and int(k[4]) == rt.ZERO_RESIDUAL
        assert not bool(k[0].any()) and not bool(k[1].any())
        return
    if dtype == torch.float64:
        for v, w in zip(k[:2], r[:2]):
            scale = max(float(w.abs().max()), float(b.abs().max()))
            assert float((v - w).abs().max()) <= 1e-6 * scale
        return

    def stacked(x, y):
        x, y = x.double(), y.double()
        top = b.double() - (x + dia_spmv_aligned_ref(K._pd.double(),
                                                     K._offsets, y))
        bot = c.double() - (dia_spmv_aligned_ref(KH._pd.double(),
                                                 KH._offsets, x) - y)
        return float(torch.sqrt(top.norm() ** 2 + bot.norm() ** 2))

    assert stacked(k[0], k[1]) <= 1.5 * stacked(r[0], r[1])


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype,shift", [(64, torch.float64, 0.5),
                                           (64, torch.float64, -1.5),
                                           (128, torch.float32, 0.5)],
                         ids=["64-f64", "64-f64-indefinite", "128-f32"])
@pytest.mark.parametrize("p", [1, 4, 8])
def test_block_minres_kernel_matches_plain_on_card(p, N, dtype, shift):
    """The block MINRES kernel against its plain version on P + 0.5 I
    (bench.py:485-497) at 64^3 f64 and 128^3 f32, and on the indefinite
    P − 1.5 I at 64^3 f64 (tests/test_fused.py:335-348), B seeded normal
    with p columns, at the default tolerances: the same status, niter
    within ±2 (tests/test_fused.py:345); in f64 X within 1e-6 of
    max(|X|, |B|); in f32 ‖B − AX‖_F (f64, the plain SpMV) no worse than
    1.5 times the plain version's.  The indefinite system converges
    slowly at 64^3 (the plain version's ‖Φbar‖ is still 1.2e-2 ‖B‖ after
    3000 iterations with p = 4), so it runs 200 iterations and is held to
    that trajectory, as TriCG's indefinite preset is."""
    _card()
    A = _shifted_poisson(N, dtype, shift)
    n = A.shape[0]
    B = torch.as_tensor(np.random.default_rng(24).standard_normal(
        (n, p))).to("cuda", dtype)
    tol = _tol(dtype)
    itmax = 200 if shift < 0 else 2 * (n // p)
    args = (A._pd, A._offsets, B, tol, tol, itmax)
    before = cf.block_minres_dia_fused.launches
    k = cf.block_minres_dia_fused(*args)
    assert cf.block_minres_dia_fused.launches > before
    r = cf.block_minres_dia_fused_ref(*args)
    want = rt.RUNNING if shift < 0 else rt.SOLVED
    assert int(k[3]) == int(r[3]) == want
    assert abs(int(k[1]) - int(r[1])) <= 2
    if dtype == torch.float64:
        scale = max(float(r[0].abs().max()), float(B.abs().max()))
        assert float((k[0] - r[0]).abs().max()) <= 1e-6 * scale
        return

    def res(X):
        X = X.double()
        AX = torch.stack([dia_spmv_aligned_ref(A._pd.double(), A._offsets,
                                               X[:, j].contiguous())
                          for j in range(p)], 1)
        return float((B.double() - AX).norm())

    assert res(k[0]) <= 1.5 * res(r[0])


@pytest.mark.cuda
def test_slice11_solvers_on_card_take_their_kernels():
    """trimr, gpmr (K and Kᴴ, memory 48) and block_minres on card
    operators run their kernels; with history they take the general route
    through the SpMV kernel; a rank-1 block takes block MINRES's general
    route."""
    _card()
    P = kt.DIAOperator(kt.poisson_dia(16))
    K, KH = _scaled_poisson_pair(16, torch.float32)
    Ps = _shifted_poisson(16, torch.float32, 0.5)
    rng = np.random.default_rng(23)
    b = rng.standard_normal(16 ** 3).astype(np.float32)
    c = rng.standard_normal(16 ** 3).astype(np.float32)
    B = rng.standard_normal((16 ** 3, 4)).astype(np.float32)
    runs = {"trimr": ((P, b, c), {}, "trimr_dia"),
            "gpmr": ((K, KH, b, c), {"lam": 1.0, "mu": -1.0, "memory": 48,
                                     "itmax": 48}, "gpmr_dia"),
            "block_minres": ((Ps, B), {}, "block_minres_dia")}
    for method, (args, kw, kernel) in runs.items():
        for extra, used in (({}, kernel), ({"history": True}, "dia_spmv")):
            n0 = kt.kernel_launches()[used]
            *xs, st = getattr(kt, method)(*args, **kw, **extra)
            assert all(x.is_cuda and x.dtype == torch.float32 for x in xs)
            assert st.solved
            assert kt.kernel_launches()[used] > n0
    n0 = kt.kernel_launches()["block_minres_dia"]
    B1 = np.tile(B[:, :1], (1, 4))
    assert kt.block_minres(Ps, B1)[1].solved
    assert kt.kernel_launches()["block_minres_dia"] == n0


@pytest.mark.parametrize("mem,p", [(2, 1), (32, 4), (16, 8)])
def test_block_gmres_wrapper_layout_matches_kernel(mem, p):
    """The block GMRES wrapper's slots and sizes (``_bg_layout``) are the
    kernel's enums and ``struct Layout``; the largest mem·p and the rows
    per thread are the header's."""
    got = _layout_offsets("block_gmres.cuh", mem=mem, p=p)
    nsc, npart = cf._bg_layout(mem, p)
    assert got["size"] == nsc and got["NSC"] == cf._BG_NSC
    assert (got["RNORM"], got["INCONS"], got["NPASS"], got["NST"]) == (
        cf._BG_RNORM, cf._BG_INCONS, cf._BG_NPASS, cf._BG_NST)
    assert (got["ATOL"], got["RTOL"], got["BTOL"], got["IT"],
            got["STATUS"]) == (0, 1, 2, cf._IT, cf._STATUS)
    assert npart == mem * p * p
    text = (ROOT / "krylov_tpu_torch" / "csrc" / "block_gmres.cuh"
            ).read_text()
    assert f"kMaxMP = {cf._BG_MAXMP};" in text
    assert f"kRows = {cf._BG_ROWS};" in text


# block GMRES on P + 0.5 I (bench.py:483-497): (N, dtype, p, memory,
# basis type, rtol); None is the default tolerance
BG_CARD_CASES = [
    (32, torch.float64, 4, 8, None, 1e-8),
    (32, torch.float64, 1, 16, None, None),
    (32, torch.float64, 8, 16, None, None),
    (32, torch.float32, 4, 32, None, None),
    (32, torch.float32, 3, 12, torch.bfloat16, 1e-5),
    (32, torch.float64, 4, 8, torch.bfloat16, 1e-6),
    (128, torch.float32, 4, 32, None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,dtype,p,mem,basis,rtol", BG_CARD_CASES,
                         ids=[f"{c[0]}-{str(c[1])[6:]}-p{c[2]}-m{c[3]}"
                              f"{'-bf16' if c[4] else ''}"
                              for c in BG_CARD_CASES])
def test_block_gmres_kernel_matches_plain_on_card(N, dtype, p, mem, basis,
                                                  rtol):
    """The block GMRES kernel against its plain version, B seeded normal:
    the same status and inconsistent flag, niter and the pass count
    within ±2 (the two sum the CGS dots and the back substitution in
    other orders; tests/test_fused.py:220); in f64 with an f64 basis X
    within 1e-6 of max(|X|, |B|); otherwise ‖B − AX‖_F (f64, the plain
    SpMV) no worse than 1.5 times the plain version's."""
    _card()
    A = _shifted_poisson(N, dtype, 0.5)
    n = A.shape[0]
    B = torch.as_tensor(np.random.default_rng(25).standard_normal(
        (n, p))).to("cuda", dtype)
    tol = _tol(dtype)
    args = (A._pd, A._offsets, B, tol, tol if rtol is None else rtol,
            2 * (n // p), mem, basis)
    before = cf.block_gmres_dia_fused.launches
    k = cf.block_gmres_dia_fused(*args)
    assert cf.block_gmres_dia_fused.launches > before
    r = cf.block_gmres_dia_fused_ref(*args)
    assert int(k[3]) == int(r[3]) == rt.SOLVED
    assert int(k[4]) == int(r[4])
    assert abs(int(k[1]) - int(r[1])) <= 2
    assert abs(int(k[5]) - int(r[5])) <= 2
    if dtype == torch.float64 and basis is None:
        scale = max(float(r[0].abs().max()), float(B.abs().max()))
        assert float((k[0] - r[0]).abs().max()) <= 1e-6 * scale
        return

    def res(X):
        X = X.double()
        AX = torch.stack([dia_spmv_aligned_ref(A._pd.double(), A._offsets,
                                               X[:, j].contiguous())
                          for j in range(p)], 1)
        return float((B.double() - AX).norm())

    assert res(k[0]) <= 1.5 * res(r[0])


def _bell_operands(dtype, bs, nb, m, n, seed=26):
    """A random BELL of nb block rows, m × n (ragged edges): 4 slots, so
    that the kernel's ring of two stages takes a second slab into each
    stage, block columns i, i + 1, i + 2 and i + 3 (modulo the block
    columns, so a few block columns repeat in a row), slot 2 of the last
    row a padding slot."""
    rng = np.random.default_rng(seed)
    nbc = -(-n // bs)
    data = rng.standard_normal((nb, 4, bs, bs)) / bs
    idx = (np.arange(nb)[:, None] + np.arange(4)) % nbc
    data[-1, 2] = 0.0
    idx[-1, 2] = 0
    if dtype.is_complex:
        data = data * (1.0 + 0.5j)
    A = kt.BELLMatrix(torch.as_tensor(data).to("cuda", dtype),
                      torch.as_tensor(idx.astype(np.int32), device="cuda"),
                      (m, n), bs)
    return A, rng


def _misaligned(X):
    """A contiguous copy of X that starts one element past an allocation,
    so that its address is off a 16-byte boundary for elements narrower
    than 16 bytes."""
    buf = torch.empty(X.numel() + 1, dtype=X.dtype, device=X.device)
    return buf[1:].view(X.shape).copy_(X)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5), (torch.float64, 1e-12), (torch.bfloat16, 2e-2),
    (torch.float16, 2e-3), (torch.complex64, 1e-5),
    (torch.complex128, 1e-12)], ids=lambda v: str(v).replace("torch.", ""))
@pytest.mark.parametrize("bs,nb,m,n", [
    (6, 7, 40, 39), (8, 7, 53, 50), (24, 9, 210, 200), (128, 5, 640, 600),
    (128, 1100, 140750, 140700)])
def test_bell_kernels_match_plain_on_card(dtype, tol, bs, nb, m, n):
    """bell_spmv and bell_spmm against their plain versions on the same
    blocks, every variant of the kernel: blocks of 6 (rows of f32, bf16
    and f16 not whole 16-byte words: element copies), 8, 24 and 128;
    ragged m and n; p = 1, 2, 3, 4, 5, 8, 9 and 130 (tiles of 1, 2, 4 and
    8 columns, x's segment one run or gathered); x as a view off a
    16-byte boundary (element copies); 5 block rows, which leave SMs
    idle, and 1100, several waves; 4 slots per block row, so that every
    variant writes each stage of its ring twice, one of them a padding
    slot.  max |Δ| ≤ tol · max|y|, tol a few ulps
    of the accumulation type summed over a block row (f32 for f32, bf16
    and f16, whose outputs round to one ulp of the narrow type)."""
    _card()
    A, rng = _bell_operands(dtype, bs, nb, m, n)
    x = torch.as_tensor(rng.standard_normal(n)).to("cuda", dtype)
    y_r = cspmv.bell_spmv_ref(A, x)
    n0 = kt.bell_spmv.launches
    y = kt.bell_spmv(A, x)
    assert kt.bell_spmv.launches == n0 + 1 and y.shape == (m,)
    assert _rel(y, y_r) <= tol
    xm = _misaligned(x)
    assert xm.data_ptr() % 16 != 0 or x.element_size() == 16
    assert _rel(kt.bell_spmv(A, xm), y_r) <= tol
    for p in (1, 2, 3, 4, 5, 8, 9, 130):
        X = torch.as_tensor(rng.standard_normal((n, p))).to("cuda", dtype)
        Y_r = cspmv.bell_spmm_ref(A, X)
        n0 = kt.bell_spmm.launches
        Y = kt.bell_spmm(A, X)
        assert kt.bell_spmm.launches == n0 + 1 and Y.shape == (m, p)
        assert _rel(Y, Y_r) <= tol
        if p in (1, 4, 9):
            assert _rel(kt.bell_spmm(A, _misaligned(X)), Y_r) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.complex128],
                         ids=lambda v: str(v).replace("torch.", ""))
def test_bell_kernels_give_the_same_bits_twice(dtype):
    """Each output is summed in a fixed order (one tree of partial sums),
    so two runs of a product give equal bits, and BELLOperator's bound
    plan gives the public wrappers' bits with one launch per product, a
    strided panel too."""
    _card()
    A = _bell_tridiagonal(96, 128, dtype, 30)
    op = kt.BELLOperator(A)
    rng = np.random.default_rng(31)
    for p in (1, 4, 8, 130):
        X = torch.as_tensor(rng.standard_normal(
            (A.shape[1], p) if p > 1 else A.shape[1])).to("cuda", dtype)
        call = kt.bell_spmv if p == 1 else kt.bell_spmm
        name = "bell_spmv" if p == 1 else "bell_spmm"
        Y1, Y2 = call(A, X), call(A, X)
        n0 = kt.kernel_launches()[name]
        Y3 = op.matvec(X) if p == 1 else op.matmat(X)
        Y4 = op.matvec(X) if p == 1 else op.matmat(X)
        assert kt.kernel_launches()[name] == n0 + 2
        for Y in (Y2, Y3, Y4):
            assert torch.equal(Y1, Y)
        if p > 1:
            wide = torch.cat([X, X], 1)
            assert torch.equal(op.matmat(wide[:, p:]), Y1)


@pytest.mark.cuda
def test_bell_kernels_raise_for_other_pairs():
    _card()
    A, rng = _bell_operands(torch.float32, 8, 3, 24, 24)
    with pytest.raises(ValueError, match="no BELL spmv kernel"):
        kt.bell_spmv(A, torch.ones(24, dtype=torch.float64, device="cuda"))
    with pytest.raises(ValueError, match="no BELL spmm kernel"):
        kt.bell_spmm(A, torch.ones((24, 2), dtype=torch.float64,
                                   device="cuda"))


def _bell_tridiagonal(nb, bs, dtype, seed):
    """The SPD block-tridiagonal BELL of tests/test_pallas_spmv.py:184-203
    (nb block rows of bs), built on the card."""
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.standard_normal((nb, bs, bs)) / bs)
    diag = M @ M.transpose(1, 2) + 2 * torch.eye(bs, dtype=M.dtype)
    off = torch.as_tensor(rng.standard_normal((bs, bs)) / (4 * bs))
    i = np.arange(nb)
    idx = np.stack([np.maximum(i - 1, 0), i, np.minimum(i + 1, nb - 1)], 1)
    data = torch.zeros((nb, 3, bs, bs), dtype=torch.float64)
    for k in range(3):
        j = torch.as_tensor(idx[:, k])
        it = torch.as_tensor(i)
        data[:, k] += torch.where((j == it)[:, None, None], diag, 0.0)
        data[:, k] += torch.where((j == it - 1)[:, None, None], off, 0.0)
        data[:, k] += torch.where((j == it + 1)[:, None, None], off.T, 0.0)
    return kt.BELLMatrix(data.to("cuda", dtype),
                         torch.as_tensor(idx.astype(np.int32),
                                         device="cuda"),
                         (nb * bs, nb * bs), bs)


@pytest.mark.cuda
def test_slice12_solvers_on_card_take_their_kernels():
    """block_gmres on a card DIA operator runs its kernel (restarting at
    memory 8), with history the general route through the SpMV kernel,
    and a rank-1 block the general route; on the block-tridiagonal BELL
    operator cg runs bell_spmv, block_gmres and block_minres bell_spmm
    through matmat."""
    _card()
    Ps = _shifted_poisson(16, torch.float32, 0.5)
    rng = np.random.default_rng(27)
    B = rng.standard_normal((16 ** 3, 4)).astype(np.float32)
    for extra, used in (({}, "block_gmres_dia"),
                        ({"history": True}, "dia_spmv")):
        n0 = kt.kernel_launches()[used]
        X, st = kt.block_gmres(Ps, B, memory=8, restart=True, **extra)
        assert X.is_cuda and X.dtype == torch.float32 and st.solved
        assert kt.kernel_launches()[used] > n0
    n0 = kt.kernel_launches()["block_gmres_dia"]
    assert kt.block_gmres(Ps, np.tile(B[:, :1], (1, 4)))[1].solved
    assert kt.kernel_launches()["block_gmres_dia"] == n0
    op = kt.BELLOperator(_bell_tridiagonal(8, 128, torch.float32, 28))
    b = torch.as_tensor(rng.standard_normal(1024)).to("cuda", torch.float32)
    B = torch.as_tensor(rng.standard_normal((1024, 4))).to("cuda",
                                                          torch.float32)
    for call, name in ((lambda: kt.cg(op, b), "bell_spmv"),
                       (lambda: kt.block_gmres(op, B), "bell_spmm"),
                       (lambda: kt.block_minres(op, B), "bell_spmm")):
        n0 = kt.kernel_launches()[name]
        assert call()[-1].solved
        assert kt.kernel_launches()[name] > n0


def _sell_csr(m, n, dtype, seed=29):
    """A seeded sparse m × n CSR matrix on the card with empty rows, an
    empty slice and one row of 100 nonzeros in one chunk (a deep pair),
    and the generator that made it."""
    rng = np.random.default_rng(seed)
    A = np.where(rng.random((m, n)) < 0.004, rng.standard_normal((m, n)),
                 0.0)
    A[1024:2048] = 0.0
    A[3, :100] = np.arange(1.0, 101.0) / 100
    if dtype.is_complex:
        A = A * (1.0 + 0.5j)
    rows, cols = np.nonzero(A)
    return kt.csr_from_coo(rows, cols, A[rows, cols], (m, n)), rng


@pytest.mark.cuda
@pytest.mark.parametrize("pair", _build._SPMV_PAIRS)
def test_sell_kernel_matches_plain_on_card(pair):
    """sell_spmv against its plain version on the same SELL arrays, for
    every (x, data) pair of the DIA SpMV, covered and uncovered, single
    and bucketed (one launch each, the parts' data narrowed after the
    build and so homed again): max |Δ| ≤ tol · max|y|, tol a few ulps of
    the accumulation type over a row (f32 for f32, bf16 and f16, whose
    outputs round to one ulp of the narrow type); the rows of a slice
    with no pair read exactly 0."""
    _card()
    from krylov_tpu_torch.ops import cuda_sell as cs
    names = {"f32": torch.float32, "f64": torch.float64,
             "bf16": torch.bfloat16, "f16": torch.float16,
             "c64": torch.complex64, "c128": torch.complex128}
    xdt, ddt = (names[t] for t in pair.split("_"))
    tol = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-12,
           torch.complex128: 1e-12, torch.bfloat16: 2e-2,
           torch.float16: 2e-3}[xdt]
    wide = torch.complex128 if ddt.is_complex else torch.float64
    csr, rng = _sell_csr(3000, 2600, wide)
    x = torch.as_tensor(rng.standard_normal(2600)).to("cuda", xdt)
    if xdt.is_complex:
        x = x * (0.5 - 1.0j)
    for S in (kt.sell_from_csr(csr), kt.sell_from_csr(csr, cover=False),
              kt.sell_bucketed_from_csr(csr)):
        # the arrays built in the wide type, the data then narrowed (numpy
        # holds no bf16)
        for part in getattr(S, "parts", (S,)):
            part.data = part.data.to(ddt)
        n0 = kt.sell_spmv.launches
        y = S @ x
        # one launch per product, over all the parts
        assert kt.sell_spmv.launches == n0 + 1
        ref = (cs.sell_bucketed_spmv_ref(S, x)
               if isinstance(S, kt.SELLBucketed) else cs.sell_spmv_ref(S, x))
        assert y.dtype == xdt and y.shape == (3000,)
        assert _rel(y, ref) <= tol
        assert bool((y[1024:2048] == 0).all())


@pytest.mark.cuda
def test_sell_sorted_and_uncovered_on_card():
    """A σ-sorted plan (heavy constraint rows spread over every slice)
    un-permutes on the card as its plain version does, and an uncovered
    single SELL matrix writes zeros for its empty slices even where the
    output buffer held NaN before."""
    _card()
    from krylov_tpu_torch.ops import cuda_sell as cs
    rng = np.random.default_rng(30)
    n = 1 << 14
    r = np.repeat(np.arange(n, dtype=np.int64), 7)
    c = np.clip(r + rng.integers(-300, 301, size=r.size), 0, n - 1)
    heavy = np.sort(rng.choice(n, n // 256, replace=False))
    r = np.r_[r, np.repeat(heavy, 1280)]
    c = np.r_[c, np.tile(np.arange(1280), len(heavy))]
    csr = kt.csr_from_coo(r, c, rng.standard_normal(r.size), (n, n),
                          dtype=np.float32)
    S = kt.sell_bucketed_from_csr(csr)
    assert isinstance(S, kt.SELLBucketed) and S.row_pos is not None
    x = torch.as_tensor(rng.standard_normal(n)).to("cuda", torch.float32)
    assert _rel(S @ x, cs.sell_bucketed_spmv_ref(S, x)) <= 1e-5
    csr2, _ = _sell_csr(4096, 4096, torch.float64)
    U = kt.sell_from_csr(csr2, cover=False)
    assert not U.covered
    # a freed block full of NaN, which the allocator may hand to y
    torch.full((4096,), float("nan"), device="cuda")
    y = U @ torch.ones(4096, dtype=torch.float64, device="cuda")
    assert bool(torch.isfinite(y).all()) and bool((y[1024:2048] == 0).all())
    assert _rel(y, cs.sell_spmv_ref(U, torch.ones_like(y))) <= 1e-12


@pytest.mark.cuda
def test_sell_kernel_raises_for_other_pairs():
    _card()
    csr, _ = _sell_csr(600, 600, torch.float64)
    S = kt.sell_from_csr(csr)
    for xdt in (torch.float32, torch.float16):
        with pytest.raises(ValueError, match="no SELL SpMV kernel"):
            kt.sell_spmv(S, torch.ones(600, dtype=xdt, device="cuda"))


def _spd_band_csr(rng, n, dtype, w=300):
    """An SPD band on the card: 12 entries a row at offsets uniform in ±w,
    symmetrised, with the diagonal 1 + the sum of its row's moduli."""
    rows = np.repeat(np.arange(n, dtype=np.int64), 12)
    cols = np.clip(rows + rng.integers(-w, w + 1, size=rows.size), 0, n - 1)
    vals = rng.standard_normal(rows.size)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    d = 1.0 + np.bincount(rows, np.abs(vals), n) + np.bincount(
        cols, np.abs(vals), n)
    R = np.r_[rows, cols, np.arange(n)]
    C = np.r_[cols, rows, np.arange(n)]
    V = np.r_[vals, vals, d]
    return kt.csr_from_coo(R, C, V, (n, n), dtype=dtype)


@pytest.mark.cuda
def test_csr_on_card_routes_through_cached_hybrid_operator():
    """as_operator(csr on the card) analyses once into a HybridOperator
    cached on the matrix; cg on it launches dia_spmv for the dense
    diagonal and sell_spmv for the rest and solves as CSROperator does;
    lsqr, which needs Aᴴ, replaces the cache with the adjoint-capable
    operator, whose rmatvec runs sell_spmv on Aᴴ's SELL."""
    _card()
    rng = np.random.default_rng(31)
    n = 1 << 13
    csr = _spd_band_csr(rng, n, np.float64)
    op = kt.as_operator(csr)
    assert isinstance(op, kt.HybridOperator) and csr._hybrid_op is op
    assert kt.as_operator(csr) is op
    assert op.hyb.dia is not None and op.hyb.dia_pd is not None
    assert isinstance(op.hyb.sell, (kt.SELLMatrix, kt.SELLBucketed))
    b = torch.as_tensor(rng.standard_normal(n), device="cuda")
    n0 = kt.kernel_launches()
    x, st = kt.cg(csr, b)
    n1 = kt.kernel_launches()
    assert st.solved and x.is_cuda
    assert n1["dia_spmv"] > n0["dia_spmv"] and \
        n1["sell_spmv"] > n0["sell_spmv"]
    xc, sc = kt.cg(kt.CSROperator(csr), b)
    assert st.status == sc.status and abs(st.niter - sc.niter) <= 2
    assert _rel(x, xc) <= 1e-8
    m0 = kt.sell_spmv.launches
    xl, sl = kt.lsqr(csr, b)
    assert sl.solved and csr._hybrid_op is not op
    assert csr._hybrid_op.hyb is op.hyb and csr._hybrid_op.hyb_h is not None
    assert kt.sell_spmv.launches > m0
    assert _rel(csr._hybrid_op.rmatvec(b),
                kt.CSROperator(csr).with_adjoint().rmatvec(b)) <= 1e-12



@pytest.mark.cuda
def test_csr_on_card_reanalyses_after_in_place_change():
    """Scaling a card CSRMatrix's data in place (and then replacing it)
    makes as_operator analyse it again: the next cg solves the new
    matrix, x halved for A doubled, through dia_spmv and sell_spmv."""
    _card()
    rng = np.random.default_rng(32)
    n = 1 << 13
    csr = _spd_band_csr(rng, n, np.float64)
    b = torch.as_tensor(rng.standard_normal(n), device="cuda")
    x1, s1 = kt.cg(csr, b, atol=0.0, rtol=1e-10)
    op = csr._hybrid_op
    csr.data.mul_(2.0)
    n0 = kt.kernel_launches()
    x2, s2 = kt.cg(csr, b, atol=0.0, rtol=1e-10)
    n1 = kt.kernel_launches()
    assert s1.solved and s2.solved and csr._hybrid_op is not op
    assert n1["dia_spmv"] > n0["dia_spmv"] and \
        n1["sell_spmv"] > n0["sell_spmv"]
    assert _rel(x2, 0.5 * x1) <= 1e-8
    assert _rel(csr._hybrid_op.matvec(b), kt.spmv(csr, b)) <= 1e-12
    csr.data = csr.data * 0.25
    x3, s3 = kt.cg(csr, b, atol=0.0, rtol=1e-10)
    assert s3.solved and _rel(x3, 2.0 * x1) <= 1e-8


@pytest.mark.cuda
def test_bf16_csr_on_card_routes_through_hybrid_operator():
    """A bf16 CSRMatrix on the card analyses into bf16 DIA and SELL parts
    (the host works on f32 copies of its values); the product of f32 x
    runs the (f32, bf16) kernels within 1e-5 of the plain CSR product,
    and cg with an f32 b solves as CSROperator does."""
    _card()
    rng = np.random.default_rng(33)
    n = 1 << 13
    c64 = _spd_band_csr(rng, n, np.float64)
    csr = kt.CSRMatrix(c64.data.to(torch.bfloat16), c64.indices,
                       c64.indptr, c64.rows, c64.shape)
    op = kt.as_operator(csr)
    assert isinstance(op, kt.HybridOperator) and op.dtype == torch.bfloat16
    assert op.hyb.dia_pd.dtype == torch.bfloat16
    x = torch.as_tensor(rng.standard_normal(n), device="cuda",
                        dtype=torch.float32)
    n0 = kt.kernel_launches()
    y = op.matvec(x)
    n1 = kt.kernel_launches()
    assert n1["dia_spmv"] > n0["dia_spmv"] and \
        n1["sell_spmv"] > n0["sell_spmv"]
    assert y.dtype == torch.float32 and _rel(y, kt.spmv(csr, x)) <= 1e-5
    xs, st = kt.cg(csr, x)
    xc, sc = kt.cg(kt.CSROperator(csr), x)
    assert st.solved and st.status == sc.status
    assert abs(st.niter - sc.niter) <= 2


_PAIR_TYPES = {"f32": torch.float32, "f64": torch.float64,
               "bf16": torch.bfloat16, "f16": torch.float16,
               "c64": torch.complex64, "c128": torch.complex128}


def _narrowed_bucketed(S, ddt):
    """SELLBucketed ``S`` rebuilt from separate part tensors with data in
    ``ddt`` (homed anew into one set of buffers)."""
    from krylov_tpu_torch.ops import cuda_sell as cs
    return kt.SELLBucketed(
        [cs.SELLMatrix(p.data.to(ddt), p.idx.clone(), p.slice_of,
                       p.chunk_of.clone(), p.shape, p.nnz, p.covered,
                       p.slice_ptr.clone()) for p in S.parts],
        S.shape, S.nnz, S.row_pos)


def _spread_csr(rng, n, dtype):
    """A band with n/256 heavy constraint rows spread over every slice:
    the σ-sorted plan."""
    r = np.repeat(np.arange(n, dtype=np.int64), 7)
    c = np.clip(r + rng.integers(-300, 301, size=r.size), 0, n - 1)
    heavy = np.sort(rng.choice(n, n // 256, replace=False))
    r = np.r_[r, np.repeat(heavy, 1280)]
    c = np.r_[c, np.tile(np.arange(1280), len(heavy))]
    return kt.csr_from_coo(r, c, rng.standard_normal(r.size), (n, n),
                           dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", _build._SPMV_PAIRS)
def test_sell_one_launch_is_the_per_part_composition_on_card(pair):
    """For every (x, data) pair: a bucketed plan with uncovered parts, a
    slice with no pair and empty rows, and a σ-sorted plan, each one
    sell_spmv launch, bit for bit the per-part composition (the kernel
    on each part alone, PyTorch's adds and gather); a hybrid product with
    a DIA part is one dia_spmv and one sell_spmv launch, bit for bit the
    DIA half plus that composition, for A and Aᴴ."""
    _card()
    from krylov_tpu_torch.ops import cuda_sell as cs
    from krylov_tpu_torch.ops.hybrid import HybridMatrix, hybrid_spmv
    xdt, ddt = (_PAIR_TYPES[t] for t in pair.split("_"))
    wide = torch.complex128 if ddt.is_complex else torch.float64
    rng = np.random.default_rng(34)
    csr, _ = _sell_csr(3000, 2600, wide)
    spread = _spread_csr(rng, 1 << 14, np.float64)
    if wide.is_complex:
        spread = kt.CSRMatrix(spread.data * (1.0 - 0.25j), spread.indices,
                              spread.indptr, spread.rows, spread.shape)
    for A in (csr, spread):
        S = _narrowed_bucketed(kt.sell_bucketed_from_csr(A), ddt)
        assert isinstance(S, kt.SELLBucketed) and len(S.parts) >= 2
        x = torch.as_tensor(rng.standard_normal(A.shape[1])).to("cuda", xdt)
        if xdt.is_complex:
            x = x * (0.5 - 1.0j)
        n0 = kt.sell_spmv.launches
        y = cs.sell_bucketed_spmv(S, x)
        assert kt.sell_spmv.launches == n0 + 1
        assert y.dtype == xdt and torch.equal(
            y, cs.sell_bucketed_spmv_parts(S, x))
    assert S.row_pos is not None
    band = _spd_band_csr(rng, 1 << 13, np.float64)
    if wide.is_complex:
        band = kt.CSRMatrix(band.data * (1.0 + 0.5j), band.indices,
                            band.indptr, band.rows, band.shape)
    x = torch.as_tensor(rng.standard_normal(1 << 13)).to("cuda", xdt)
    if xdt.is_complex:
        x = x * (0.5 - 1.0j)
    for M in (band, band.transpose_conj()):
        H = kt.hybrid_from_csr(M)
        assert H.dia_pd is not None and isinstance(
            H.sell, (kt.SELLMatrix, kt.SELLBucketed))
        Hd = HybridMatrix(H.dia, None, H.shape,
                          H.dia_pd.to(ddt))
        Hs = H.sell if isinstance(H.sell, kt.SELLMatrix) else \
            _narrowed_bucketed(H.sell, ddt)
        if isinstance(Hs, kt.SELLMatrix):
            Hs.data = Hs.data.to(ddt)
        Hy = HybridMatrix(H.dia, Hs, H.shape, Hd.dia_pd)
        n0 = kt.kernel_launches()
        y = hybrid_spmv(Hy, x)
        n1 = kt.kernel_launches()
        assert (n1["dia_spmv"] - n0["dia_spmv"],
                n1["sell_spmv"] - n0["sell_spmv"]) == (1, 1)
        parts = cs.sell_bucketed_spmv_parts(Hs, x) \
            if isinstance(Hs, kt.SELLBucketed) else kt.sell_spmv(Hs, x)
        assert torch.equal(y, hybrid_spmv(Hd, x) + parts)
        n0 = kt.sell_spmv.launches
        assert torch.equal(hybrid_spmv(HybridMatrix(None, Hs, H.shape), x),
                           parts)
        assert kt.sell_spmv.launches == n0 + 1


@pytest.mark.cuda
def test_one_launch_products_match_plain_on_card():
    """The one-launch SELL product and the two-launch hybrid product in
    f32 and f64 against their plain versions (the table walk, and the
    plain CSR product): within 1e-5 and 1e-12 of max|y|; a product whose
    x is not contiguous, and a part tensor replaced after the build,
    give the plain results too."""
    _card()
    from krylov_tpu_torch.ops import cuda_sell as cs
    from krylov_tpu_torch.ops.hybrid import hybrid_spmv
    rng = np.random.default_rng(35)
    for dt, tol in ((np.float32, 1e-5), (np.float64, 1e-12)):
        band = _spd_band_csr(rng, 1 << 13, dt)
        op = kt.as_operator(band).with_adjoint()
        tdt = torch.float32 if dt == np.float32 else torch.float64
        x = torch.as_tensor(rng.standard_normal(1 << 13)).to("cuda", tdt)
        for hyb in (op.hyb, op.hyb_h):
            assert _rel(hybrid_spmv(hyb, x), kt.spmv(band, x)
                        if hyb is op.hyb else
                        kt.CSROperator(band).with_adjoint().rmatvec(x)) <= tol
            S = hyb.sell
            assert _rel(kt.sell_spmv(S, x), cs.sell_table_spmv_ref(S, x)) \
                <= tol
        S = kt.sell_bucketed_from_csr(_spread_csr(rng, 1 << 14, dt))
        assert S.row_pos is not None
        x2 = torch.as_tensor(rng.standard_normal(2 << 14)).to("cuda", tdt)
        assert _rel(kt.sell_spmv(S, x2[::2]), cs.sell_table_spmv_ref(
            S, x2[::2].contiguous())) <= tol
        S.parts[0].data = S.parts[0].data * 2.0
        x = x2[1::2].contiguous()
        assert _rel(kt.sell_spmv(S, x), cs.sell_bucketed_spmv_ref(S, x)) \
            <= tol


def _dia_case(n, offs, xdt, pdt, seed):
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.standard_normal((len(offs), n)))
    x = torch.as_tensor(rng.standard_normal(n + 4))
    if pdt.is_complex:
        data = data * (1.0 + 0.5j)
    if xdt.is_complex:
        x = x * (0.5 - 1.0j)
    pd = dia_align(data, offs, n).to("cuda", pdt)
    return pd, offsets_tensor(offs, "cuda"), x.to("cuda", xdt)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,pdt,tol", SPMV_PAIRS,
                         ids=[f"{x}-{p}".replace("torch.", "")
                              for x, p, _ in SPMV_PAIRS])
def test_dia_spmv_wide_loads_on_card(xdt, pdt, tol):
    """The DIA SpMV with wide loads against dia_spmv_aligned_ref at the
    tolerances of test_spmv_kernel_matches_plain_on_card: n = 1000, 1001
    and 1003 (the vector path and the scalar one), one diagonal, 27
    diagonals, offsets with |k| >= n, an x that starts one element past a
    16-byte boundary, and DIASpMV's lean call against the public one (bit
    for bit, one launch each)."""
    _card()
    from krylov_tpu_torch.ops.cuda_dia import DIASpMV
    cube = tuple(i + 10 * j + 100 * k for i in (-1, 0, 1)
                 for j in (-1, 0, 1) for k in (-1, 0, 1))
    cases = [(n, (-33, -1, 0, 1, 5, 64, 100)) for n in (1000, 1001, 1003)]
    cases += [(1000, (0,)), (1000, (-7,)), (1003, cube),
              (1000, (-1000, -3, 0, 2, 1000, 5000)), (1001, (-2000, 1001))]
    for seed, (n, offs) in enumerate(cases):
        pd, ot, xs = _dia_case(n, offs, xdt, pdt, seed)
        for x in (xs[:n], xs[1:n + 1]):
            before = dia_spmv_aligned.launches
            y = dia_spmv_aligned(pd, ot, x)
            assert dia_spmv_aligned.launches == before + 1
            want = dia_spmv_aligned_ref(pd, ot, x)
            assert y.dtype == xdt and y.shape == (n,)
            if float(want.abs().max()) == 0.0:
                assert bool((y == 0).all())
            else:
                assert _rel(y, want) <= tol
            plan = DIASpMV(pd, ot, offs)
            assert torch.equal(plan(x), y)
            assert dia_spmv_aligned.launches == before + 2
