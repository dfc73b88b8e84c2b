"""Statistics objects returned by the solvers.

A copy of the part of ``krylov_tpu/stats.py`` that the ported solvers
use (numpy only; the port imports nothing of the JAX package): the
shared status vocabulary, ``KrylovStatsBase``, ``SimpleStats``,
``LanczosStats``, ``LanczosShiftStats``, ``SymmlqStats``,
``AdjointStats``, ``LNLQStats``, ``LsmrStats`` and ``LSLQStats``, with the
same fields and ``repr`` (reference:
src/krylov_stats.jl).
"""

from dataclasses import dataclass, field
from typing import List

import numpy as np


# Shared status vocabulary (reference: src/cg.jl:272-278 etc.).
UNKNOWN = "unknown"
SOLVED = "solution good enough given atol and rtol"
SOLVED_AR = "found approximate minimum least-squares solution"
SOLVED_X = "found approximate minimum-norm solution"
ZERO_RESIDUAL = "x is a zero-residual solution"
TIRED = "maximum number of iterations exceeded"
OVERTIMED = "time limit exceeded"
USER_EXIT = "user-requested exit"
NPC = "nonpositive curvature"
ON_BOUNDARY = "on trust-region boundary"
ZERO_CURVATURE = "zero curvature detected"
INCONSISTENT = "found approximate least-squares solution"


@dataclass
class KrylovStatsBase:
    niter: int = 0
    timer: float = 0.0
    status: str = UNKNOWN


@dataclass
class SimpleStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:24-36."""
    solved: bool = False
    inconsistent: bool = False
    indefinite: bool = False
    npc_count: int = 0
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    Aresiduals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    Acond: np.ndarray = field(default_factory=lambda: np.zeros(0))

    # Julia-name alias
    @property
    def npcCount(self):
        return self.npc_count


@dataclass
class LsmrStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:76-90."""
    solved: bool = False
    inconsistent: bool = False
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    Aresiduals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    residual: float = 0.0
    Aresidual: float = 0.0
    Acond: float = 0.0
    Anorm: float = 0.0
    xNorm: float = 0.0


@dataclass
class LanczosStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:127-137."""
    solved: bool = False
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    indefinite: bool = False
    Anorm: float = 0.0
    Acond: float = 0.0


@dataclass
class LanczosShiftStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:169-179."""
    solved: bool = False
    residuals: List[np.ndarray] = field(default_factory=list)
    indefinite: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=bool))
    Anorm: float = 0.0
    Acond: float = 0.0


@dataclass
class SymmlqStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:215-227 (Missing ↦ np.nan)."""
    solved: bool = False
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    residualscg: np.ndarray = field(default_factory=lambda: np.zeros(0))
    errors: np.ndarray = field(default_factory=lambda: np.zeros(0))
    errorscg: np.ndarray = field(default_factory=lambda: np.zeros(0))
    Anorm: float = 0.0
    Acond: float = 0.0


@dataclass
class AdjointStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:263-272."""
    solved_primal: bool = False
    solved_dual: bool = False
    residuals_primal: np.ndarray = field(default_factory=lambda: np.zeros(0))
    residuals_dual: np.ndarray = field(default_factory=lambda: np.zeros(0))

    @property
    def solved(self):
        return self.solved_primal and self.solved_dual


@dataclass
class LNLQStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:305-315."""
    solved: bool = False
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    error_with_bnd: bool = False
    error_bnd_x: np.ndarray = field(default_factory=lambda: np.zeros(0))
    error_bnd_y: np.ndarray = field(default_factory=lambda: np.zeros(0))


@dataclass
class LSLQStats(KrylovStatsBase):
    """reference: src/krylov_stats.jl:352-365."""
    solved: bool = False
    inconsistent: bool = False
    residuals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    Aresiduals: np.ndarray = field(default_factory=lambda: np.zeros(0))
    err_lbnds: np.ndarray = field(default_factory=lambda: np.zeros(0))
    error_with_bnd: bool = False
    err_ubnds_lq: np.ndarray = field(default_factory=lambda: np.zeros(0))
    err_ubnds_cg: np.ndarray = field(default_factory=lambda: np.zeros(0))
