from .control import (
    SolverControl,
    IterationNumberControl,
    ReductionControl,
    NoConvergence,
)
from .cg import solve_cg
from .cg_merged import solve_cg_merged
from .fdm import FDMSolver
from .ir import solve_cg_ir
from .multigrid import Multigrid
from .adaptive_mg import AdaptiveMultigrid

__all__ = [
    "Multigrid",
    "AdaptiveMultigrid",
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_merged",
    "FDMSolver",
    "solve_cg_ir",
]
