"""deal_and_ceed_on_gpu_tpu — a matrix-free high-order FEM framework in JAX.

A from-scratch rebuild of the capabilities of the EuroHack19 project
``peterrum/deal-and-ceed-on-gpu`` (CEED bake-off problems BP1..BP6, the
step-64 Helmholtz tutorial workload, and the fused-kernel preconditioned
conjugate-gradient solver), running on an NVIDIA GPU:

- JAX/XLA for the compute graph, a Pallas kernel through Triton for the
  uniform-brick GLL operator apply (``ops/stencil.py``), ``jax.sharding``
  + ``shard_map`` + XLA collectives for distribution.
- Structured brick meshes use a fully dense, index-free, axis-separable
  local<->global map (no atomics, no scatter).
- Polynomial degree / quadrature order are trace-time constants (the JAX
  analog of the reference's C++ template parameters).

Layer map (mirrors SURVEY.md section 1):
  L0  mesh/dof/geometry     -> mesh.py, basis.py, geometry.py
  L1  distributed vectors   -> parallel/ (sharded jax.Array + psum/ppermute)
  L2  matrix-free kernels   -> ops/ (sum_factorization, local_global, separable, stencil)
  L3  operators + solvers   -> models/, solvers/
  L4  drivers / benchmarks  -> drivers/ (bp5, step64), bench.py
"""

from .utils.host_memory import tune_host_allocator as _tune_host_allocator

# large-buffer reuse on slow-fault virtualized hosts (see the module
# docstring); must run before the big numpy/host tables are built
_tune_host_allocator()

from .basis import Basis1D, gauss_lobatto_points, gauss_points
from .mesh import BrickMesh, MappedMesh, shear_map, sine_map
from .geometry import Geometry
from .fe_space import FESpace
from .models.poisson import PoissonOperator
from .models.helmholtz import HelmholtzOperator
from .models.mass import MassOperator
from .solvers.control import (
    SolverControl,
    IterationNumberControl,
    ReductionControl,
    NoConvergence,
)
from .solvers.cg import solve_cg
from .solvers.cg_merged import solve_cg_merged

__version__ = "0.1.0"

__all__ = [
    "Basis1D",
    "BrickMesh",
    "MappedMesh",
    "shear_map",
    "sine_map",
    "Geometry",
    "FESpace",
    "PoissonOperator",
    "HelmholtzOperator",
    "MassOperator",
    "SolverControl",
    "IterationNumberControl",
    "ReductionControl",
    "NoConvergence",
    "solve_cg",
    "solve_cg_merged",
    "gauss_lobatto_points",
    "gauss_points",
]
