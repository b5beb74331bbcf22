"""End-to-end (setup + solve) comparison on the mapped ~900k-DoF mesh:
MG-preconditioned solves vs reference-style Jacobi CG. Run from the repo
root."""
import sys
import time

sys.path.insert(0, ".")
import jax

# f64 end-to-end
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, ReductionControl
from deal_and_ceed_on_gpu_tpu.mesh import sine_map
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs
from deal_and_ceed_on_gpu_tpu.solvers import Multigrid, solve_cg, solve_cg_ir
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache

enable_compilation_cache()
T = time.time

phi, jac = sine_map(0.05)
mesh = BrickMesh((32, 32, 32)).deform(phi, jac)
space = FESpace.create(mesh, 3, rule="gauss_lobatto", dtype=jnp.float64)
print(f"mapped mesh, {space.n_dofs} DoFs, f64 target reduction 1e-10", flush=True)

t0 = T()
op = PoissonOperator(space, backend="structured")
b = jax.block_until_ready(assemble_rhs(space, 1.0))
t_op = T() - t0
print(f"operator + rhs (shared by all solves): {t_op:.1f}s", flush=True)

control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)

# reference-style: true-Jacobi merged CG, all f64
t0 = T()
diag = op.jacobi_preconditioner()
from deal_and_ceed_on_gpu_tpu import solve_cg_merged
x, info = jax.block_until_ready(solve_cg_merged(op.vmult, b, control, diag=diag)[0]), None
t_jac_total = T() - t0
x, info = solve_cg_merged(op.vmult, b, control, diag=diag)
jax.block_until_ready(x)
res = float(jnp.linalg.norm(b - op.vmult(x)) / jnp.linalg.norm(b))
print(f"Jacobi f64 CG end-to-end: {t_jac_total:.1f}s ({int(info['n_iterations'])} its, true rel res {res:.1e})", flush=True)

# MG end-to-end: setup (reusing the solve operator) + f64 CG
t0 = T()
mg = Multigrid(space, fine_op=op)
t_mg_setup = T() - t0
t0 = T()
x, info = solve_cg(op.vmult, b, control, diag=mg.vcycle)
jax.block_until_ready(x)
t_mg_solve = T() - t0
res = float(jnp.linalg.norm(b - op.vmult(x)) / jnp.linalg.norm(b))
print(f"MG setup {t_mg_setup:.1f}s + f64 MG-CG solve {t_mg_solve:.1f}s "
      f"({int(info['n_iterations'])} its, true rel res {res:.1e})", flush=True)
