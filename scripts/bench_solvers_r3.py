"""Time-to-1e-10 tables: uniform
~1M-DoF cube and the sine-mapped 912k-DoF mesh, all solver paths, with
setup and warm-solve times reported separately (the solver jit cache
makes call #2 the steady-state number; call #1 adds the one-time XLA
compile). Run from the repo root on the GPU."""
import sys
import time

sys.path.insert(0, ".")
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import (
    BrickMesh,
    FESpace,
    ReductionControl,
    solve_cg,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.mesh import sine_map
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs
from deal_and_ceed_on_gpu_tpu.solvers import FDMSolver, Multigrid, solve_cg_ir
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache

enable_compilation_cache()
T = time.time


def timed(label, fn):
    t0 = T()
    out = jax.block_until_ready(fn())
    dt = T() - t0
    print(f"  {label}: {dt:.2f}s", flush=True)
    return out, dt


def rel_res(op, b, x):
    return float(jnp.linalg.norm(b - op.vmult(x)) / jnp.linalg.norm(b))


def run_case(name, mesh, degree, with_fdm):
    print(f"== {name} ==", flush=True)
    space = FESpace.create(mesh, degree, rule="gauss_lobatto", dtype=jnp.float64)
    print(f"  {space.n_dofs} DoFs f64", flush=True)
    backend = "structured" if mesh.is_mapped else "separable"
    (op, b), t_op = timed(
        "operator + rhs setup",
        lambda: (PoissonOperator(space, backend=backend), assemble_rhs(space, 1.0)),
    )
    control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)

    # Jacobi f64 merged CG (reference-style)
    diag, t_diag = timed("jacobi diagonal", lambda: op.jacobi_preconditioner())
    solve = lambda: solve_cg_merged(op.vmult, b, control, diag=diag)[0]
    x, t1 = timed("jacobi CG #1 (incl compile)", solve)
    x, t2 = timed("jacobi CG #2 (warm)", solve)
    _, info = solve_cg_merged(op.vmult, b, control, diag=diag)
    print(
        f"  jacobi CG: {int(info['n_iterations'])} its, true rel res "
        f"{rel_res(op, b, x):.1e}",
        flush=True,
    )

    # multigrid-preconditioned CG
    mg, t_mg = timed("MG setup", lambda: Multigrid(space, fine_op=op))
    solve = lambda: solve_cg(op.vmult, b, control, diag=mg.vcycle)[0]
    x, t1 = timed("MG-CG #1 (incl compile)", solve)
    x, t2 = timed("MG-CG #2 (warm)", solve)
    _, info = solve_cg(op.vmult, b, control, diag=mg.vcycle)
    print(
        f"  MG-CG: {int(info['n_iterations'])} its, true rel res "
        f"{rel_res(op, b, x):.1e}",
        flush=True,
    )

    # mixed-precision IR (f32 inner CG), then IR + MG inner preconditioner
    sp32 = FESpace.create(mesh, degree, rule="gauss_lobatto", dtype=jnp.float32)
    (op32,), t32 = timed(
        "f32 operator setup", lambda: (PoissonOperator(sp32, backend=backend),)
    )
    x, t1 = timed("IR jacobi #1", lambda: solve_cg_ir(op32, op, b)[0])
    x, t2 = timed("IR jacobi #2 (warm)", lambda: solve_cg_ir(op32, op, b)[0])
    _, info = solve_cg_ir(op32, op, b)
    print(
        f"  IR: {info['n_outer']} outer / {info['n_inner']} inner, "
        f"res {info['res_rel']:.1e}",
        flush=True,
    )

    mg32, t_mg32 = timed("f32 MG setup", lambda: Multigrid(sp32, fine_op=op32))
    ir_mg = lambda: solve_cg_ir(op32, op, b, diag32=mg32.vcycle, inner_max=40)[0]
    x, t1 = timed("IR+MG #1", ir_mg)
    x, t2 = timed("IR+MG #2 (warm)", ir_mg)
    _, info = solve_cg_ir(op32, op, b, diag32=mg32.vcycle, inner_max=40)
    print(
        f"  IR+MG: {info['n_outer']} outer / {info['n_inner']} inner, "
        f"res {info['res_rel']:.1e}",
        flush=True,
    )

    if with_fdm:
        fdm, t_f = timed("FDM setup", lambda: FDMSolver(space))
        f = jax.jit(fdm.solve)
        x, t1 = timed("FDM #1", lambda: f(b))
        x, t2 = timed("FDM #2 (warm)", lambda: f(b))
        print(f"  FDM true rel res {rel_res(op, b, x):.1e}", flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "both"
    if which in ("uniform", "both"):
        run_case("uniform cycle-26 (1,056,321 DoFs) p=5",
                 BrickMesh.bp5_cycle(26), 5, with_fdm=True)
    if which in ("mapped", "both"):
        phi, jac = sine_map(0.05)
        run_case("sine-mapped 32^3 p=3 (912,673 DoFs)",
                 BrickMesh((32, 32, 32)).deform(phi, jac), 3, with_fdm=False)
