"""step-64 Helmholtz driver: the correctness workload.

Rebuild of ``HelmholtzProblem`` (``step-64/step-64.cu:55-633``): solve
``-laplace(u) + a(x) u = 1`` with ``a(x) = 10/(0.05 + 2|x|^2)``, Q3 elements
on a globally refined unit cube, zero Dirichlet boundary, CG to a relative
tolerance of 1e-12 (``step-64/step-64.cu:513-514``), then report iteration
count and the solution L2 norm. Runs with both the plain and the merged CG
solver (``step-64/step-64.cu:682-688``; the reference intended the same
cross-check but its snapshot references a renamed class and does not
compile — SURVEY.md "known quirks").
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import HelmholtzOperator, assemble_rhs, l2_norm_function
from ..solvers import ReductionControl, solve_cg, solve_cg_merged
from ..utils.logging import rank0_print as pcout

__all__ = ["run"]


def run(
    n_refine: int = 3,
    degree: int = 3,
    dtype="float64",
    backend: str = "structured",
    use_merged: bool = False,
    rtol: float = 1e-12,
    max_steps: int = 2000,
    vtu_path: str | None = None,
    precond: str = "none",
):
    mesh = BrickMesh.hyper_cube().refine_global(n_refine)
    space = FESpace.create(mesh, degree, rule="gauss", dtype=jnp.dtype(dtype))
    op = HelmholtzOperator(space, backend=backend)
    pcout(f"   Number of active cells: {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")

    b = assemble_rhs(space, 1.0, backend=backend)
    # reference criterion 1e-12 * |b| (step-64/step-64.cu:513-514): with
    # x0 = 0 the initial residual IS b, so this is reduction = rtol
    control = ReductionControl(max_steps, tolerance=0.0, reduction=rtol)
    # preconditioning: the reference fills DiagonalMatrix with 1.0
    # ("none"); "jacobi" is the true operator diagonal, "fdm" the
    # fast-diagonalization tensor preconditioner (framework extras) —
    # fdm requires the plain-CG solver (merged CG is diagonal-only,
    # matching the reference's SolverCGFullMerge)
    if precond == "jacobi":
        diag = op.jacobi_preconditioner()
    elif precond == "fdm":
        from ..solvers import FDMSolver

        diag = FDMSolver(space).apply
        if use_merged:
            raise ValueError("fdm preconditioning requires the plain solver")
    elif precond == "mg":
        from ..solvers import Multigrid

        diag = Multigrid(
            space,
            make_op=lambda s: HelmholtzOperator(s, backend=backend),
            fine_op=op,
        ).vcycle
        if use_merged:
            raise ValueError("mg preconditioning requires the plain solver")
    else:
        diag = op.diagonal()
    solver = solve_cg_merged if use_merged else solve_cg
    x, info = jax.jit(lambda b: solver(op.vmult, b, control, diag=diag))(b)
    it = int(info["n_iterations"])
    control.check({k: jax.device_get(v) for k, v in info.items()})
    pcout(f"  Solved in {it} iterations.")
    norm = float(l2_norm_function(space, x))
    pcout(f"  solution norm: {norm:.12g}")
    if vtu_path:
        from ..utils.vtk import write_solution_vtr

        write_solution_vtr(vtu_path, space, x)
        pcout(f"  wrote {vtu_path}")
    return {"n_iterations": it, "l2_norm": norm, "x": x, "space": space}


def main():
    from ..utils import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description="step-64 Helmholtz")
    ap.add_argument("--refine", type=int, default=3)
    ap.add_argument("--degree", type=int, default=3)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--backend", default="structured")
    ap.add_argument("--vtu", default=None, help="write solution to this .vtr file")
    ap.add_argument(
        "--precond",
        default="none",
        choices=["none", "jacobi", "fdm", "mg"],
        help="none = reference DiagonalMatrix(1.0); jacobi/fdm/mg = extras",
    )
    args = ap.parse_args()
    from ..utils import ensure_x64

    ensure_x64(args.dtype)
    for use_merged in (False, True):
        if use_merged and args.precond in ("fdm", "mg"):
            continue  # merged CG is diagonal-preconditioner-only
        pcout(f"--- use_merged = {use_merged} ---")
        run(
            n_refine=args.refine,
            degree=args.degree,
            dtype=args.dtype,
            backend=args.backend,
            use_merged=use_merged,
            vtu_path=args.vtu if use_merged else None,
            precond=args.precond,
        )


if __name__ == "__main__":
    main()
