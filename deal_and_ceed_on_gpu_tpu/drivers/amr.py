"""AMR demo driver: the solve -> estimate -> mark -> refine loop.

A deal.II step-6-style workflow on the adaptive (hanging-node) machinery:
Poisson with a sharp localized source, Zienkiewicz-Zhu gradient-recovery
indicators, Doerfler marking, 2:1-balanced refinement. Prints a history
table (cells, DoFs, CG iterations, global estimate). Framework extra —
the reference only runs uniform sweeps.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..adaptive import amr_loop
from ..mesh import BrickMesh
from ..utils.logging import rank0_print as pcout


def main():
    ap = argparse.ArgumentParser(description="adaptive refinement demo")
    ap.add_argument("--base", type=int, default=4, help="base mesh cells/axis")
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--theta", type=float, default=0.5, help="Doerfler fraction")
    ap.add_argument("--center", type=float, nargs=3, default=(0.8, 0.8, 0.8))
    ap.add_argument("--width", type=float, default=0.01, help="source width^2")
    ap.add_argument(
        "--precond",
        choices=("none", "mg", "mg-ir"),
        default="none",
        help="mg = global-coarsening adaptive multigrid preconditioner; "
        "mg-ir = mixed-precision iterative refinement (f32 MG inner CG, "
        "f64 true residuals)",
    )
    ap.add_argument("--dtype", default="float64", choices=("float32", "float64"))
    ap.add_argument(
        "--reduction",
        type=float,
        default=None,
        help="relative residual target per solve (default 1e-10 for "
        "float64; 1e-5 for float32, where 1e-10 is unattainable and every "
        "step would burn the full iteration budget without converging)",
    )
    ap.add_argument(
        "--write-solution",
        metavar="PATH.vtu",
        default=None,
        help="write the final step's solution as a VTK unstructured grid",
    )
    args = ap.parse_args()

    from ..utils import ensure_x64

    ensure_x64(args.dtype)

    c = np.asarray(args.center)

    def f(x):
        return np.exp(-((x - c) ** 2).sum(axis=-1) / args.width)

    pcout(f"AMR: Q{args.degree}, base {args.base}^3, source at {tuple(c)}")
    hist = amr_loop(
        BrickMesh((args.base,) * 3),
        args.degree,
        f=f,
        n_steps=args.steps,
        theta=args.theta,
        precond=args.precond,
        dtype=args.dtype,
        reduction=args.reduction
        or (1e-10 if args.dtype == "float64" else 1e-5),
    )
    pcout(f"{'step':>4} {'cells':>8} {'DoFs':>9} {'CG its':>7} {'estimate':>12}")
    for k, h in enumerate(hist):
        pcout(
            f"{k:>4} {h['n_cells']:>8} {h['n_dofs']:>9} "
            f"{h['n_iterations']:>7} {h['eta']:>12.4e}"
        )
    if args.write_solution:
        from ..utils.vtk import write_solution_vtu

        last = hist[-1]
        write_solution_vtu(args.write_solution, last["space"], last["x"])
        pcout(f"solution written to {args.write_solution}")


if __name__ == "__main__":
    main()
