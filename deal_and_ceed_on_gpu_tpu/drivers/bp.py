"""CEED bake-off sweep driver: any of BP1..BP6 over polynomial degrees.

Covers the BASELINE.json breadth configs ("BP5 GLL q=p+1 sweep p=1..8",
"BP1/BP3 q=p+2", "vector BP4/BP6") with the reference's throughput metric
and line format (``<mode> <dofs/rank> <max_throughput>``,
``bp5/step-64.cu:470-474``).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp

from ..mesh import BrickMesh
from ..models import assemble_rhs, make_bp_operator
from ..solvers import IterationNumberControl, solve_cg_merged
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer

__all__ = ["run_sweep"]


def _target_mesh(p: int, target_dofs: int) -> BrickMesh:
    """Cube mesh with ~target_dofs at degree p."""
    m = max(2, round(target_dofs ** (1 / 3) / p))
    return BrickMesh((m, m, m))


def run_sweep(
    bp: str = "bp5",
    degrees=range(1, 9),
    target_dofs: int = 2_000_000,
    n_iterations: int = 100,
    n_repetitions: int = 3,
    dtype: str = "float32",
    modes=("pcg-merged", "vmult"),
    backend: str | None = None,
):
    results = {}
    for p in degrees:
        mesh = _target_mesh(p, target_dofs)
        space, op = make_bp_operator(
            bp, mesh, p, dtype=jnp.dtype(dtype), backend=backend
        )
        n = space.n_dofs
        n_comp = getattr(op, "n_components", 1)
        pcout(f"{bp} p={p}: {mesh.n_cells} cells, {n} DoFs x {n_comp} comp")
        res = {}

        b1 = assemble_rhs(space, 1.0)
        b = b1 if n_comp == 1 else jnp.broadcast_to(b1, (n_comp, n)).copy()
        control = IterationNumberControl(
            n_iterations, 1e-6 * float(jnp.linalg.norm(b))
        )

        vm = op.vmult

        if "pcg-merged" in modes:
            f = jax.jit(lambda b: solve_cg_merged(vm, b, control))
            x, info = f(b)
            jax.block_until_ready(x)
            times, iters = [], []
            for _ in range(n_repetitions):
                t = Timer().start()
                x, info = f(b)
                t.stop(fence=x)
                times.append(t.elapsed)
                iters.append(int(info["n_iterations"]))
            tp = max(n * n_comp * i / t for t, i in zip(times, iters))
            pcout(f"pcg-merged {n * n_comp} {tp:.6g}")
            res["pcg-merged"] = tp

        if "vmult" in modes:
            u = b / jnp.linalg.norm(b)
            v = jax.block_until_ready(vm(u))
            # fold the normalization into the tables: pure chained applies
            op.fold_scale(1.0 / max(float(jnp.linalg.norm(v)), 1.0))

            @jax.jit
            def chain(u):
                return jax.lax.fori_loop(0, n_iterations, lambda i, v: vm(v), u)

            jax.block_until_ready(chain(u))
            best = 0.0
            for _ in range(n_repetitions):
                t = Timer().start()
                out = chain(u)
                t.stop(fence=out)
                best = max(best, n * n_comp * n_iterations / t.elapsed)
            pcout(f"vmult {n * n_comp} {best:.6g}")
            res["vmult"] = best

        results[p] = res
        pcout("")
    return results


def main():
    from ..utils import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description="CEED BP sweep")
    ap.add_argument("--bp", default="bp5", choices=[f"bp{i}" for i in range(1, 7)])
    ap.add_argument("--p-min", type=int, default=1)
    ap.add_argument("--p-max", type=int, default=8)
    ap.add_argument("--target-dofs", type=int, default=2_000_000)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--repetitions", type=int, default=3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument(
        "--backend",
        default=None,
        help="operator backend (default: the separable path; stencil for "
        "the GLL stiffness BPs on the GPU)",
    )
    args = ap.parse_args()
    from ..utils import ensure_x64

    ensure_x64(args.dtype)
    run_sweep(
        args.bp,
        range(args.p_min, args.p_max + 1),
        args.target_dofs,
        args.iterations,
        args.repetitions,
        args.dtype,
        backend=args.backend,
    )


if __name__ == "__main__":
    main()
