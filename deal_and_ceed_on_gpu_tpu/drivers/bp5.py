"""BP5 benchmark driver: mesh-size sweep, three benchmark modes, validation.

Rebuild of the ``PoissonProblem`` driver (``bp5/step-64.cu:280-679``) with
runtime configuration replacing the reference's template parameters
(``<dim=3, fe_degree=5>`` instantiated at ``bp5/step-64.cu:724-733``). Output
lines match the reference format so result tables are comparable:

    pcg-standard <dofs/rank> <max_throughput>
    pcg-merged   <dofs/rank> <max_throughput>
    vmult        <dofs/rank> <max_throughput>

Throughput = DoFs * iterations / wall_time / n_processes, max over
repetitions (``bp5/step-64.cu:458-463``). Timing fences with
``block_until_ready`` (the ``cudaDeviceSynchronize`` equivalent).

The vmult mode chains ``v <- (A v) * (1/lambda_est)`` so the loop cannot be
hoisted as loop-invariant and f32 cannot overflow across 200 applies; the
scalar multiply fuses into the scatter and adds no measurable traffic.
"""

from __future__ import annotations

import argparse
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..models import PoissonOperator, assemble_rhs, l2_norm_function
from ..solvers import IterationNumberControl, solve_cg, solve_cg_merged
from ..utils.logging import rank0_print as pcout
from ..utils.timer import Timer

__all__ = ["BP5Config", "run_cycle", "run"]


@dataclasses.dataclass
class BP5Config:
    degree: int = 5
    n_iterations: int = 200
    n_repetitions: int = 10
    dtype: str = "float32"
    backend: str = "structured"
    rule: str = "gauss_lobatto"  # BP5 collocation; "gauss" for BP3-style
    n_q: int | None = None
    modes: tuple = ("pcg-standard", "pcg-merged", "vmult")
    validate: bool = True
    # matmul precision for the chained-vmult BENCHMARK only; solve and
    # validation modes always trace at "highest" (a process-global lowered
    # precision would silently degrade the CG accuracy and the L2 norm)
    matmul_precision: str = "highest"
    # separable backend's 1D sweeps: "matmul" (dense contractions) or
    # "stencil" (2p+1 shifted multiply-adds), see ops/separable.band_apply
    sep_mode: str = "matmul"


import contextlib


@contextlib.contextmanager
def _vmult_precision(cfg: "BP5Config"):
    """Apply ``cfg.matmul_precision`` to trace-time matmul precision for the
    chained-vmult benchmark ONLY, restoring "highest" afterwards so solve
    and validation traces in the same invocation are unaffected."""
    from ..ops.sum_factorization import set_matmul_precision

    if cfg.matmul_precision == "highest":
        yield
        return
    set_matmul_precision(cfg.matmul_precision)
    try:
        yield
    finally:
        set_matmul_precision("highest")


def _throughput_lines(label, n_dofs, times, iters, n_ranks=1):
    tp = [n_dofs * it / t / n_ranks for t, it in zip(times, iters)]
    for t, it, th in zip(times, iters, tp):
        pcout(f"   Solved in {it} iterations with time {t:.6f} and DoFs/s {th:.6g}")
    best = max(tp)
    pcout(f"{label} {n_dofs // n_ranks} {best:.6g}")
    pcout("")
    return best


def estimate_lambda_max(op, n_dofs, iters=12, seed=0):
    """Crude power-iteration bound on the operator spectral radius (used only
    to scale the chained vmult benchmark)."""
    u = jnp.asarray(
        np.random.default_rng(seed).standard_normal(n_dofs), dtype=op.space.dtype
    )

    def body(i, carry):
        u, lam = carry
        v = op.vmult(u)
        lam = jnp.linalg.norm(v)
        return v / lam, lam

    _, lam = jax.lax.fori_loop(0, iters, body, (u / jnp.linalg.norm(u), jnp.array(1.0, op.space.dtype)))
    return float(lam)


def run_cycle(cycle: int, cfg: BP5Config):
    mesh = BrickMesh.bp5_cycle(cycle)
    dtype = jnp.dtype(cfg.dtype)
    space = FESpace.create(mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule, dtype=dtype)
    if cfg.backend == "auto":
        cfg = dataclasses.replace(cfg, backend=auto_backend(mesh, cfg.rule))
        pcout(f"   backend auto -> {cfg.backend}")
    op = PoissonOperator(space, backend=cfg.backend)
    op.sep_mode = cfg.sep_mode
    pcout(f"Cycle {cycle}")
    pcout(f"   Number of active cells:       {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")
    pcout("")

    b = assemble_rhs(space, 1.0, backend=cfg.backend)
    b = jax.block_until_ready(b)
    norm_b = float(jnp.linalg.norm(b))
    control = IterationNumberControl(cfg.n_iterations, 1e-6 * norm_b)
    vm, diag = op.vmult, op.diagonal()

    results = {}
    solution = None

    if "pcg-standard" in cfg.modes:
        f = jax.jit(lambda b: solve_cg(vm, b, control, diag=diag))
        x, info = f(b)  # warmup/compile
        jax.block_until_ready(x)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x, info = f(b)
            t.stop(fence=(x, info["res_norm"]))
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results["pcg-standard"] = _throughput_lines(
            "pcg-standard", space.n_dofs, times, iters
        )
        solution = x

    if "pcg-merged" in cfg.modes:
        f = jax.jit(lambda b: solve_cg_merged(vm, b, control, diag=diag))
        x, info = f(b)
        jax.block_until_ready(x)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x, info = f(b)
            t.stop(fence=(x, info["res_norm"]))
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results["pcg-merged"] = _throughput_lines(
            "pcg-merged", space.n_dofs, times, iters
        )
        solution = x

    if "fdm-direct" in cfg.modes:
        # beyond the reference: the Kronecker fast-diagonalization DIRECT
        # solve (solvers/fdm.py) — one apply replaces the whole CG loop.
        # Throughput line counts the equivalent work as 1 "iteration".
        from ..solvers import FDMSolver

        fdm = FDMSolver(space)
        f = jax.jit(fdm.solve)
        x = jax.block_until_ready(f(b))
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x = f(b)
            t.stop(fence=x)
            times.append(t.elapsed)
        rel = float(jnp.linalg.norm(b - op.vmult(x)) / jnp.linalg.norm(b))
        for t in times:
            pcout(f"   FDM direct solve in time {t:.6f} (rel res {rel:.2e})")
        best = min(times)
        pcout(f"fdm-direct {space.n_dofs} {space.n_dofs / best:.6g}")
        pcout("")
        results["fdm-direct"] = space.n_dofs / best
        solution = x

    if "pcg-ir" in cfg.modes:
        # beyond the reference: mixed-precision iterative refinement to a
        # TRUE f64 relative residual of 1e-10 (solvers/ir.py) — f32
        # merged-CG inner solves, f64 residuals. Requires --dtype float64
        # (the accumulation dtype).
        if dtype != jnp.float64:
            pcout("pcg-ir requires --dtype float64 — skipping")
        else:
            from ..solvers import solve_cg_ir

            space32 = FESpace.create(
                mesh, cfg.degree, n_q=cfg.n_q, rule=cfg.rule,
                dtype=jnp.float32,
            )
            op32 = PoissonOperator(space32, backend=cfg.backend)
            x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
            jax.block_until_ready(x)
            times, its = [], []
            for _ in range(cfg.n_repetitions):
                t = Timer().start()
                x, info = solve_cg_ir(op32, op, b, rtol=1e-10)
                t.stop(fence=x)
                times.append(t.elapsed)
                its.append(int(info["n_inner"]))
            for t, it in zip(times, its):
                pcout(
                    f"   IR solved to true rel. res {info['res_rel']:.2e} "
                    f"({info['n_outer']} outer / {it} inner) in {t:.6f}"
                )
            tp = [space.n_dofs * it / t for t, it in zip(times, its)]
            pcout(f"pcg-ir {space.n_dofs} {max(tp):.6g}")
            pcout("")
            results["pcg-ir"] = max(tp)
            solution = x

    if "pcg-mg" in cfg.modes:
        # beyond the reference: geometric-multigrid-preconditioned CG
        # (solvers/multigrid.py) — converges in a mesh-independent ~10
        # iterations instead of the O(1/h) Jacobi counts
        from ..solvers import Multigrid

        mg = Multigrid(
            space,
            make_op=lambda s: PoissonOperator(s, backend="separable"),
            fine_op=op if cfg.backend == "separable" else None,
        )
        f = jax.jit(lambda b: solve_cg(op.vmult, b, control, diag=mg.vcycle))
        x, info = f(b)
        jax.block_until_ready(x)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x, info = f(b)
            t.stop(fence=(x, info["res_norm"]))
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results["pcg-mg"] = _throughput_lines("pcg-mg", space.n_dofs, times, iters)
        solution = x

    if solution is not None:
        # the TRUE residual |b - A x| / |b| (an f32 CG recurrence can fall
        # below what the iterate attains), before vmult rescales the op
        res = float(jnp.linalg.norm(b - op.vmult(solution)) / norm_b)
        pcout(f"   true relative residual: {res:.6e}")
        results["true_rel_res"] = res

    if "vmult" in cfg.modes:
        # fold the 1/lambda_est normalization into the operator tables so
        # the chain is pure back-to-back applies (no extra elementwise pass)
        lam = estimate_lambda_max(op, space.n_dofs)
        op.fold_scale(1.0 / lam)

        @jax.jit
        def chain(u):
            return jax.lax.fori_loop(0, cfg.n_iterations, lambda i, v: vm(v), u)

        u0 = b / norm_b
        with _vmult_precision(cfg):
            jax.block_until_ready(chain(u0))  # traced under the bench precision
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            out = chain(u0)
            t.stop(fence=out)
            times.append(t.elapsed)
        tp = [space.n_dofs * cfg.n_iterations / t for t in times]
        for t, th in zip(times, tp):
            pcout(f"   {cfg.n_iterations} mat-vecs in time {t:.6f} and DoFs/s {th:.6g}")
        results["vmult"] = max(tp)
        pcout(f"vmult {space.n_dofs} {max(tp):.6g}")
        pcout("")

    if cfg.validate and solution is not None:
        norm = float(l2_norm_function(space, solution))
        pcout(f"   solution L2 norm: {norm:.12g}")
        results["l2_norm"] = norm
        pcout("")
    results["solution"] = solution

    return results


_ARRAYS = ("solution",)


def auto_backend(mesh, rule: str) -> str:
    """``--backend auto``: the one-pass stencil kernel for GLL collocation
    on a (uniform or graded) brick when a GPU runs it, the XLA separable
    path for other rules on a brick (and for GLL without a GPU), the
    structured cell loop on mapped meshes."""
    if mesh.is_mapped:
        return "structured"
    if rule == "gauss_lobatto" and jax.default_backend() == "gpu":
        return "stencil"
    return "separable"


def run(cycle_min=7, cycle_max=40, cfg: BP5Config | None = None):
    cfg = cfg or BP5Config()
    out = {}
    for cycle in range(cycle_min, cycle_max + 1):
        res = run_cycle(cycle, cfg)
        # keep the numbers only: device arrays of every cycle would pile up
        out[cycle] = {k: v for k, v in res.items() if k not in _ARRAYS}
    return out


def run_cycle_distributed(
    cycle: int,
    pz: int,
    py: int = 1,
    cfg: BP5Config | None = None,
    px: int = 1,
    write_solution: str | None = None,
):
    """Distributed benchmark over a ``pz x py`` device mesh ((z, y) block
    decomposition; any shard count divides any mesh via dead-element
    padding). Runs the pcg-merged and vmult modes with the same
    reference-format per-rank output lines as the reference's multi-GPU
    runs (``bp5/step-64.cu:470-474,543-547``). The jitted SPMD solver is
    built once and reused across timed repetitions."""
    import numpy as np

    from ..parallel import (
        BlockPartition,
        DistOperator,
        make_device_mesh,
        make_dist_vmult,
        solve_cg_dist,
        solve_cg_merged_dist,
    )

    cfg = cfg or BP5Config()
    n_shards = pz * py * px
    mesh = BrickMesh.bp5_cycle(cycle)
    dtype = jnp.dtype(cfg.dtype)
    space = FESpace.create(mesh, cfg.degree, rule=cfg.rule, dtype=dtype)
    part = BlockPartition(mesh, cfg.degree, pz=pz, py=py, px=px)
    dist_op = DistOperator(part, PoissonOperator, dtype=dtype, backend=cfg.backend)
    pcout(f"Cycle {cycle} on {pz}x{py}x{px} shards")
    pcout(f"   Number of active cells:       {mesh.n_cells}")
    pcout(f"   Number of degrees of freedom: {space.n_dofs}")

    b = assemble_rhs(space, 1.0)
    norm_b = float(jnp.linalg.norm(b))
    control = IterationNumberControl(cfg.n_iterations, 1e-6 * norm_b)
    b_stacked = jnp.asarray(
        part.to_blocks(np.asarray(b).reshape(space.grid_shape))
    )
    devmesh = make_device_mesh(pz, py, px=px)
    results = {}

    if "pcg-standard" in cfg.modes:
        x, info = solve_cg_dist(dist_op, b_stacked, control, mesh=devmesh)
        jax.block_until_ready(x)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x, info = solve_cg_dist(dist_op, b_stacked, control, mesh=devmesh)
            t.stop(fence=x)
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results["pcg-standard"] = _throughput_lines(
            "pcg-standard", space.n_dofs, times, iters, n_ranks=n_shards
        )

    if "pcg-merged" in cfg.modes:
        x, info = solve_cg_merged_dist(dist_op, b_stacked, control, mesh=devmesh)
        jax.block_until_ready(x)
        times, iters = [], []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x, info = solve_cg_merged_dist(
                dist_op, b_stacked, control, mesh=devmesh
            )
            t.stop(fence=x)
            times.append(t.elapsed)
            iters.append(int(info["n_iterations"]))
        results["pcg-merged"] = _throughput_lines(
            "pcg-merged", space.n_dofs, times, iters, n_ranks=n_shards
        )
        results["n_iterations"] = iters[-1]
        # the sharded [pz*py*px blocks] solution and its partition
        results["solution"] = x
        results["partition"] = part
        if write_solution:
            # per-shard .vtr pieces + .pvtr master (the reference's
            # per-rank VTU + PVTU record, step-64/step-64.cu:560-588)
            from ..utils.vtk import write_solution_pvtr

            write_solution_pvtr(write_solution, part, np.asarray(x))
            pcout(f"   wrote {write_solution} (+ per-shard pieces)")

    if "fdm-direct" in cfg.modes:
        # distributed exact FDM solve: 8 all_to_all shard transposes
        from ..parallel import DistFDM

        dfdm = DistFDM(part, dtype=dtype, rule=cfg.rule, n_q=cfg.n_q)
        x = dfdm.solve_direct(b_stacked, mesh=devmesh)
        jax.block_until_ready(x)
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            x = dfdm.solve_direct(b_stacked, mesh=devmesh)
            t.stop(fence=x)
            times.append(t.elapsed)
        op_chk = PoissonOperator(space, backend=cfg.backend)
        x_glob = jnp.asarray(
            part.from_blocks(np.asarray(x)).reshape(-1)
        )
        rel = float(jnp.linalg.norm(b - op_chk.vmult(x_glob)) / norm_b)
        for t in times:
            pcout(f"   FDM direct solve in time {t:.6f} (rel res {rel:.2e})")
        best = min(times)
        pcout(f"fdm-direct {space.n_dofs // n_shards} {space.n_dofs / best / n_shards:.6g}")
        pcout("")
        results["fdm-direct"] = space.n_dofs / best / n_shards

    if "vmult" in cfg.modes:
        vmult = make_dist_vmult(dist_op, devmesh)
        op_single = PoissonOperator(space, backend=cfg.backend)
        lam = estimate_lambda_max(op_single, space.n_dofs)
        scale = jnp.asarray(1.0 / lam, dtype=dtype)

        @jax.jit
        def chain(u):
            def body(i, v):
                return vmult(v) * scale

            return jax.lax.fori_loop(0, cfg.n_iterations, body, u)

        u0 = b_stacked / jnp.linalg.norm(b_stacked)
        with _vmult_precision(cfg):
            jax.block_until_ready(chain(u0))  # traced under the bench precision
        times = []
        for _ in range(cfg.n_repetitions):
            t = Timer().start()
            out = chain(u0)
            t.stop(fence=out)
            times.append(t.elapsed)
        tp = [space.n_dofs * cfg.n_iterations / t / n_shards for t in times]
        for t, th in zip(times, tp):
            pcout(
                f"   {cfg.n_iterations} mat-vecs in time {t:.6f} and DoFs/s {th:.6g}"
            )
        results["vmult"] = max(tp)
        pcout(f"vmult {space.n_dofs // n_shards} {max(tp):.6g}")
        pcout("")

    return results


def main():
    from ..utils import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description="BP5 benchmark")
    ap.add_argument("--cycle-min", type=int, default=7)
    ap.add_argument("--cycle-max", type=int, default=40)
    ap.add_argument("--degree", type=int, default=5)
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--repetitions", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument(
        "--backend",
        default="structured",
        help="structured | gather | separable | stencil | auto (auto: "
        "stencil for GLL on a brick on the GPU, separable for other rules "
        "on a brick, structured on mapped meshes)",
    )
    ap.add_argument("--modes", default="pcg-standard,pcg-merged,vmult")
    ap.add_argument(
        "--shards",
        default="1",
        help="device-mesh decomposition: N (z slabs), PZxPY (2D blocks) "
        "or PZxPYxPX (full 3D)",
    )
    ap.add_argument(
        "--write-solution",
        default=None,
        help="distributed runs: write the pcg-merged solution as per-shard "
        ".vtr pieces + a .pvtr master to this path",
    )
    ap.add_argument(
        "--matmul-precision",
        default="highest",
        choices=["highest", "high", "default"],
        help="f32 matmul precision of the chained-vmult benchmark only "
        "(highest = full f32 products; high and default let XLA use TF32 "
        "on the GPU, ~1e-3 relative error per product)",
    )
    args = ap.parse_args()
    from ..utils import ensure_x64

    ensure_x64(args.dtype)
    cfg = BP5Config(
        degree=args.degree,
        n_iterations=args.iterations,
        n_repetitions=args.repetitions,
        dtype=args.dtype,
        backend=args.backend,
        modes=tuple(args.modes.split(",")),
        matmul_precision=args.matmul_precision,
    )
    parts = [int(s) for s in args.shards.split("x")]
    pz, py, px = (parts + [1, 1])[:3]
    if pz * py * px > 1:
        for cycle in range(args.cycle_min, args.cycle_max + 1):
            run_cycle_distributed(
                cycle, pz, py, cfg, px=px, write_solution=args.write_solution
            )
    else:
        run(args.cycle_min, args.cycle_max, cfg)


if __name__ == "__main__":
    main()
