#!/usr/bin/env python
"""Proof that the program's main path runs on one GPU, checked against its
plain references.

    python chip_smoke.py            # one card: the phases below
    python chip_smoke.py --multi    # four cards: BP5 on 2x2 shards only

Phases (one card, one process):

1. platform: refuse unless JAX's first device is a GPU; print the card's
   name and power limit (``nvidia-smi``) and the JAX device record.
2. oracle: the Triton stencil kernel (``ops/stencil.py``) against the dense
   assembled matrix (``utils/oracle.py``) at BP5 cycle 7, f64 (rel 1e-10).
3. BP5 through ``drivers/bp5.run_cycle`` (p=5, GLL, pcg-merged + chained
   vmult) at cycle 33 in f32 and at cycle 40 in f64, on the stencil kernel,
   on the XLA separable path with matmul sweeps (the plain reference) and
   with shifted-add sweeps (XLA's fastest form); the DoF/s of all three
   are printed side by side. Checks at the timed size: the kernel against
   separable at ``Precision.HIGHEST`` on a random vector and on the
   solve's output, as ``max|A x - A' x| / max(|A| |x|)`` with ``|A|``
   built from separable's 1D factors (f32 1e-5, f64 1e-12); each solve's
   TRUE residual ``|b - A x| / |b|`` under the reference operator against
   the reference solve's (within 1% + the operator tolerance).
4. step-64 (Q3, f64, refine 2): 60 CG iterations and solution L2 norm
   0.020526851356887806 (rel 1e-9), plain and merged CG.

``--multi`` runs only BP5 f64 through ``run_cycle_distributed`` on 2x2
shards over four cards, compares its pcg-merged solution with the
single-card solve of the same system (rel 1e-10), and checks from
``memory_stats()`` that every card holds its shard.

Any failed check raises: the process exits non-zero and prints no result.
The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
from deal_and_ceed_on_gpu_tpu.drivers import bp5, step64
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator, assemble_rhs
from deal_and_ceed_on_gpu_tpu.ops.separable import apply_separable, poisson_terms
from deal_and_ceed_on_gpu_tpu.ops.stencil import StencilOperator
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache, oracle
from deal_and_ceed_on_gpu_tpu.utils.device import card_line, device_record, require_gpu, result_line

F32_CYCLE = 33  # 12,468,001 DoFs
F64_CYCLE = 40  # 131,892,801 DoFs, the end of the reference sweep
MULTI_CYCLE = 36  # 33,076,161 DoFs
ORACLE_CYCLE = 7
OP_TOL = {jnp.float32: 1e-5, jnp.float64: 1e-12}
# (label, backend, separable sweep mode): the kernel, the plain reference
# (matmul sweeps at HIGHEST), and XLA's fastest form of the same operator
RUNS = (
    ("stencil", "stencil", "matmul"),
    ("separable", "separable", "matmul"),
    ("separable-shifted", "separable", "stencil"),
)
STEP64_ITERS = 60
STEP64_L2 = 0.020526851356887806


def rel(a, b, scale=None) -> float:
    """max |a - b| over max |scale| (default ``b``)."""
    scale = b if scale is None else scale
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(scale)))


def abs_reference(space: FESpace):
    """``x -> |A| |x|`` for the constrained BP5 operator, built from the
    separable path's own 1D factors (``|bands|``, ``|weights|``; identity
    rows on the Dirichlet set), never from the kernel under test. It bounds
    the terms that round, so ``|A x - A' x| / (|A| |x|)`` measures rounding
    for any x, also for a smooth x whose ``A x`` cancels."""
    terms = [
        {
            "coef": abs(t["coef"]),
            "diag": None if t["diag"] is None else jnp.abs(t["diag"]),
            "band": [(ax, jnp.abs(m), jnp.abs(bd), p) for ax, m, bd, p in t["band"]],
        }
        for t in poisson_terms(space.mesh, space.basis, space.dtype)
    ]
    mask = space.dirichlet_mask

    def apply(x):
        ax = jnp.where(mask, 0, jnp.abs(x)).reshape(space.grid_shape)
        out = apply_separable(ax, terms, mode="stencil").reshape(-1)
        return jnp.where(mask, jnp.abs(x), out)

    return jax.jit(apply)


def check(name: str, value: float, limit: float) -> None:
    ok = value <= limit
    print(f"   {'PASS' if ok else 'FAIL'} {name}: {value:.3e} <= {limit:.3g}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} = {value:.3e} exceeds {limit:.3g}")


def peak_bytes(device) -> int:
    """The most device memory the process's arrays have held on ``device``."""
    return device.memory_stats()["peak_bytes_in_use"]


def space_for(cycle: int, dtype) -> FESpace:
    return FESpace.create(BrickMesh.bp5_cycle(cycle), 5, rule="gauss_lobatto", dtype=dtype)


def phase_oracle(cycle: int = ORACLE_CYCLE) -> None:
    print(f"== oracle: stencil kernel vs dense matrix, BP5 cycle {cycle}, f64", flush=True)
    space = space_for(cycle, jnp.float64)
    mesh = space.mesh
    A = oracle.assemble_sparse(mesh, space.basis, "stiffness")
    u = np.random.default_rng(1).standard_normal(space.n_dofs)
    want = oracle.apply_constrained(A, mesh.boundary_dof_mask(5), u)
    got = jax.jit(StencilOperator(mesh, space.basis, jnp.float64))(jnp.asarray(u))
    check("stencil vs oracle (f64)", rel(got, jnp.asarray(want)), 1e-10)


def phase_bp5(cycle: int, dtype, n_iterations: int = 200, n_repetitions: int = 3) -> dict:
    name = jnp.dtype(dtype).name
    print(f"== BP5 cycle {cycle}, {name}: pcg-merged + vmult, stencil vs separable", flush=True)
    tol = OP_TOL[dtype]
    cfg = bp5.BP5Config(
        dtype=name, n_iterations=n_iterations, n_repetitions=n_repetitions,
        modes=("pcg-merged", "vmult"),
    )
    t0 = time.perf_counter()
    space = space_for(cycle, dtype)
    ref_op = PoissonOperator(space, backend="separable")  # matmul sweeps, HIGHEST
    kernel = StencilOperator(space.mesh, space.basis, dtype)
    b = assemble_rhs(space, 1.0)
    print(f"   host setup {time.perf_counter() - t0:.1f} s", flush=True)
    u = jax.random.normal(jax.random.PRNGKey(0), (space.n_dofs,), dtype)
    ref_apply, k_apply = jax.jit(ref_op.vmult), jax.jit(kernel)
    abs_apply = abs_reference(space)
    check(
        f"stencil vs separable on a random vector ({name})",
        rel(k_apply(u), ref_apply(u), abs_apply(u)), tol,
    )

    runs = {}
    for label, backend, sep_mode in RUNS:
        res = bp5.run_cycle(cycle, dataclasses.replace(cfg, backend=backend, sep_mode=sep_mode))
        x = res.pop("solution")
        assert x.shape == (space.n_dofs,) and bool(jnp.all(jnp.isfinite(x))), label
        true_res = float(jnp.linalg.norm(b - ref_apply(x)) / jnp.linalg.norm(b))
        print(f"   {label}: true relative residual under the reference operator {true_res:.6e}")
        if label == "stencil":
            check(
                f"stencil vs separable on the solution ({name})",
                rel(k_apply(x), ref_apply(x), abs_apply(x)), tol,
            )
        runs[label] = dict(res, true_res=true_res)
        del x
    r = runs["separable"]
    for label in ("stencil", "separable-shifted"):
        check(
            f"solve true residual, {label} over separable ({name})",
            runs[label]["true_res"] / r["true_res"], 1.01 + tol / r["true_res"],
        )
    print("   L2 norm " + ", ".join(f"{k} {v['l2_norm']:.12g}" for k, v in runs.items()))
    for mode in ("vmult", "pcg-merged"):
        s = runs["stencil"][mode]
        print(
            f"   {mode} DoF/s: " + ", ".join(f"{k} {v[mode]:.6g}" for k, v in runs.items())
            + "; stencil over " + ", ".join(
                f"{k} {s / v[mode]:.3f}" for k, v in runs.items() if k != "stencil"
            ),
            flush=True,
        )
    return runs


def phase_step64() -> None:
    print("== step-64: Q3 Helmholtz, refine 2, f64, structured", flush=True)
    for merged in (False, True):
        r = step64.run(n_refine=2, degree=3, dtype="float64", use_merged=merged)
        check(f"step-64 iterations (merged={merged}) - {STEP64_ITERS}",
              abs(r["n_iterations"] - STEP64_ITERS), 0)
        check(f"step-64 L2 norm (merged={merged})",
              abs(r["l2_norm"] - STEP64_L2) / STEP64_L2, 1e-9)


def phase_multi(cycle: int = MULTI_CYCLE, n_iterations: int = 200) -> None:
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--multi needs four devices, JAX sees {len(devs)}")
    print(f"== BP5 cycle {cycle}, f64, 2x2 shards on four cards vs one card", flush=True)
    cfg = bp5.BP5Config(
        dtype="float64", backend="separable", n_iterations=n_iterations,
        n_repetitions=3, modes=("pcg-merged", "vmult"),
    )
    dist = bp5.run_cycle_distributed(cycle, 2, 2, cfg)
    xs, part = dist["solution"], dist["partition"]
    shard_devs = {sh.device for sh in xs.addressable_shards}
    check("cards without a shard of the solution", len(set(devs[:4]) - shard_devs), 0)
    shard_bytes = xs.nbytes // 4
    for d in devs[:4]:
        peak = peak_bytes(d)
        print(f"   {d}: peak {peak / 2**30:.3f} GiB, shard {shard_bytes / 2**30:.3f} GiB")
        check(f"{d} holds less than its shard (bytes short)", max(shard_bytes - peak, 0), 0)
    x_dist = part.from_blocks(np.asarray(xs)).reshape(-1)
    single = bp5.run_cycle(cycle, cfg)
    x_one = np.asarray(single.pop("solution"))
    check("distributed vs single-card solution (f64)", rel(jnp.asarray(x_dist), jnp.asarray(x_one)), 1e-10)
    print(f"   pcg-merged DoF/s per card: 4 cards {dist['pcg-merged']:.6g}, one card {single['pcg-merged']:.6g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="GPU smoke test of the main path")
    ap.add_argument("--multi", action="store_true", help="only the four-card BP5 phase")
    args = ap.parse_args(argv)
    require_gpu()
    jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()
    print(f"card: {card_line()}")
    print(f"device: {device_record()}", flush=True)
    if args.multi:
        phase_multi()
    else:
        phase_oracle()
        phase_bp5(F32_CYCLE, jnp.float32)
        phase_bp5(F64_CYCLE, jnp.float64)
        phase_step64()
    print(result_line())


if __name__ == "__main__":
    main()
