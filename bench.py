#!/usr/bin/env python
"""BP5 throughput on one GPU: chained vmult and pcg-merged at p=5, GLL,
cycle 33 (12,468,001 DoFs), float32.

Runs one named operator path (``--backend``, default ``stencil``) and
times each repetition with ``block_until_ready``, compilation excluded.
Refuses to run unless JAX's first device is a GPU. Earlier lines name the
device and the card (``nvidia-smi`` name and power limit); the last line
is one JSON object:

    {"metric", "value" (vmult GDoF/s), "unit", "vs_baseline",
     "pcg_merged_gdofs", "device": {"platform", "kind", "count"}}

Throughput is the reference's: DoFs x iterations / wall time, best of the
repetitions (``bp5/step-64.cu:458-463``). vs_baseline is against the
1 GDoF/s north-star target in BASELINE.json.

    python bench.py [--backend stencil|separable]
"""

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace, IterationNumberControl, solve_cg_merged
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache
from deal_and_ceed_on_gpu_tpu.utils.device import card_line, device_record, require_gpu, result_line

CYCLE = 33
DEGREE = 5
N_APPLIES = 400  # chained applies per timed vmult run
N_ITERS = 500  # merged-CG iterations per timed solve
N_REPS = 4
DTYPE = "float32"
BASELINE_GDOFS = 1.0  # BASELINE.json north-star: >= 1 GDoF/s per card


def best_time(fn, *args) -> float:
    """Best-of-N_REPS wall time of ``fn(*args)`` after one warm-up call."""
    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(N_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def measure(space, backend):
    """``(vmult DoF/s, pcg-merged DoF/s)`` for one operator path."""
    n = space.n_dofs
    op = PoissonOperator(space, backend=backend)
    u = jnp.asarray(np.random.default_rng(0).standard_normal(n), space.dtype)
    # zero Dirichlet rows, as every assembled rhs has
    b = space.zero_constrained_values(u / jnp.linalg.norm(u))

    control = IterationNumberControl(N_ITERS, 0.0)
    solve = jax.jit(lambda b: solve_cg_merged(op.vmult, b, control))
    cg = n * N_ITERS / best_time(solve, b)

    # fold the normalization into the operator tables so each chain step
    # is one pure apply
    v = jax.jit(op.vmult)(b)
    op.fold_scale(1.0 / max(float(jnp.linalg.norm(v)), 1.0))
    chain = jax.jit(
        lambda u: jax.lax.fori_loop(0, N_APPLIES, lambda i, v: op.vmult(v), u)
    )
    vmult = n * N_APPLIES / best_time(chain, b)
    return vmult, cg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="stencil", choices=["stencil", "separable"])
    args = ap.parse_args(argv)
    require_gpu()
    enable_compilation_cache()
    print(f"device: {device_record()}")
    print(f"card: {card_line()}")
    mesh = BrickMesh.bp5_cycle(CYCLE)
    space = FESpace.create(mesh, DEGREE, rule="gauss_lobatto", dtype=jnp.dtype(DTYPE))
    vmult, cg = measure(space, args.backend)
    gdofs = vmult / 1e9
    print(
        result_line(
            metric=(
                f"BP5 vmult throughput (p={DEGREE}, {space.n_dofs} DoFs, "
                f"{DTYPE}, {args.backend})"
            ),
            value=gdofs,
            unit="GDoF/s",
            vs_baseline=gdofs / BASELINE_GDOFS,
            pcg_merged_gdofs=cg / 1e9,
        )
    )


if __name__ == "__main__":
    main()
