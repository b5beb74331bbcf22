#!/usr/bin/env python
"""Tile sweep of the Triton stencil kernel (``ops/stencil.py``) on one GPU.

Times chained applies of the BP5 operator (p=5, GLL) for each candidate
``(BZ, BY, BX)`` tile and warp count, at cycle 33 in float32 and cycle 40
in float64 (the sizes ``chip_smoke.py`` runs), and checks every tile's
apply against the default tile's. The candidates run in turns, forward
then reversed, best of each; ``default_block`` should name the fastest.

    python scripts/sweep_stencil_tiles.py
"""

import sys
import time

sys.path.insert(0, ".")
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
from deal_and_ceed_on_gpu_tpu.ops.stencil import StencilOperator, default_block, stencil_apply
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache
from deal_and_ceed_on_gpu_tpu.utils.device import card_line, device_record, require_gpu

TILES = [  # ((BZ, BY, BX), num_warps)
    ((4, 8, 64), 8),
    ((2, 8, 64), 4),
    ((1, 16, 64), 4),
    ((2, 16, 64), 8),
    ((8, 8, 64), 8),
    ((1, 8, 128), 4),
]
CASES = [(33, jnp.float32, 200), (40, jnp.float64, 50)]  # cycle, dtype, applies
ROUNDS, REPS = 2, 3


def sweep(cycle, dtype, n_applies):
    space = FESpace.create(BrickMesh.bp5_cycle(cycle), 5, rule="gauss_lobatto", dtype=dtype)
    n = space.n_dofs
    kernel = StencilOperator(space.mesh, space.basis, dtype)
    # scale the operator to spectral radius ~1 so the chain neither
    # overflows nor underflows
    u = jax.random.normal(jax.random.PRNGKey(0), (n,), dtype)
    u = u / jnp.linalg.norm(u)
    apply = jax.jit(lambda v: kernel(v))
    for _ in range(12):
        v = apply(u)
        lam = float(jnp.linalg.norm(v))
        u = v / lam
    kernel.fold_scale(1.0 / lam)

    def chain_for(block, warps):
        def one(v):
            return stencil_apply(v, kernel.tables, kernel.shape, kernel.p, block=block, num_warps=warps)

        return jax.jit(one), jax.jit(lambda x: jax.lax.fori_loop(0, n_applies, lambda i, v: one(v), x))

    want = chain_for(None, None)[0](u)  # the default tile, on the scaled tables
    tol = 1e-6 if dtype == jnp.float32 else 1e-14
    chains = {}
    for block, warps in TILES:
        one, chain = chain_for(block, warps)
        err = float(jnp.max(jnp.abs(one(u) - want)) / jnp.max(jnp.abs(want)))
        if err > tol:
            raise SystemExit(f"tile {block}/{warps}: {err:.3e} off the default tile (limit {tol:g})")
        jax.block_until_ready(chain(u))  # compile
        chains[(block, warps)] = chain
    best = {key: np.inf for key in chains}
    order = list(chains)
    for r in range(ROUNDS):
        for key in order if r % 2 == 0 else order[::-1]:
            for _ in range(REPS):
                t0 = time.perf_counter()
                jax.block_until_ready(chains[key](u))
                best[key] = min(best[key], (time.perf_counter() - t0) / n_applies)
    default = default_block(dtype)
    name = jnp.dtype(dtype).name
    print(f"cycle {cycle} ({n} DoFs), {name}, {n_applies} chained applies, best of {ROUNDS * REPS}:")
    for (block, warps), t in sorted(best.items(), key=lambda kv: kv[1]):
        mark = "  <- default_block" if (block, warps) == default else ""
        print(f"   tile {block} warps {warps}: {t * 1e6:.1f} us/apply, {n / t:.6g} DoF/s{mark}", flush=True)


def main():
    require_gpu()
    enable_compilation_cache()
    print(f"card: {card_line()}")
    print(f"device: {device_record()}", flush=True)
    for cycle, dtype, n_applies in CASES:
        sweep(cycle, dtype, n_applies)


if __name__ == "__main__":
    main()
