#!/usr/bin/env python
"""f32x2 extended-precision applies (ops/df32.py) on the device.

Three measurements per size (BP5 p=5 GLL config, reference
``bp5/step-64.cu:206`` is f64 end-to-end):
  1. accuracy vs the f64 oracle under jit (the 1e-12 bar — asserts the
     backend's codegen preserves the error-free transformations),
  2. chained-apply throughput of the df32 path,
  3. chained-apply throughput of f64 separable and of plain-f32
     separable for scale.

    python scripts/bench_f32x2.py [cycles...]   # default 26 29 33
"""
import sys
import time

sys.path.insert(0, ".")
import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import BrickMesh, FESpace
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator
from deal_and_ceed_on_gpu_tpu.ops.df32 import (
    DF32SeparableOperator,
    pack_df,
    unpack_df,
)
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache

enable_compilation_cache()
N_AP = 30


def chain_time(apply_fn, x0, n_ap, reps=3):
    @jax.jit
    def chain(x):
        return jax.lax.fori_loop(0, n_ap, lambda i, v: apply_fn(v), x)

    jax.block_until_ready(chain(x0))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x0))
        best = min(best, (time.perf_counter() - t0) / n_ap)
    return best


def run(cycle):
    mesh = BrickMesh.bp5_cycle(cycle)
    space64 = FESpace.create(mesh, 5, rule="gauss_lobatto", dtype=jnp.float64)
    n = space64.n_dofs
    op64 = PoissonOperator(space64, backend="separable")
    opdf = DF32SeparableOperator(space64, kind="stiffness")
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    x /= np.linalg.norm(x)

    # -- 1. on-chip jitted accuracy (the bar) --
    y_ref = np.asarray(jax.jit(op64.vmult)(jnp.asarray(x)))
    y_df = unpack_df(jax.jit(opdf.vmult_df)(pack_df(x)))
    err = np.linalg.norm(y_df - y_ref) / np.linalg.norm(y_ref)
    status = "PASS" if err <= 1e-12 else "FAIL"
    print(f"cycle {cycle} n={n}: jitted df32 vs f64 rel err {err:.2e} "
          f"[bar 1e-12: {status}]", flush=True)

    # -- 2. throughput: df32 chained --
    lam = float(np.linalg.norm(y_ref) / np.linalg.norm(x))
    opdf.fold_scale(1.0 / lam)
    t_df = chain_time(opdf.vmult_df, pack_df(x), N_AP)
    print(f"cycle {cycle} n={n}: df32 vmult {t_df*1e3:.3f} ms -> "
          f"{n/t_df/1e9:.3f} GDoF/s", flush=True)

    # -- 3. comparators --
    op64.fold_scale(1.0 / lam)
    t64 = chain_time(op64.vmult, jnp.asarray(x), max(4, N_AP // 6))
    print(f"cycle {cycle} n={n}: f64(emulated) vmult {t64*1e3:.3f} ms -> "
          f"{n/t64/1e9:.3f} GDoF/s", flush=True)
    space32 = FESpace.create(mesh, 5, rule="gauss_lobatto", dtype=jnp.float32)
    op32 = PoissonOperator(space32, backend="separable")
    op32.fold_scale(1.0 / lam)
    t32 = chain_time(op32.vmult, jnp.asarray(x, jnp.float32), N_AP)
    print(f"cycle {cycle} n={n}: f32 separable vmult {t32*1e3:.3f} ms -> "
          f"{n/t32/1e9:.3f} GDoF/s  (df32 = {t32/t_df:.2f}x f32 time, "
          f"f64 = {t64/t_df:.1f}x df32 time)", flush=True)


if __name__ == "__main__":
    cycles = [int(c) for c in sys.argv[1:]] or [26, 29, 33]
    for c in cycles:
        try:
            run(c)
        except Exception as e:
            print(f"cycle {c} FAILED: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
