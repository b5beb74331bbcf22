"""Break down the merged-CG iteration cost at one BP5 size (p=5 GLL,
f32): the stencil-kernel vmult vs the XLA-side dots + update passes, to
target the next solver-path optimization. Needs a GPU.

    python scripts/profile_cg_iteration.py [cycle]   # default 33
"""

import sys
import time

sys.path.insert(0, ".")
import jax
import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu import (
    BrickMesh,
    FESpace,
    IterationNumberControl,
    solve_cg_merged,
)
from deal_and_ceed_on_gpu_tpu.models import PoissonOperator
from deal_and_ceed_on_gpu_tpu.utils import enable_compilation_cache

enable_compilation_cache()

CYCLE = int(sys.argv[1]) if len(sys.argv) > 1 else 33
N = 200
mesh = BrickMesh.bp5_cycle(CYCLE)
space = FESpace.create(mesh, 5, rule="gauss_lobatto", dtype=jnp.float32)
n = space.n_dofs
op = PoissonOperator(space, backend="stencil")
print(f"cycle {CYCLE}: n={n}")

rng = np.random.default_rng(0)
u = jnp.asarray(rng.standard_normal(n), jnp.float32)
u = u / jnp.linalg.norm(u)
v = jax.block_until_ready(jax.jit(op.vmult)(u))
op.fold_scale(1.0 / max(float(jnp.linalg.norm(v)), 1.0))


def chain(fn, label, passes_guess):
    f = jax.jit(lambda w: jax.lax.fori_loop(0, N, lambda i, x: fn(x), w))
    jax.block_until_ready(f(u))
    best = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(f(u))
        best = min(best, (time.perf_counter() - t0) / N)
    gbps = passes_guess * n * 4 / best / 1e9
    print(f"{label:34s} {best*1e3:7.3f} ms/iter  ({n/best/1e9:5.2f} GDoF/s,"
          f" ~{gbps:5.0f} GB/s at {passes_guess} streams)")
    return best


t_vm = chain(op.vmult, "stencil vmult", 2.0)

# XLA-side passes in isolation (identity diag, like the benchmark solve)
g0 = u * 1.0003
h0 = u * 0.9997
x0 = jnp.zeros_like(u)


def dots_pass(d):
    dd = d
    s = jnp.stack([
        jnp.sum(dd * h0), jnp.sum(h0 * h0), jnp.sum(g0 * h0),
        jnp.sum(g0 * g0), jnp.sum(g0 * h0), jnp.sum(h0 * h0),
        jnp.sum(g0 * g0),
    ])
    return d + s[0] * 1e-30  # keep the chain data-dependent


def update_pass(d):
    a = d[0] * 1e-30 + 0.5
    b = 0.25
    g = g0 + a * h0
    x = x0 + a * d
    dn = b * d - g
    return dn + x * 1e-30 + g * 1e-30


t_dots = chain(dots_pass, "dots7 pass (3 reads)", 3.0)
t_upd = chain(update_pass, "update pass (4R + 3W)", 7.0)

# whole merged-CG iteration
control = IterationNumberControl(150, 0.0)
solver = jax.jit(lambda b: solve_cg_merged(op.vmult, b, control)[0])
jax.block_until_ready(solver(u))
best = 1e9
for _ in range(3):
    t0 = time.perf_counter()
    jax.block_until_ready(solver(u))
    best = min(best, (time.perf_counter() - t0) / 150)
print(f"{'merged-CG full iteration':34s} {best*1e3:7.3f} ms/iter  "
      f"({n/best/1e9:5.2f} GDoF/s)")
print(f"sum of parts (vmult+dots+update)   "
      f"{(t_vm+t_dots+t_upd)*1e3:7.3f} ms/iter")
