"""Distributed AMR: the solve -> estimate -> mark -> refine loop with
SPMD solves over the device mesh.

Each step repartitions the current adaptive space (exact owned slabs +
shared-surface SIGMA exchange, :class:`.dist_adaptive.AdaptivePartition`)
and solves it distributed — global-coarsening multigrid CG by default
(level-independent iterations), or plain merged CG. Estimation runs
SPMD too (:func:`estimate_gradient_recovery_dist`): ZZ gradient recovery
per owned cell block over the partition's existing SIGMA exchange, so
the only host traffic per AMR step is one scalar indicator per cell —
never the O(global-N) solution vector. Marking is a global decision
(the reference's p4est repartitions host-side the same way,
`bp5/step-64.cu:310`), so Doerfler marking stays on host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..adaptive import (
    AdaptiveMesh,
    AdaptiveSpace,
    assemble_rhs_adaptive,
    mark_doerfler,
)
from ..mesh import BrickMesh
from ..ops import sum_factorization as sf
from ..solvers.control import ReductionControl
from .dist_adaptive import (
    AdaptivePartition,
    DistAdaptivePoisson,
    _exchange,
    _hang_fill,
    make_device_mesh_1d,
    pack_by_owner,
    solve_cg_merged_dist_adaptive,
)
from .dist_adaptive_mg import DistAdaptiveMultigrid, solve_cg_mg_dist_adaptive

__all__ = ["amr_loop_distributed", "estimate_gradient_recovery_dist"]


def _estimator_tables(part: AdaptivePartition, dtype):
    """Packed per-shard tables the estimator needs beyond the operator's:
    1/h per axis, JxW (= det * tensor weights) per cell, and the global
    cell id of every packed slot (pads -> -1) for host unpacking. Cached
    on the partition (shared across dtypes via the f64 masters)."""
    key = ("zz_tables", jnp.dtype(dtype))
    cached = getattr(part, "_est_cache", None)
    if cached is None:
        cached = part._est_cache = {}
    if key in cached:
        return cached[key]
    s = part.space
    b = s.basis
    w = b.q_weights
    w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None]
    h = s.mesh.sizes  # [E, 3]
    det = h.prod(axis=1)
    jxw = det[:, None, None, None] * w3
    E_loc = part.cell_map.shape[1]
    inv_h, jxw_p, ids = pack_by_owner(
        part.cell_owner,
        [1.0 / h, jxw, np.arange(s.mesh.n_cells, dtype=np.int64)],
        [0.0, 0.0, np.int64(-1)],
        part.n_shards,
        min_len=E_loc,
    )
    out = (
        jnp.asarray(inv_h, dtype=dtype),
        jnp.asarray(jxw_p, dtype=dtype),
        ids,  # host numpy
        jnp.asarray(b.S, dtype=dtype),
        jnp.asarray(b.D, dtype=dtype),
    )
    cached[key] = out
    return out


def estimate_gradient_recovery_dist(
    part: AdaptivePartition,
    u_shards: jnp.ndarray,
    dtype=jnp.float64,
    mesh: Optional[Mesh] = None,
) -> np.ndarray:
    """SPMD counterpart of :func:`..adaptive.estimate_gradient_recovery`
    (ZZ recovery, `eta_K^2 = int_K |grad u_h - R(grad u_h)|^2`): each
    shard evaluates the discontinuous gradient on its owned cell block,
    node-averages it through the partition's SIGMA ``psum`` exchange
    (multiplicity counts and recovered-gradient sums both ride the
    operator's presorted segment-sum scatter plan), and reduces one
    ``eta_K^2`` scalar per owned cell. The host receives ``n_cells``
    scalars — the global solution vector is never gathered (the
    reference's KellyErrorEstimator analog runs rank-local
    over ghosted vectors the same way).

    Owner-interior nodes accumulate in the exact order the host
    estimator uses (ascending cell id), so their recovery is bitwise
    identical; SIGMA (shard-boundary) nodes differ only by f64 psum
    association (~1e-16 relative), which cannot flip the marked set
    because :func:`..adaptive.mark_doerfler` tie-classes indicators at
    1e-12 relative. Returns host ``[n_cells]`` eta."""
    ax = part.axis_name
    n_loc, S = part.n_loc, part.n_sigma
    dtype = jnp.dtype(dtype)
    inv_h, jxw_p, ids, Smat, Dmat = _estimator_tables(part, dtype)
    mesh = mesh or make_device_mesh_1d(part.n_shards, ax)

    cache = getattr(part, "_est_fn_cache", None)
    if cache is None:
        cache = part._est_fn_cache = {}
    run = cache.get((dtype, mesh))
    if run is None:
        q1 = int(Smat.shape[1])

        def local(u, cmap, sco, sci, osl, oss, hl, hm, hw, inv_h, jxw):
            (cmap, sco, sci, osl, oss, hl, hm, hw, inv_h, jxw) = (
                t.reshape(t.shape[1:])
                for t in (cmap, sco, sci, osl, oss, hl, hm, hw, inv_h, jxw)
            )
            u1 = jnp.pad(u.reshape(-1).astype(dtype), (0, 1))
            # hanging rows <- masters (one SIGMA round), as the host
            # estimator's space.distribute does
            u1 = _hang_fill(u1, osl, oss, hl, hm, hw, n_loc, S, ax)
            u_cat = jnp.concatenate(
                [u1[:n_loc], _exchange(u1, osl, oss, S, ax, dtype)[:S], u1[n_loc:]]
            )
            ul = u_cat[cmap].reshape(cmap.shape[0], q1, q1, q1)
            _, grads = sf.evaluate(ul, Smat, Dmat, (1, 2, 3), False, True, True)

            def reduce_nodal(field):
                # scatter-add over [owned | SIGMA | trash], psum the
                # SIGMA+trash tail, fold remote contributions back in
                c = jax.ops.segment_sum(
                    field.reshape(-1)[sco], sci, n_loc + S + 1,
                    indices_are_sorted=True,
                )
                sig = jax.lax.psum(c[n_loc:], ax)
                return jnp.pad(c[:n_loc], (0, 1)).at[osl].add(sig[oss])

            counts = reduce_nodal(jnp.ones(ul.shape, dtype))
            counts = jnp.where(counts > 0, counts, jnp.ones((), dtype))
            eta2 = jnp.zeros((cmap.shape[0],), dtype)
            for d in range(3):
                g = grads[d] * inv_h[:, d, None, None, None]
                R = reduce_nodal(g) / counts
                R_cat = jnp.concatenate(
                    [R[:n_loc], _exchange(R, osl, oss, S, ax, dtype)[:S], R[n_loc:]]
                )
                diff = g - R_cat[cmap].reshape(g.shape)
                eta2 = eta2 + jnp.sum(diff * diff * jxw, axis=(1, 2, 3))
            return eta2.reshape(1, -1)

        specs = (
            P(ax), P(ax, None), P(ax, None), P(ax, None), P(ax, None),
            P(ax, None), P(ax, None), P(ax, None, None), P(ax, None, None),
            P(ax, None, None), P(ax, None, None, None, None),
        )
        jitted = jax.jit(
            jax.shard_map(
                local, mesh=mesh, in_specs=specs, out_specs=P(ax, None)
            )
        )

        def run(u_sh):
            p = part
            return jitted(
                u_sh, p.cell_map, p.cell_scatter_order, p.cell_scatter_ids,
                p.own_sig_local, p.own_sig_slot, p.h_local, p.h_masters,
                jnp.asarray(p.h_weights, dtype=dtype), inv_h, jxw_p,
            )

        cache[(dtype, mesh)] = run

    eta2_sh = np.asarray(run(jnp.asarray(u_shards).reshape(part.n_shards, n_loc)))
    eta = np.zeros(part.space.mesh.n_cells)
    real = ids >= 0
    eta[ids[real]] = np.sqrt(np.maximum(eta2_sh[real], 0.0))
    return eta


def amr_loop_distributed(
    base: BrickMesh,
    degree: int,
    n_shards: int,
    f=1.0,
    n_steps: int = 3,
    theta: float = 0.5,
    reduction: float = 1e-10,
    max_iterations: int = 800,
    precond: str = "mg",
    dtype=jnp.float64,
    keep_solutions: bool = True,
):
    """Distributed counterpart of :func:`..adaptive.amr_loop`; same
    history records plus ``n_shards``. ``precond``: "mg" (distributed
    global-coarsening V-cycle) or "none" (distributed merged CG).
    ``keep_solutions=False`` drops the gathered global field from the
    history records (``"x": None``) — with the SPMD estimator the AMR
    decision loop itself never gathers anything larger than one scalar
    per cell, so this makes the whole loop O(surface + n_cells) in
    host traffic."""
    mesh = AdaptiveMesh.from_brick(base)
    history = []
    for step in range(n_steps + 1):
        space = AdaptiveSpace(mesh, degree, dtype=dtype)
        part = AdaptivePartition(space, n_shards)
        b = assemble_rhs_adaptive(space, f)
        b_sh = part.to_shards(np.asarray(b))
        control = ReductionControl(
            max_iterations, tolerance=0.0, reduction=reduction
        )
        if precond == "mg" and int(mesh.levels.max()) > 0:
            dmg = DistAdaptiveMultigrid(part, dtype=dtype)
            x_sh, info = solve_cg_mg_dist_adaptive(dmg, b_sh, control)
        else:
            dop = DistAdaptivePoisson(part, dtype=dtype)
            x_sh, info = solve_cg_merged_dist_adaptive(
                dop, jnp.asarray(b_sh), control
            )
        # SPMD ZZ estimate over the SIGMA exchange: only per-cell
        # indicator scalars come to host, never the solution vector
        eta = estimate_gradient_recovery_dist(part, x_sh, dtype=dtype)
        # the recorded solution (history consumers want the global field;
        # not part of the AMR decision loop)
        x = (
            jnp.asarray(part.from_shards(np.asarray(x_sh)))
            if keep_solutions
            else None
        )
        history.append(
            {
                "space": space,
                "x": x,
                "n_dofs": space.n_dofs,
                "n_cells": mesh.n_cells,
                "n_shards": n_shards,
                "eta": float(np.sqrt((eta**2).sum())),
                "eta_cells": eta,
                "n_iterations": int(info["n_iterations"]),
            }
        )
        if step < n_steps:
            mesh = mesh.refine_active(mark_doerfler(eta, theta))
    return history
