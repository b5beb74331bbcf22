"""Distributed adaptive (hanging-node) meshes over a device mesh.

The reference gets distributed adaptivity from p4est + deal.II index sets
(``parallel::distributed::Triangulation``, ``bp5/step-64.cu:310``;
owned/relevant DoF sets ``:345-348``) with CUDA-aware-MPI point-to-point
ghost exchange. This formulation replaces the irregular ghost graph
with one dense **shared-surface buffer**:

- DoFs are permuted by (z, y, x) node position and partitioned into
  equal owned slabs (padded with dead DoFs) — exact partition, no
  duplicated ownership, so dot products need no weighting beyond padding.
- Active cells go to the shard owning their smallest DoF; every shard is
  padded to the same cell count with dead cells whose coefficient tables
  are ZERO, so they contribute exactly nothing.
- Let SIGMA be the set of DoFs referenced by any non-owner shard (cell
  gathers/scatters across the partition boundary plus remote hanging-node
  masters). Each apply exchanges SIGMA with ``psum`` of per-shard
  scatters — the surface-sized, fixed-shape analog of
  ``update_ghost_values``/``compress(add)``; cell indices are remapped
  into the concatenated ``[owned | SIGMA | trash]`` space so every gather
  and scatter-add is one dense take / segment-sum.
- Hanging constraints run owner-side with padded (masters, weights)
  tables (masters are always conforming — chains are pre-resolved — so a
  single SIGMA round supplies them); the transposed condense routes
  hanging residuals back to possibly-remote masters through SIGMA.

Everything is a fixed-shape dense op inside ``shard_map``: one traced
program for all shards, bitwise deterministic.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..adaptive import AdaptivePoissonOperator, AdaptiveSpace
from ..ops import sum_factorization as sf
from ..solvers.cg_merged import solve_cg_merged
from ..solvers.control import SolverControl

__all__ = ["AdaptivePartition", "DistAdaptivePoisson", "solve_cg_merged_dist_adaptive"]


def pack_by_owner(owner_of_item, arrays, fills, n_shards, min_len=1):
    """Pack per-item rows into ``[n_shards, L, ...]`` tables, ascending
    item order within each owner (one vectorized fancy-index assignment —
    the per-cell Python loop version cost minutes at 10^5-cell setups).

    Returns the packed arrays; ``L = max(min_len, max items/owner)``;
    pad rows hold ``fills[i]``.
    """
    owner_of_item = np.asarray(owner_of_item, dtype=np.int64)
    n = owner_of_item.size
    counts = np.bincount(owner_of_item, minlength=n_shards)
    L = max(min_len, int(counts.max()) if n else 0)
    order = np.argsort(owner_of_item, kind="stable")
    starts = np.zeros(n_shards + 1, dtype=np.int64)
    starts[1:] = np.cumsum(counts)
    ow = owner_of_item[order]
    intra = np.arange(n, dtype=np.int64) - starts[ow]
    outs = []
    for arr, fill in zip(arrays, fills):
        arr = np.asarray(arr)
        out = np.full((n_shards, L) + arr.shape[1:], fill, dtype=arr.dtype)
        out[ow, intra] = arr[order]
        outs.append(out)
    return outs


def build_sigma_exchange(sigma, owner, n_loc, n_shards):
    """Per-shard owned<->SIGMA exchange tables for any SIGMA set:
    ``(osl, oss)`` with ``osl[k, i]`` the owner-local index (pad -> dead
    slot ``n_loc``) and ``oss[k, i]`` the sigma slot (pad -> trash ``S``).
    Shared by the operator's SIGMA and the MG transfer SIGMA."""
    sigma = np.asarray(sigma, dtype=np.int64)
    S = sigma.size
    loc = (sigma - owner[sigma] * n_loc).astype(np.int32)
    slots = np.arange(S, dtype=np.int32)
    osl, oss = pack_by_owner(
        owner[sigma] if S else np.zeros(0, np.int64),
        [loc, slots],
        [np.int32(n_loc), np.int32(S)],
        n_shards,
    )
    return jnp.asarray(osl), jnp.asarray(oss)


def _exchange(vals_dead, osl, oss, S, ax, dtype):
    """owned values (dead slot last) -> replicated SIGMA ``[S + 1]``."""
    sig = jnp.zeros((S + 1,), dtype).at[oss].set(vals_dead[osl])
    return jax.lax.psum(sig, ax)


def _hang_fill(u_dead, osl, oss, hl, hm, hw, n_loc, S, ax):
    """distribute: hanging rows <- sum of master weights (one SIGMA round;
    masters are conforming, chains pre-resolved)."""
    sig = _exchange(u_dead, osl, oss, S, ax, u_dead.dtype)
    u_cat = jnp.concatenate([u_dead[:n_loc], sig[:S], u_dead[n_loc:]])
    hv = jnp.sum(hw * u_cat[hm], axis=-1)
    return u_dead.at[hl].set(hv)


def _hang_fill_T(r_dead, osl, oss, hl, hm, hw, hng, n_loc, S, ax):
    """EXACT transpose of :func:`_hang_fill` (condense): hanging
    cotangents flow to their possibly-remote masters, hanging rows zero
    out. Used by both the operator apply and the MG transfers."""
    res_h = r_dead[hl]
    c_cat = (
        jnp.zeros((n_loc + S + 1,), r_dead.dtype)
        .at[hm.reshape(-1)]
        .add((hw * res_h[..., None]).reshape(-1))
    )
    sig_c = jax.lax.psum(c_cat[n_loc:], ax)
    r1 = r_dead + c_cat[: n_loc + 1].at[n_loc].set(0.0)
    r1 = r1.at[osl].add(sig_c[oss])
    return jnp.where(hng, jnp.zeros((), r1.dtype), r1)


class AdaptivePartition:
    """Host-side construction of the distributed tables for an
    :class:`AdaptiveSpace` over ``n_shards`` devices."""

    def __init__(self, space: AdaptiveSpace, n_shards: int, axis_name: str = "shard"):
        self.space = space
        self.n_shards = n_shards
        self.axis_name = axis_name
        n = space.n_dofs

        # ---- DoF permutation (z, y, x) and exact owned partition ----
        X = space.node_coords
        order = np.lexsort((X[:, 0], X[:, 1], X[:, 2]))  # z major
        self.perm = np.empty(n, dtype=np.int64)  # old id -> new id
        self.perm[order] = np.arange(n)
        n_loc = -(-n // n_shards)
        self.n_loc = n_loc
        self.n_pad = n_loc * n_shards
        owner = np.minimum(np.arange(self.n_pad) // n_loc, n_shards - 1)

        dof_map = self.perm[space._dof_map_np]  # [E, p1^3] new ids
        n_cells = space.mesh.n_cells
        cell_owner = owner[dof_map.min(axis=1)]

        hang_rows = self.perm[np.asarray(space.hang_rows, dtype=np.int64)]
        hang_cols = self.perm[np.asarray(space.hang_cols, dtype=np.int64)]
        hang_w = np.asarray(space.hang_w, dtype=np.float64)

        # ---- SIGMA: every DoF referenced by a non-owner (vectorized) ----
        remote_cell = owner[dof_map] != cell_owner[:, None]  # [E, p1^3]
        sigma = np.unique(dof_map[remote_cell])
        if hang_rows.size:
            rm = owner[hang_cols] != owner[hang_rows]
            sigma = np.union1d(sigma, hang_cols[rm])
        sigma = sigma.astype(np.int64)
        S = sigma.size
        self.n_sigma = S
        slot = np.full(self.n_pad, -1, dtype=np.int64)
        slot[sigma] = np.arange(S)
        # host-side tables reused by the level-transfer builders
        # (parallel/dist_adaptive_mg.py): permuted-DoF owners, per-cell
        # owners, and the sigma set
        self.owner = owner
        self.cell_owner = cell_owner
        self.sigma = sigma

        # index space per shard: [0, n_loc) owned | [n_loc, n_loc+S) sigma
        # | n_loc+S trash
        trash = n_loc + S

        # ---- per-shard cell tables (padded with dead cells) ----
        in_sig = slot[dof_map] >= 0
        assert (remote_cell <= in_sig).all(), "non-sigma dof referenced by non-owner"
        g = np.where(
            in_sig, n_loc + slot[dof_map], dof_map - cell_owner[:, None] * n_loc
        ).astype(np.int32)
        h = space.mesh.sizes
        det = h.prod(axis=1)
        md = np.stack(
            [det / h[:, 0] ** 2, det / h[:, 1] ** 2, det / h[:, 2] ** 2], -1
        )
        cmap, coef = pack_by_owner(
            cell_owner, [g, md], [np.int32(trash), 0.0], n_shards
        )
        self.cell_map = jnp.asarray(cmap)
        self.cell_coef = coef  # numpy; dtype applied by the operator
        # per-shard presorted scatter plans for the cell scatter-add (as
        # ops.local_global.make_scatter_plan, per shard)
        flat_c = cmap.reshape(n_shards, -1)
        order_c = np.argsort(flat_c, axis=1, kind="stable").astype(np.int32)
        self.cell_scatter_order = jnp.asarray(order_c)
        self.cell_scatter_ids = jnp.asarray(
            np.take_along_axis(flat_c, order_c, axis=1).astype(np.int32)
        )

        # ---- per-shard owned<->sigma exchange tables ----
        self.own_sig_local, self.own_sig_slot = build_sigma_exchange(
            sigma, owner, n_loc, n_shards
        )

        # ---- per-shard hanging tables (owner-side rows) ----
        # group the (row, master, weight) triplets by unique hanging row,
        # then pack rows by owner — all fancy-index assignments
        uh, inv_h = (
            np.unique(hang_rows, return_inverse=True)
            if hang_rows.size
            else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        )
        counts_h = np.bincount(inv_h, minlength=uh.size)
        K = max(1, int(counts_h.max()) if uh.size else 1)
        order_h = np.argsort(inv_h, kind="stable")
        starts_h = np.zeros(uh.size + 1, dtype=np.int64)
        starts_h[1:] = np.cumsum(counts_h)
        jrank = np.arange(inv_h.size) - starts_h[inv_h[order_h]]
        k_row = owner[hang_rows] if hang_rows.size else np.zeros(0, np.int64)
        rc_sig = slot[hang_cols] >= 0 if hang_rows.size else np.zeros(0, bool)
        rc = np.where(
            rc_sig, n_loc + slot[hang_cols], hang_cols - k_row * n_loc
        ).astype(np.int32)
        masters_d = np.full((uh.size, K), trash, dtype=np.int32)
        weights_d = np.zeros((uh.size, K))
        masters_d[inv_h[order_h], jrank] = rc[order_h]
        weights_d[inv_h[order_h], jrank] = hang_w[order_h]
        h_local, h_masters, h_weights = pack_by_owner(
            owner[uh] if uh.size else np.zeros(0, np.int64),
            [(uh - owner[uh] * n_loc).astype(np.int32), masters_d, weights_d],
            [np.int32(n_loc), np.int32(trash), 0.0],
            n_shards,
        )
        self.h_local = jnp.asarray(h_local)
        self.h_masters = jnp.asarray(h_masters)
        self.h_weights = h_weights  # numpy; dtype applied by the operator

        # ---- per-shard masks over the owned slab (+1 dead slot) ----
        con = np.zeros(self.n_pad, dtype=bool)
        hngm = np.zeros(self.n_pad, dtype=bool)
        con[self.perm[np.flatnonzero(space.constrained_mask_np)]] = True
        hngm[self.perm[np.flatnonzero(space.hanging_mask_np)]] = True
        con[n:] = True  # padding dofs act constrained (stay zero)
        self.constrained = jnp.asarray(
            np.concatenate([con.reshape(n_shards, n_loc), np.ones((n_shards, 1), bool)], 1)
        )
        self.hanging = jnp.asarray(
            np.concatenate([hngm.reshape(n_shards, n_loc), np.zeros((n_shards, 1), bool)], 1)
        )

    # ------------------------- host conversions ----------------------- #
    def to_shards(self, u: np.ndarray) -> np.ndarray:
        """Global ``[n_dofs]`` vector -> ``[n_shards, n_loc]`` owned slabs
        in the permuted order."""
        up = np.zeros(self.n_pad, dtype=np.asarray(u).dtype)
        up[self.perm] = np.asarray(u)
        return up.reshape(self.n_shards, self.n_loc)

    def from_shards(self, slabs: np.ndarray) -> np.ndarray:
        return np.asarray(slabs).reshape(-1)[self.perm]


class DistAdaptivePoisson:
    """SPMD adaptive vmult (Poisson, or Helmholtz when ``a`` is given):
    ``vmult_local`` runs inside shard_map on the owned slab ``[n_loc]``;
    tables arrive as sharded operands."""

    def __init__(self, part: AdaptivePartition, dtype=jnp.float64, a=None):
        self.part = part
        space = part.space
        self.dtype = jnp.dtype(dtype)
        b = space.basis
        self.S = jnp.asarray(b.S, dtype=dtype)
        self.D = jnp.asarray(b.D, dtype=dtype)
        w = b.q_weights
        w3 = (w[:, None, None] * w[None, :, None] * w[None, None, :])[None]
        # [n_shards, E_loc, 1,1,1] per-axis coefficients x tensor weights
        self.coef_tables = tuple(
            jnp.asarray(part.cell_coef[:, :, d, None, None, None] * w3, dtype=dtype)
            for d in range(3)
        )
        # optional Helmholtz value term: a(x_q) * JxW per packed shard cell
        # (dead padding cells carry exact zeros, like the metric tables)
        self.has_value_term = a is not None
        if a is not None:
            from ..adaptive import _cell_qpoints

            aq = np.asarray(a(_cell_qpoints(space)), dtype=np.float64)
            det = space.mesh.sizes.prod(axis=1)
            a_jxw = aq * det[:, None, None, None] * w3
            (packed,) = pack_by_owner(
                part.cell_owner, [a_jxw], [0.0], part.n_shards,
                min_len=part.cell_map.shape[1],
            )
            self._a_jxw = jnp.asarray(packed, dtype=dtype)
        else:
            # fixed-shape placeholder so the operand list is static
            self._a_jxw = jnp.zeros(
                (part.cell_map.shape[0], 1, 1, 1, 1), dtype=dtype
            )
        self.h_weights = jnp.asarray(part.h_weights, dtype=dtype)
        self._solver_cache = {}

    #: shard_operands tuple order — downstream consumers (the distributed
    #: MG's table slicing) resolve positions by name from this, never by
    #: magic index
    OPERAND_NAMES = (
        "cell_map", "cwx", "cwy", "cwz", "a_jxw", "sc_order", "sc_ids",
        "osl", "oss", "hl", "hm", "hw", "con", "hng",
    )

    @property
    def shard_operands(self):
        p = self.part
        return (
            p.cell_map,
            *self.coef_tables,
            self._a_jxw,
            p.cell_scatter_order,
            p.cell_scatter_ids,
            p.own_sig_local,
            p.own_sig_slot,
            p.h_local,
            p.h_masters,
            self.h_weights,
            p.constrained,
            p.hanging,
        )

    def operand_specs(self, axis_name=None):
        ax = axis_name or self.part.axis_name
        return tuple(
            P(ax, *([None] * (np.ndim(t) - 1))) for t in self.shard_operands
        )

    def vmult_local(self, u, *tables):
        """u: owned slab (shape ``[n_loc]`` or ``[1, n_loc]`` under
        shard_map). All table operands carry a leading length-1 shard
        axis (consumed by shard_map)."""
        shape = u.shape
        return self._vmult_flat(u.reshape(-1), *tables).reshape(shape)

    def _vmult_flat(
        self, u, cmap, cwx, cwy, cwz, a_jxw, sco, sci,
        osl, oss, hl, hm, hw, con, hng,
    ):
        part = self.part
        ax = part.axis_name
        n_loc, S = part.n_loc, part.n_sigma
        (cmap, cwx, cwy, cwz, a_jxw, sco, sci, osl, oss, hl, hm, hw, con, hng) = (
            t.reshape(t.shape[1:])
            for t in (
                cmap, cwx, cwy, cwz, a_jxw, sco, sci,
                osl, oss, hl, hm, hw, con, hng,
            )
        )
        zero = jnp.zeros((), u.dtype)

        u1 = jnp.where(con[: n_loc + 1], zero, jnp.pad(u, (0, 1)))
        # hanging fill (distribute): masters are conforming, one round
        u1 = _hang_fill(u1, osl, oss, hl, hm, hw, n_loc, S, ax)
        u_cat = jnp.concatenate(
            [u1[:n_loc], _exchange(u1, osl, oss, S, ax, u.dtype)[:S], u1[n_loc:]]
        )

        # cell loop (dead cells have zero coefficients)
        ul = u_cat[cmap].reshape(cmap.shape[0], *([self.S.shape[1]] * 3))
        vals, grads = sf.evaluate(
            ul, self.S, self.D, (1, 2, 3), self.has_value_term, True, True
        )
        gx, gy, gz = grads
        vl = sf.integrate(
            vals * a_jxw if self.has_value_term else None,
            (gx * cwx, gy * cwy, gz * cwz),
            self.S,
            self.D,
            (1, 2, 3),
            True,
        )
        v_cat = jax.ops.segment_sum(
            vl.reshape(-1)[sco], sci, n_loc + S + 1, indices_are_sorted=True
        )
        sig_v = jax.lax.psum(v_cat[n_loc : n_loc + S + 1], ax)
        v1 = jnp.pad(v_cat[:n_loc], (0, 1)).at[osl].add(sig_v[oss])

        # condense (transpose of the fill): hanging residuals -> masters
        # (maybe remote), hanging rows zeroed
        v1 = _hang_fill_T(
            v1, osl, oss, hl, hm, hw, hng[: n_loc + 1], n_loc, S, ax
        )

        out = jnp.where(con[: n_loc + 1], jnp.pad(u, (0, 1)), v1)
        return out[:n_loc]


def make_device_mesh_1d(n_shards: int, axis_name: str = "shard") -> Mesh:
    return Mesh(np.asarray(jax.devices()[:n_shards]), (axis_name,))


def solve_cg_merged_dist_adaptive(
    dist_op: DistAdaptivePoisson,
    b_shards: jnp.ndarray,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
):
    """b_shards: ``[n_shards, n_loc]`` owned slabs
    (``AdaptivePartition.to_shards``). Returns ``(x_shards, info)``."""
    part = dist_op.part
    ax = part.axis_name
    mesh = mesh or make_device_mesh_1d(part.n_shards, ax)
    key = ("solve", control, mesh)
    run = dist_op._solver_cache.get(key)
    if run is None:
        specs = dist_op.operand_specs()

        def local_solve(b_loc, *tables):
            x, info = solve_cg_merged(
                lambda u: dist_op.vmult_local(u, *tables),
                b_loc,
                control,
                psum_axis=ax,
            )
            return x, info["n_iterations"], info["res_norm"], info["res0"]

        jitted = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(P(ax),) + specs,
                out_specs=(P(ax), P(), P(), P()),
            )
        )

        def run(b):
            x, it, res, res0 = jitted(b, *dist_op.shard_operands)
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}

        dist_op._solver_cache[key] = run
    return run(jnp.asarray(b_shards).reshape(part.n_shards, part.n_loc))
