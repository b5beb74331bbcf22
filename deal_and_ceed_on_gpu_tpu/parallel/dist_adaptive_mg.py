"""Distributed adaptive multigrid: global-coarsening h-MG as an SPMD program.

Composition of :mod:`..solvers.adaptive_mg` (clamped-level hierarchy,
nodal-embedding transfers, Chebyshev smoothing) with the shared-surface
distributed adaptive machinery (:mod:`.dist_adaptive`): level-independent
CG iteration counts on hanging-node meshes AT SCALE — beyond the
reference, whose AMR support stops at in-kernel constraint resolution
(`bp5/fe_evaluation_gl.h:150-151,167-168`) and whose only preconditioner
is the identity diagonal (`bp5/step-64.cu:428-432`).

Every level gets its own :class:`AdaptivePartition` (exact owned-slab DoF
partition + SIGMA shared-surface exchange) and
:class:`DistAdaptivePoisson` (the smoother's vmult). Transfers between
levels reuse the same dense fixed-shape pattern:

- **Prolongation**: coarse hanging fill (owner-side, one SIGMA round) ->
  one transfer-SIGMA exchange (the coarse DoFs referenced by remote fine
  cells) -> per-fine-cell gather -> three per-axis embedding einsums
  (child-half Lagrange matrices picked per cell) -> scatter into the fine
  ``[owned | SIGMA | trash]`` space -> ``psum`` compress -> global
  multiplicity average -> boundary mask -> fine hanging fill.
- **Restriction** is the MANUAL EXACT TRANSPOSE of that chain, step by
  step (condense replaces distribute, gather/scatter and exchange/compress
  swap, the embedding matrices transpose) — verified bit-tight against
  ``jax.linear_transpose`` of the single-device prolongation in tests.
- **Coarse solve**: ``all_gather`` the (tiny, conforming base-brick)
  residual slabs, apply the permuted dense f64 inverse redundantly on
  every shard, slice the owned slab back out.

Setup (level diagonals, Chebyshev bounds, dense coarse inverse) runs on
the single-device global operators — the spectrum is identical and setup
is one-time, exactly like :class:`.dist_multigrid.DistMultigrid`.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..adaptive import AdaptivePoissonOperator, AdaptiveSpace
from ..solvers.adaptive_mg import (
    AdaptiveMultigrid,
    _embed_mats,
    _power_bounds,
    adaptive_hierarchy,
    dense_coarse_inverse,
)
from ..solvers.cg import solve_cg
from ..solvers.control import SolverControl
from ..solvers.multigrid import chebyshev_smooth
from .dist_adaptive import (
    AdaptivePartition,
    DistAdaptivePoisson,
    _exchange,
    _hang_fill,
    _hang_fill_T,
    build_sigma_exchange,
    make_device_mesh_1d,
    pack_by_owner,
)

__all__ = ["DistAdaptiveMultigrid", "solve_cg_mg_dist_adaptive"]


class _Transfer:
    """Host-side per-shard tables for one fine->coarse level pair.

    Packs the transfer work cell-by-cell in the SAME order as
    ``part_f.cell_map`` (ascending fine cell id within each owner shard),
    so the fine-side scatter/gather reuses ``part_f``'s cell table and
    SIGMA exchange unchanged.
    """

    def __init__(
        self,
        part_c: AdaptivePartition,
        part_f: AdaptivePartition,
        src_cell: np.ndarray,
        axis_pick: np.ndarray,
    ):
        fine, coarse = part_f.space, part_c.space
        n_sh = part_f.n_shards

        dof_map_c = part_c.perm[coarse._dof_map_np]  # coarse new ids
        cmap_src = dof_map_c[np.asarray(src_cell)]  # [E_f, P3]
        owner_c = part_c.owner
        cell_owner = part_f.cell_owner

        # transfer SIGMA: coarse DoFs referenced by a fine cell whose
        # owner shard does not own them
        remote = owner_c[cmap_src] != cell_owner[:, None]
        sigT = np.unique(cmap_src[remote])
        S_T = sigT.size
        self.n_sigma = S_T
        slotT = np.full(part_c.n_pad, -1, dtype=np.int64)
        slotT[sigT] = np.arange(S_T)
        trash_c = part_c.n_loc + S_T

        # per-cell coarse gather ids in [owned_c | SIGMA_T | trash],
        # packed per owner in the SAME order as part_f.cell_map
        local = cmap_src - cell_owner[:, None] * part_c.n_loc
        g = np.where(remote, part_c.n_loc + slotT[cmap_src], local).astype(
            np.int32
        )
        E_loc = part_f.cell_map.shape[1]
        tc, pk = pack_by_owner(
            cell_owner,
            [g, np.asarray(axis_pick, dtype=np.int32)],
            [np.int32(trash_c), np.int32(0)],
            n_sh,
            min_len=E_loc,
        )
        self.tc_map = jnp.asarray(tc)
        self.pick = jnp.asarray(pk)

        # presorted scatter plan for the coarse-side transfer scatter
        # (restriction 2^T) — as for the operator's cell scatter
        flat_t = tc.reshape(n_sh, -1)
        order_t = np.argsort(flat_t, axis=1, kind="stable").astype(np.int32)
        self.tc_order = jnp.asarray(order_t)
        self.tc_ids = jnp.asarray(
            np.take_along_axis(flat_t, order_t, axis=1).astype(np.int32)
        )

        # coarse owned <-> SIGMA_T exchange tables
        self.oslT, self.ossT = build_sigma_exchange(
            sigT, owner_c, part_c.n_loc, n_sh
        )

        # fine global DoF multiplicity (duplicate-write averaging) and
        # BOUNDARY-only mask, as owned slabs with a dead slot
        dof_map_f = part_f.perm[fine._dof_map_np]
        mult = np.bincount(
            dof_map_f.reshape(-1), minlength=part_f.n_pad
        ).astype(np.float64)
        inv_mult = 1.0 / np.maximum(mult, 1.0)
        inv_mult = inv_mult.reshape(n_sh, part_f.n_loc)
        self.inv_mult_np = np.concatenate(
            [inv_mult, np.ones((n_sh, 1))], axis=1
        )
        bnd = np.zeros(part_f.n_pad, dtype=bool)
        bnd[part_f.perm[np.flatnonzero(fine.boundary_mask_np)]] = True
        bnd[fine.n_dofs :] = True  # padding DoFs stay zero
        self.bnd = jnp.asarray(
            np.concatenate(
                [bnd.reshape(n_sh, part_f.n_loc), np.ones((n_sh, 1), bool)], 1
            )
        )

    N_OPERANDS = 8

    def operands(self, inv_mult):
        return (
            self.tc_map, self.pick, self.tc_order, self.tc_ids,
            self.oslT, self.ossT, inv_mult, self.bnd,
        )


class DistAdaptiveMultigrid:
    """SPMD global-coarsening multigrid over :class:`AdaptivePartition`.

    ``vcycle_local`` is the per-shard preconditioner callable used inside
    ``shard_map`` by :func:`solve_cg_mg_dist_adaptive`; constructor knobs
    mirror :class:`~..solvers.adaptive_mg.AdaptiveMultigrid`.
    """

    def __init__(
        self,
        part: AdaptivePartition,
        dtype=jnp.float64,
        n_smooth: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 8000,
        a=None,
    ):
        """``a``: optional Helmholtz coefficient ``a(x)`` — every level's
        operator (smoother vmult, diagonal, coarse matrix) rediscretizes
        it at its own quadrature points."""
        space = part.space
        self.dtype = jnp.dtype(dtype)
        self.n_smooth = n_smooth
        ax = part.axis_name
        self.axis_name = ax
        n_sh = part.n_shards

        meshes, transfers = adaptive_hierarchy(space.mesh)
        self.spaces = [space] + [
            AdaptiveSpace(m, space.degree, dtype=space.dtype)
            for m in meshes[1:]
        ]
        cs = self.spaces[-1]
        self.parts = [part] + [
            AdaptivePartition(s, n_sh, axis_name=ax) for s in self.spaces[1:]
        ]
        self.dist_ops = [
            DistAdaptivePoisson(p, dtype=dtype, a=a) for p in self.parts
        ]
        self.transfers = [
            _Transfer(self.parts[k + 1], self.parts[k], src, pick)
            for k, (src, pick) in enumerate(transfers)
        ]
        self._E = _embed_mats(space.basis, dtype)  # [3, p1, p1], replicated

        # setup on the single-device global operators (identical spectrum)
        if a is not None:
            from ..adaptive import AdaptiveHelmholtzOperator

            gops = [AdaptiveHelmholtzOperator(s, a=a) for s in self.spaces]
        else:
            gops = [AdaptivePoissonOperator(s) for s in self.spaces]
        self.bounds = []
        self._dinv_slabs = []
        for op, pl in zip(gops[:-1], self.parts[:-1]):
            dinv_g = AdaptiveMultigrid._level_dinv(op)
            self.bounds.append(_power_bounds(op, dinv_g, smoothing_range))
            slab = pl.to_shards(np.asarray(dinv_g, dtype=np.float64))
            slab[slab == 0.0] = 1.0  # identity on dead padding
            self._dinv_slabs.append(jnp.asarray(slab, dtype=dtype))

        # permuted + padded dense coarse inverse (replicated operand; the
        # lower default cap vs the single-device class reflects that B is
        # an [n_pad, n_pad] operand REPLICATED on every shard and applied
        # after an all_gather per V-cycle)
        A_inv = dense_coarse_inverse(gops[-1], coarse_max_dofs)
        pc = self.parts[-1]
        B = np.zeros((pc.n_pad, pc.n_pad))
        B[np.ix_(pc.perm, pc.perm)] = A_inv
        self._coarse_inv = jnp.asarray(B, dtype=dtype)

        # ---- shard_map operand plumbing ----
        ops_list = []
        specs = []
        self._lvl_slices = []
        for dinv, dop in zip(self._dinv_slabs, self.dist_ops[:-1]):
            start = len(ops_list)
            ops_list.append(dinv)
            specs.append(P(ax, None))
            for t in dop.shard_operands:
                ops_list.append(t)
                specs.append(P(ax, *([None] * (np.ndim(t) - 1))))
            self._lvl_slices.append((start, 1 + len(dop.shard_operands)))
        # coarsest level tables (needed by the deepest transfer's coarse
        # hanging fill/condense)
        start = len(ops_list)
        for t in self.dist_ops[-1].shard_operands:
            ops_list.append(t)
            specs.append(P(ax, *([None] * (np.ndim(t) - 1))))
        self._lvl_slices.append((start, len(self.dist_ops[-1].shard_operands)))
        self._tr_slices = []
        for tr, dop_f in zip(self.transfers, self.dist_ops[:-1]):
            start = len(ops_list)
            inv_mult = jnp.asarray(tr.inv_mult_np, dtype=dtype)
            for t in tr.operands(inv_mult):
                ops_list.append(t)
                specs.append(P(ax, *([None] * (np.ndim(t) - 1))))
            self._tr_slices.append((start, _Transfer.N_OPERANDS))
        ops_list.append(self._coarse_inv)
        specs.append(P())
        self.operands = tuple(ops_list)
        self.operand_specs = tuple(specs)
        self._solver_cache = {}

    @property
    def n_levels(self) -> int:
        return len(self.parts)

    # ------------------------ per-shard pieces ------------------------ #
    def _lvl(self, level, opnds):
        """(dinv, vmult tables) for a smoothing level, reshaped per shard."""
        start, count = self._lvl_slices[level]
        if level < self.n_levels - 1:
            dinv = opnds[start].reshape(-1)
            tabs = opnds[start + 1 : start + count]
            return dinv, tabs
        return None, opnds[start : start + count]

    _HANG_START = DistAdaptivePoisson.OPERAND_NAMES.index("osl")
    _SCO_IDX = DistAdaptivePoisson.OPERAND_NAMES.index("sc_order")
    _SCI_IDX = DistAdaptivePoisson.OPERAND_NAMES.index("sc_ids")

    def _cell_plan(self, level, opnds):
        """The level operator's per-shard (order, sorted_ids) scatter plan."""
        tabs = self._lvl(level, opnds)[1]
        return (
            tabs[self._SCO_IDX].reshape(-1),
            tabs[self._SCI_IDX].reshape(-1),
        )

    def _hang_tabs(self, level, opnds):
        """(osl, oss, hl, hm, hw, con, hng) per shard for a level —
        positions resolved by name from the operator's OPERAND_NAMES."""
        _, tabs = self._lvl(level, opnds)
        osl, oss, hl, hm, hw, con, hng = tabs[self._HANG_START :]
        return tuple(t.reshape(t.shape[1:]) for t in (osl, oss, hl, hm, hw, con, hng))

    def _tr(self, level, opnds):
        start, count = self._tr_slices[level]
        return tuple(
            t.reshape(t.shape[1:]) for t in opnds[start : start + count]
        )

    def _smooth(self, level, r, opnds, z0=None):
        dinv, tabs = self._lvl(level, opnds)
        dop = self.dist_ops[level]
        return chebyshev_smooth(
            lambda u: dop.vmult_local(u.reshape(1, -1), *tabs).reshape(-1),
            dinv,
            self.bounds[level],
            self.n_smooth,
            r,
            z0,
        )

    def _cell_mats(self, pick):
        """Per-cell (Mz, My, Mx) [E_loc, p1, p1] from the axis picks."""
        E = self._E
        return E[pick[:, 2]], E[pick[:, 1]], E[pick[:, 0]]

    def _prolong(self, level, uc, opnds):
        """coarse slab [n_loc_c] -> fine slab [n_loc_f]; mirrors the
        single-device ``make_prolongation.prolong`` step by step."""
        ax = self.axis_name
        part_c, part_f = self.parts[level + 1], self.parts[level]
        n_c, n_f = part_c.n_loc, part_f.n_loc
        S_f = part_f.n_sigma
        tc, pick, _, _, oslT, ossT, inv_mult, bnd = self._tr(level, opnds)
        osl_c, oss_c, hl_c, hm_c, hw_c, _, _ = self._hang_tabs(level + 1, opnds)
        osl_f, oss_f, hl_f, hm_f, hw_f, _, _ = self._hang_tabs(level, opnds)
        S_T = self.transfers[level].n_sigma

        # 1. conforming coarse fill (hanging rows <- masters)
        u1 = _hang_fill(
            jnp.pad(uc, (0, 1)), osl_c, oss_c, hl_c, hm_c, hw_c,
            n_c, part_c.n_sigma, ax,
        )
        # 2. transfer-SIGMA exchange and 3. per-cell embedding
        sigT = _exchange(u1, oslT, ossT, S_T, ax, u1.dtype)
        u_catT = jnp.concatenate([u1[:n_c], sigT[:S_T], u1[n_c:]])
        p1 = self.spaces[0].degree + 1
        ul = u_catT[tc].reshape(tc.shape[0], p1, p1, p1)
        Mz, My, Mx = self._cell_mats(pick)
        ul = jnp.einsum("eok,ekji->eoji", Mz, ul)
        ul = jnp.einsum("eoj,ekji->ekoi", My, ul)
        ul = jnp.einsum("eoi,ekji->ekjo", Mx, ul)
        # 4. scatter into fine [owned | SIGMA | trash] + compress (via the
        # fine operator's presorted per-shard scatter plan)
        sco, sci = self._cell_plan(level, opnds)
        v_cat = jax.ops.segment_sum(
            ul.reshape(-1)[sco], sci, n_f + S_f + 1, indices_are_sorted=True
        )
        sig_v = lax.psum(v_cat[n_f:], ax)
        v1 = jnp.pad(v_cat[:n_f], (0, 1)).at[osl_f].add(sig_v[oss_f])
        # 5. multiplicity average + boundary mask
        v1 = v1 * inv_mult
        v1 = jnp.where(bnd, jnp.zeros((), v1.dtype), v1)
        # 6. fine hanging fill
        v1 = _hang_fill(v1, osl_f, oss_f, hl_f, hm_f, hw_f, n_f, S_f, ax)
        return v1[:n_f]

    def _restrict(self, level, r, opnds):
        """fine slab -> coarse slab: the manual exact transpose of
        :meth:`_prolong` (steps 6..1 reversed), then zero coarse
        constrained rows (the solve subspace on every level)."""
        ax = self.axis_name
        part_c, part_f = self.parts[level + 1], self.parts[level]
        n_c, n_f = part_c.n_loc, part_f.n_loc
        S_f, S_c = part_f.n_sigma, part_c.n_sigma
        tc, pick, tco, tci, oslT, ossT, inv_mult, bnd = self._tr(level, opnds)
        osl_c, oss_c, hl_c, hm_c, hw_c, con_c, hng_c = self._hang_tabs(
            level + 1, opnds
        )
        osl_f, oss_f, hl_f, hm_f, hw_f, _, hng_f = self._hang_tabs(level, opnds)
        S_T = self.transfers[level].n_sigma
        p1 = self.spaces[0].degree + 1

        # 6^T: fine condense (hanging cotangents -> masters, rows zeroed)
        r1 = _hang_fill_T(
            jnp.pad(r, (0, 1)), osl_f, oss_f, hl_f, hm_f, hw_f, hng_f,
            n_f, S_f, ax,
        )
        # 5^T: boundary mask + multiplicity scaling
        r1 = jnp.where(bnd, jnp.zeros((), r1.dtype), r1) * inv_mult
        # 4^T: broadcast (transpose of compress) + per-cell gather
        sig = _exchange(r1, osl_f, oss_f, S_f, ax, r1.dtype)
        s_cat = jnp.concatenate([r1[:n_f], sig[:S_f], r1[n_f:]])
        cmap_f = self._lvl(level, opnds)[1][0].reshape(-1, p1**3)
        ul = s_cat[cmap_f].reshape(cmap_f.shape[0], p1, p1, p1)
        # 3^T: transposed embedding sweeps (independent axes — any order)
        Mz, My, Mx = self._cell_mats(pick)
        ul = jnp.einsum("eok,eoji->ekji", Mz, ul)
        ul = jnp.einsum("eoj,ekoi->ekji", My, ul)
        ul = jnp.einsum("eoi,ekjo->ekji", Mx, ul)
        # 2^T: scatter into coarse [owned | SIGMA_T | trash] + compress
        # (presorted transfer scatter plan)
        c = jax.ops.segment_sum(
            ul.reshape(-1)[tco], tci, n_c + S_T + 1, indices_are_sorted=True
        )
        sigT_c = lax.psum(c[n_c:], ax)
        rc = jnp.pad(c[:n_c], (0, 1)).at[oslT].add(sigT_c[ossT])
        # 1^T: coarse condense, then restrict to the solve subspace
        rc = _hang_fill_T(
            rc, osl_c, oss_c, hl_c, hm_c, hw_c, hng_c, n_c, S_c, ax
        )
        rc = jnp.where(con_c, jnp.zeros((), rc.dtype), rc)
        return rc[:n_c]

    def _coarse_solve(self, r, opnds):
        """all_gather the tiny conforming coarse residual, apply the
        permuted dense inverse redundantly, slice the owned slab out."""
        B = opnds[-1]
        part = self.parts[-1]
        g = lax.all_gather(r, self.axis_name, axis=0).reshape(-1)
        x = jnp.matmul(B, g, precision=jax.lax.Precision.HIGHEST)
        k = lax.axis_index(self.axis_name)
        return lax.dynamic_slice(x, (k * part.n_loc,), (part.n_loc,))

    # ---------------------------- V-cycle ---------------------------- #
    def vcycle_local(self, r, opnds):
        """One symmetric V(k,k) cycle on the owned slab (call inside
        shard_map); constrained rows are projected out before and after,
        mirroring the single-device ``AdaptiveMultigrid.vcycle``."""
        con = self._hang_tabs(0, opnds)[5][: self.parts[0].n_loc]
        r = jnp.where(con, jnp.zeros((), r.dtype), r)
        z = self._vcycle(0, r, opnds)
        return jnp.where(con, jnp.zeros((), z.dtype), z)

    def _vcycle(self, level, r, opnds):
        if level == self.n_levels - 1:
            return self._coarse_solve(r, opnds)
        z = self._smooth(level, r, opnds)
        _, tabs = self._lvl(level, opnds)
        con = self._hang_tabs(level, opnds)[5][: self.parts[level].n_loc]
        res = r - self.dist_ops[level].vmult_local(
            z.reshape(1, -1), *tabs
        ).reshape(-1)
        res = jnp.where(con, jnp.zeros((), r.dtype), res)
        zc = self._vcycle(level + 1, self._restrict(level, res, opnds), opnds)
        z = z + self._prolong(level, zc, opnds)
        return self._smooth(level, r, opnds, z0=z)


def solve_cg_mg_dist_adaptive(
    dist_mg: DistAdaptiveMultigrid,
    b_shards: jnp.ndarray,
    control: SolverControl,
    mesh: Optional[Mesh] = None,
):
    """Distributed adaptive-MG-preconditioned CG on owned slabs
    (``AdaptivePartition.to_shards`` layout). Returns ``(x_shards, info)``."""
    part = dist_mg.parts[0]
    dop = dist_mg.dist_ops[0]
    ax = dist_mg.axis_name
    mesh = mesh or make_device_mesh_1d(part.n_shards, ax)
    key = (control, mesh)
    run = dist_mg._solver_cache.get(key)
    if run is None:
        n0 = dist_mg._lvl_slices[0][1] - 1

        def local_solve(b_loc, *opnds):
            tabs0 = opnds[1 : 1 + n0]
            b1 = b_loc.reshape(-1)
            x, info = solve_cg(
                lambda u: dop.vmult_local(u.reshape(1, -1), *tabs0).reshape(-1),
                b1,
                control,
                diag=lambda r: dist_mg.vcycle_local(r, opnds),
                psum_axis=ax,
            )
            return (
                x.reshape(b_loc.shape),
                info["n_iterations"],
                info["res_norm"],
                info["res0"],
            )

        jitted = jax.jit(
            jax.shard_map(
                local_solve,
                mesh=mesh,
                in_specs=(P(ax),) + dist_mg.operand_specs,
                out_specs=(P(ax), P(), P(), P()),
            )
        )

        def run(b):
            x, it, res, res0 = jitted(b, *dist_mg.operands)
            return x, {"n_iterations": it, "res_norm": res, "res0": res0}

        dist_mg._solver_cache[key] = run
    return run(jnp.asarray(b_shards).reshape(part.n_shards, part.n_loc))
