"""Geometric multigrid on adaptively refined (hanging-node) meshes.

Global-coarsening h-multigrid (the deal.II ``MGTransferGlobalCoarsening``
family) for :class:`~..adaptive.AdaptiveSpace` problems — the solver the
uniform-mesh :class:`~.multigrid.Multigrid` cannot touch because its
levels are plain bricks. Levels are formed by CLAMPING the refinement
level: ``M_k`` replaces every active cell finer than ``k`` with its
level-``k`` ancestor. Clamping a 2:1-balanced octree stays balanced, and
every level-``k`` cell of ``M_k`` either exists identically in
``M_{k-1}`` or is one of 8 siblings of an active parent there — so the
conforming (hanging-constrained) spaces nest exactly and the transfer is
plain per-cell nodal embedding.

Structure:

- **Prolongation** is three per-cell 1D embedding sweeps (gather coarse
  parent's locals -> per-axis half-interval Lagrange matrices, picked per
  cell from a static [3, p1, p1] stack -> average duplicate nodal writes
  -> ``distribute`` for exact hanging consistency). All dense batched
  einsums — no sparse matrices on device.
- **Restriction** is the EXACT algebraic transpose via
  ``jax.linear_transpose`` of the prolongation function — R = P^T by
  construction, keeping the V-cycle symmetric (legal inside plain CG).
- **Smoother**: Chebyshev (shared :func:`~.multigrid.chebyshev_smooth`)
  in the Jacobi-preconditioned operator; the level diagonals apply the
  hanging-node weights deal.II-style (squared-weight distribution of the
  local cell diagonals — ``MGConstrainedDoFs`` semantics), and the
  eigenvalue bound comes from a per-level device power iteration.
- **Coarse solve**: level 0 is the conforming base brick; its constrained
  operator is materialized by one vmapped vmult over identity columns and
  inverted densely in f64 at setup.

Reference parity note: the reference's AMR support stops at applying
hanging-node constraints inside the cell loop (`bp5/fe_evaluation_gl.h:
124-170`); an adaptive-mesh multigrid solver is a capability beyond it.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..adaptive import AdaptiveMesh, AdaptivePoissonOperator, AdaptiveSpace
from ..basis import lagrange_eval
from ..ops import local_global as lg
from .multigrid import chebyshev_smooth

__all__ = ["coarsen_adaptive", "adaptive_hierarchy", "AdaptiveMultigrid"]


def dense_coarse_inverse(op, coarse_max_dofs: int) -> np.ndarray:
    """Dense f64 inverse of the (conforming base-brick) coarse operator.
    Assembled ON THE HOST from per-cell oracle element matrices for the
    known operator classes (no device materialization of identity
    columns, no compile); unknown operator classes fall back to
    the device path. Shared by the single-device and distributed adaptive
    MG; raises when the base brick is too large for a dense coarse
    solve."""
    cs = op.space
    if cs.n_dofs > coarse_max_dofs:
        raise ValueError(
            f"adaptive MG coarse level has {cs.n_dofs} DoFs > "
            f"coarse_max_dofs={coarse_max_dofs}; refine from a smaller "
            "base brick"
        )
    A_c = _host_dense_constrained(op)
    if A_c is None:
        eye = jnp.eye(cs.n_dofs, dtype=cs.dtype)
        A_c = np.asarray(jax.vmap(op.vmult)(eye), dtype=np.float64).T
    return np.linalg.inv(A_c)


def _host_dense_constrained(op) -> np.ndarray | None:
    """Dense CONSTRAINED matrix (``vmult`` semantics: zero constrained
    columns, cell loop, identity on constrained rows) of a CONFORMING
    adaptive operator, assembled with numpy element matrices. Returns
    ``None`` for operator classes it does not know or non-conforming
    spaces (hanging nodes) — callers then use the device path."""
    from ..adaptive import (
        AdaptiveHelmholtzOperator,
        AdaptivePoissonOperator,
        _cell_qpoints,
    )
    from ..mesh import BrickMesh
    from ..utils.oracle import element_matrix

    s = op.space
    if s.hang_rows.size:
        return None
    helm = type(op) is AdaptiveHelmholtzOperator
    if not (helm or type(op) is AdaptivePoissonOperator):
        return None
    n = s.n_dofs
    base = BrickMesh((1, 1, 1))
    K = np.zeros((n, n))
    dof_map = s._dof_map_np
    if helm:
        # recover a(x_q) from the stored JxW-weighted table
        aq = np.asarray(op._aq_jxw, np.float64) / np.asarray(
            op._jxw, np.float64
        )
        Xq = _cell_qpoints(s)
    for e in range(s.mesh.n_cells):
        if helm:
            a_e = aq[e].reshape(-1)
            Ke = element_matrix(
                base,
                s.basis,
                "helmholtz",
                cell_qpoints=Xq[e].reshape(-1, 3),
                coefficient_fn=lambda X, a_e=a_e: a_e,
                h_cell=tuple(s.mesh.sizes[e]),
            )
        else:
            Ke = element_matrix(
                base, s.basis, "stiffness", h_cell=tuple(s.mesh.sizes[e])
            )
        idx = dof_map[e].reshape(-1)
        K[np.ix_(idx, idx)] += Ke
    m = s.constrained_mask_np
    K[m, :] = 0.0
    K[:, m] = 0.0
    K[m, m] = 1.0
    return K


def coarsen_adaptive(mesh: AdaptiveMesh):
    """One global-coarsening step: replace every finest-level cell octet
    with its parent. Returns ``(coarse_mesh, src_cell, axis_pick)`` where
    ``src_cell[f]`` is the coarse-mesh cell each fine cell maps to and
    ``axis_pick[f, d]`` selects the per-axis transfer matrix
    (0 = identity/same cell, 1 = lower child half, 2 = upper child half).
    """
    L = int(mesh.levels.max())
    assert L > 0, "base mesh cannot be coarsened"
    base_h, m_base = mesh._base_geometry()
    lower = np.asarray(mesh.lower, dtype=np.float64)
    fine = mesh.levels == L
    keep = ~fine
    n_f = mesh.n_cells

    # parents of the finest cells on the level-(L-1) integer lattice
    hL = base_h / 2.0**L
    ic = np.round((mesh.origins[fine] - lower) / hL).astype(np.int64)
    child = ic & 1  # [n_fine_L, 3] octant within the parent
    pc = ic >> 1
    n_axp = m_base * 2 ** (L - 1)
    pkey = (pc[:, 2] * n_axp[1] + pc[:, 1]) * n_axp[0] + pc[:, 0]
    uniq_keys, inv = np.unique(pkey, return_inverse=True)
    n_kept = int(keep.sum())
    n_parents = uniq_keys.size

    # coarse mesh = kept cells (original order) then the new parents;
    # any sibling is a valid representative (all 8 share the parent
    # lattice coordinate pc)
    rep = np.zeros(n_parents, dtype=np.int64)
    np.maximum.at(rep, inv, np.arange(inv.size))
    p_orig = lower[None, :] + (pc[rep] * (2.0 * hL)[None, :])
    origins = np.concatenate([mesh.origins[keep], p_orig])
    sizes = np.concatenate(
        [mesh.sizes[keep], np.tile(2.0 * hL, (n_parents, 1))]
    )
    levels = np.concatenate(
        [mesh.levels[keep], np.full(n_parents, L - 1, dtype=np.int64)]
    )
    coarse = AdaptiveMesh(origins, sizes, levels, mesh.lower, mesh.upper)

    src_cell = np.empty(n_f, dtype=np.int64)
    src_cell[keep] = np.arange(n_kept)
    src_cell[fine] = n_kept + inv
    axis_pick = np.zeros((n_f, 3), dtype=np.int64)
    axis_pick[fine] = child + 1  # 1 = lower half, 2 = upper half
    return coarse, src_cell, axis_pick


def adaptive_hierarchy(mesh: AdaptiveMesh):
    """``(meshes, transfers)``: meshes[0] is the input (finest), meshes[-1]
    the base brick; transfers[k] = (src_cell, axis_pick) mapping
    meshes[k] cells into meshes[k+1]."""
    meshes, transfers = [mesh], []
    while int(meshes[-1].levels.max()) > 0:
        coarse, src, pick = coarsen_adaptive(meshes[-1])
        meshes.append(coarse)
        transfers.append((src, pick))
    return meshes, transfers


def _embed_mats(basis, dtype):
    """[3, p1, p1] per-axis transfer stack: identity, and the Lagrange
    embedding onto each child half (rows = fine nodes)."""
    gll = basis.nodes
    E0 = lagrange_eval(gll, 0.5 * gll)[0]
    E1 = lagrange_eval(gll, 0.5 * (gll + 1.0))[0]
    return jnp.asarray(
        np.stack([np.eye(basis.n_dofs), E0, E1]), dtype=dtype
    )


def make_prolongation(
    coarse: AdaptiveSpace, fine: AdaptiveSpace, src_cell, axis_pick
):
    """Linear function ``coarse nodal [n_c] -> fine nodal [n_f]`` (exact
    nodal embedding of the conforming coarse function). Restriction is its
    ``jax.linear_transpose``."""
    E = _embed_mats(fine.basis, fine.dtype)
    p = fine.degree
    src = jnp.asarray(np.asarray(src_cell), dtype=jnp.int32)
    Mz = E[jnp.asarray(axis_pick[:, 2], dtype=jnp.int32)]  # [Ef, p1, p1]
    My = E[jnp.asarray(axis_pick[:, 1], dtype=jnp.int32)]
    Mx = E[jnp.asarray(axis_pick[:, 0], dtype=jnp.int32)]
    coarse_map = jnp.take(coarse.elem_dof_map, src, axis=0)  # [Ef, P3]
    ones = jnp.ones(coarse_map.size, dtype=fine.dtype)
    mult = (
        jnp.zeros((fine.n_dofs,), dtype=fine.dtype)
        .at[fine.elem_dof_map.reshape(-1)]
        .add(ones)
    )
    inv_mult = 1.0 / mult
    bmask = jnp.asarray(fine.boundary_mask_np)

    def prolong(uc):
        uc = coarse.distribute(uc)  # conforming coarse function
        ul = lg.gather_indexed(uc, coarse_map, p)  # [Ef, p1, p1, p1]
        ul = jnp.einsum("eok,ekji->eoji", Mz, ul)
        ul = jnp.einsum("eoj,ekji->ekoi", My, ul)
        ul = jnp.einsum("eoi,ekji->ekjo", Mx, ul)
        uf = lg.scatter_indexed_sorted(ul, fine.scatter_plan, fine.n_dofs)
        uf = uf * inv_mult  # duplicates hold equal values -> average
        uf = jnp.where(bmask, jnp.zeros((), uf.dtype), uf)
        return fine.distribute(uf)  # exact hanging consistency

    return prolong


class AdaptiveMultigrid:
    """V-cycle preconditioner for :class:`AdaptivePoissonOperator`
    systems. Same calling convention as :class:`~.multigrid.Multigrid`:
    ``mg.vcycle`` plugs into the CG solvers' ``diag`` slot."""

    def __init__(
        self,
        space: AdaptiveSpace,
        n_smooth: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 30000,
        fine_op: AdaptivePoissonOperator | None = None,
        make_op=None,
        coarse_inv: np.ndarray | None = None,
    ):
        """``make_op(space) -> operator`` rediscretizes each level
        (default :class:`AdaptivePoissonOperator`; pass e.g.
        ``AdaptiveHelmholtzOperator`` for variable-coefficient levels —
        the coefficient re-evaluates at every level's own qpoints).
        ``coarse_inv``: a precomputed :func:`dense_coarse_inverse` of the
        SAME base brick / operator class — the coarsest level is always
        the conforming base, so AMR loops reuse one inverse across every
        refinement step instead of re-inverting per step (expose via
        ``mg.coarse_inv_np``)."""
        make_op = make_op or AdaptivePoissonOperator
        meshes, transfers = adaptive_hierarchy(space.mesh)
        self.spaces = [space] + [
            AdaptiveSpace(m, space.degree, dtype=space.dtype)
            for m in meshes[1:]
        ]
        self.ops = [fine_op or make_op(space)] + [
            make_op(s) for s in self.spaces[1:]
        ]
        self.n_smooth = n_smooth
        cs = self.spaces[-1]

        self.prolongs = []
        self.restricts = []
        for k, (src, pick) in enumerate(transfers):
            P = make_prolongation(
                self.spaces[k + 1], self.spaces[k], src, pick
            )
            proto = jnp.zeros((self.spaces[k + 1].n_dofs,), dtype=space.dtype)
            Pt = jax.linear_transpose(P, proto)
            cmask = self.spaces[k + 1].constrained_mask
            # P reads coarse constrained rows (interior fine nodes carry
            # boundary-node embedding weights), so P^T deposits residual
            # there — zero it: constrained rows live outside the solve
            # subspace on every level
            self.prolongs.append(P)
            self.restricts.append(
                lambda r, Pt=Pt, cmask=cmask: jnp.where(
                    cmask, jnp.zeros((), r.dtype), Pt(r)[0]
                )
            )

        # deal.II-style constrained level diagonals: distribute the local
        # cell diagonals with SQUARED hanging weights, identity on
        # constrained rows
        self.dinv = [self._level_dinv(op) for op in self.ops[:-1]]
        self.bounds = [
            _power_bounds(op, dinv, smoothing_range)
            for op, dinv in zip(self.ops[:-1], self.dinv)
        ]

        # dense coarse inverse (conforming base brick); reusable across
        # AMR steps via the coarse_inv kwarg (same base, same operator)
        self.coarse_inv_np = (
            dense_coarse_inverse(self.ops[-1], coarse_max_dofs)
            if coarse_inv is None
            else coarse_inv
        )
        assert self.coarse_inv_np.shape == (cs.n_dofs, cs.n_dofs), (
            self.coarse_inv_np.shape,
            cs.n_dofs,
        )
        self._coarse_inv = jnp.asarray(self.coarse_inv_np, dtype=space.dtype)

    @staticmethod
    def _level_dinv(op: AdaptivePoissonOperator) -> jnp.ndarray:
        s = op.space
        b = s.basis
        w = b.q_weights
        K1 = np.einsum("q,qa,qb->ab", w, b.D, b.D)  # 1D stiffness (GLL colloc)
        kd, wd = np.diag(K1), w
        h = s.mesh.sizes
        det = h.prod(axis=1)
        mdx, mdy, mdz = (det / h[:, d] ** 2 for d in range(3))
        # local diag [E, p1, p1, p1] (k, j, i) = (z, y, x)
        dloc = (
            mdx[:, None, None, None] * (wd[:, None, None] * wd[None, :, None] * kd[None, None, :])[None]
            + mdy[:, None, None, None] * (wd[:, None, None] * kd[None, :, None] * wd[None, None, :])[None]
            + mdz[:, None, None, None] * (kd[:, None, None] * wd[None, :, None] * wd[None, None, :])[None]
        )
        dloc = jnp.asarray(dloc, dtype=s.dtype)
        aq_jxw = getattr(op, "_aq_jxw", None)
        if aq_jxw is not None:
            # Helmholtz value term: with GLL collocation the local mass
            # matrix is diagonal and its diagonal IS a(x_q) * JxW
            dloc = dloc + aq_jxw
        d = lg.scatter_indexed(dloc, s.elem_dof_map, s.n_dofs)
        if s.hang_rows.size:
            add = jax.ops.segment_sum(
                (s.hang_w**2) * d[s.hang_rows], s.hang_cols, s.n_dofs
            )
            d = d + add
        d = jnp.where(s.constrained_mask, jnp.ones((), d.dtype), d)
        return 1.0 / d

    @property
    def n_levels(self) -> int:
        return len(self.ops)

    def _smooth(self, level, r, z0=None):
        return chebyshev_smooth(
            self.ops[level].vmult,
            self.dinv[level],
            self.bounds[level],
            self.n_smooth,
            r,
            z0=z0,
        )

    def _vcycle(self, level, r):
        if level == self.n_levels - 1:
            return jnp.matmul(
                self._coarse_inv, r, precision=jax.lax.Precision.HIGHEST
            )
        z = self._smooth(level, r)
        res = r - self.ops[level].vmult(z)
        res = jnp.where(
            self.spaces[level].constrained_mask, jnp.zeros((), r.dtype), res
        )
        zc = self._vcycle(level + 1, self.restricts[level](res))
        z = z + self.prolongs[level](zc)
        return self._smooth(level, r, z0=z)

    def vcycle(self, r: jnp.ndarray) -> jnp.ndarray:
        """One symmetric V(k,k) cycle; linear and symmetric (R = P^T by
        ``linear_transpose``), so plain CG is sound."""
        s = self.spaces[0]
        r = jnp.where(s.constrained_mask, jnp.zeros((), r.dtype), r)
        z = self._vcycle(0, r)
        return jnp.where(s.constrained_mask, jnp.zeros((), r.dtype), z)

    def __call__(self, r):
        return self.vcycle(r)


def _power_bounds(op, dinv, smoothing_range, n_power=12):
    """lambda_max(D^-1 A) over the constrained-zero subspace by a device
    power iteration; deal.II 1.2x safety factor.

    Runs EAGERLY on purpose: jitting would close over the level's
    ``elem_dof_map``/coefficient tables as compile-time constants, and XLA
    constant-folds the gather index arithmetic — minutes of setup compile
    at 10^6-cell levels for 12 matvecs of work."""
    s = op.space
    mask = s.constrained_mask
    u = jnp.asarray(
        np.random.default_rng(42).standard_normal(s.n_dofs), dtype=s.dtype
    )
    u = jnp.where(mask, 0.0, u)
    u = u / jnp.linalg.norm(u)
    lam = 1.0
    for _ in range(n_power):
        v = jnp.where(mask, 0.0, dinv * op.vmult(u))
        lam = float(jnp.linalg.norm(v))
        u = v / lam

    lam_max = 1.2 * lam
    return lam_max / smoothing_range, lam_max
