"""Geometric h-multigrid V-cycle preconditioner (framework extra).

The reference solves BP5 with Jacobi-CG only (its ``DiagonalMatrix`` is even
filled with 1.0, ``bp5/step-64.cu:428-432``); this module supplies the
production-grade answer for meshes where the exact FDM tensor solve
(solvers/fdm.py) does not apply — mapped (deformed) and graded geometries —
and a mesh-independent-iteration-count CG preconditioner everywhere else.

Structure:

- **Hierarchy**: the structured brick coarsens by 2 per axis while all
  element counts stay even (graded meshes sum adjacent widths; mapped
  meshes keep their deformation — each level re-interpolates the map at
  its own nodal points, the standard geometric-MG rediscretization).
- **Transfers are exact and separable**: a degree-p FE function on a
  coarse cell is a degree-p polynomial on each fine sub-cell, so the
  coarse space NESTS in the fine space and prolongation is the 1D nodal
  interpolation ``P = Pz (x) Py (x) Px`` — three banded sweeps on the
  nodal grid, same machinery as the operator apply. Restriction is the
  transpose sweeps (R = P^T), which keeps the V-cycle symmetric.
- **Smoother**: Chebyshev polynomial in the Jacobi-preconditioned
  operator (true ``compute_diagonal``), the standard matrix-free choice
  (deal.II ``PreconditionChebyshev``); the eigenvalue bound comes from a
  host power iteration on the coarsest level's dense matrix (cheap,
  level-independent to <1.5% measured — see :func:`bounds_from_dense`).
  Chebyshev is a FIXED polynomial, so the whole V-cycle is a linear
  symmetric operator — legal inside plain CG (no flexible variant
  needed).
- **Coarse solve**: the coarsest constrained operator is assembled
  densely ON THE HOST from the geometry tables (operator-generic via
  ``weak_form()``, ``models.operator_base.assemble_dense``) and inverted
  in f64 at setup; the in-cycle coarse solve is a single tiny matmul.

The V-cycle is a pure jittable function; levels unroll at trace time (the
hierarchy depth is a Python constant, like the reference's template
parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..basis import lagrange_eval
from ..fe_space import FESpace
from ..mesh import BrickMesh
from ..ops.sum_factorization import sweep

__all__ = [
    "Multigrid",
    "coarsen_mesh",
    "prolongation_1d",
    "chebyshev_smooth",
    "bounds_from_dense",
]


def chebyshev_smooth(vmult, dinv, bounds, degree, r, z0=None):
    """``degree`` steps of Chebyshev iteration on ``A z = r`` (initial
    guess z0), the fixed polynomial in the Jacobi-preconditioned operator
    — shared by the single-device and distributed V-cycles. ``dinv`` may
    be a vector or any broadcastable array.

    The degree loop is a ``lax.fori_loop`` (the rho recurrence rides in
    the carry), so the traced graph contains ONE ``vmult`` per smooth
    regardless of degree — V-cycle XLA compile time scales with the
    number of inlined fine-level vmult subgraphs."""
    lam_min, lam_max = bounds
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta

    res = r if z0 is None else r - vmult(z0)
    d = (1.0 / theta) * (dinv * res)
    z = d if z0 is None else z0 + d
    if degree <= 1:
        return z

    def body(_, carry):
        z, d, rho_old = carry
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv * (r - vmult(z)))
        return z + d, d, rho

    z, d, _ = jax.lax.fori_loop(
        1, degree, body, (z, d, jnp.asarray(1.0 / sigma, dtype=r.dtype))
    )
    return z


def coarsen_mesh(mesh: BrickMesh) -> BrickMesh:
    """The mesh with every axis coarsened by 2 (inverse of
    ``refine_global(1)``); graded meshes merge adjacent element pairs,
    mapped meshes keep their deformation."""
    mx, my, mz = mesh.n_elements
    assert mx % 2 == 0 and my % 2 == 0 and mz % 2 == 0, mesh.n_elements
    widths = None
    if mesh.widths is not None:
        widths = tuple(np.asarray(w).reshape(-1, 2).sum(axis=1) for w in mesh.widths)
    return dataclasses.replace(
        mesh, n_elements=(mx // 2, my // 2, mz // 2), widths=widths
    )


def prolongation_1d(
    mc: int, p: int, nodes: np.ndarray, fine_widths: Optional[np.ndarray] = None
) -> np.ndarray:
    """1D nodal prolongation ``P[nf, nc]`` from a ``mc``-element degree-p
    grid to its 2x refinement (nf = 2*mc*p+1, nc = mc*p+1). Exact: each
    coarse basis polynomial is evaluated at the fine nodal points (graded
    meshes split each coarse cell at the true width ratio)."""
    nf, nc = 2 * mc * p + 1, mc * p + 1
    P = np.zeros((nf, nc))
    for e in range(mc):
        if fine_widths is None:
            t = 0.5
        else:
            w0, w1 = fine_widths[2 * e], fine_widths[2 * e + 1]
            t = w0 / (w0 + w1)
        # coarse-reference coordinates of the 2p+1 fine nodes in this cell
        pts = np.concatenate([t * nodes, t + (1.0 - t) * nodes[1:]])
        S, _ = lagrange_eval(nodes, pts)  # [2p+1, p+1]
        P[2 * e * p : 2 * e * p + 2 * p + 1, e * p : e * p + p + 1] = S
    return P


def _chebyshev_bounds(vmult, dinv, space, smoothing_range, n_power=12):
    """(lambda_min, lambda_max) for the Chebyshev smoother: power iteration
    on D^-1 A over the constrained-zero subspace, with the deal.II-style
    1.2x safety factor and lambda_min = lambda_max / smoothing_range.

    One jitted ``fori_loop`` per level (the ``bounds="per-level"`` mode;
    the default setup path estimates once on the coarsest level's dense
    matrix instead, see :func:`bounds_from_dense`, avoiding the per-level
    vmult compile entirely)."""
    u0 = jnp.asarray(
        np.random.default_rng(42).standard_normal(space.n_dofs),
        dtype=space.dtype,
    )
    mask = space.dirichlet_mask

    @jax.jit
    def power(u):
        u = jnp.where(mask, 0.0, u)
        u = u / jnp.linalg.norm(u)

        def step(_, carry):
            u, _ = carry
            v = jnp.where(mask, 0.0, dinv * vmult(u))
            lam = jnp.linalg.norm(v)
            return v / lam, lam

        return jax.lax.fori_loop(
            0, n_power, step, (u, jnp.asarray(1.0, dtype=u.dtype))
        )[1]

    lam_max = 1.2 * float(power(u0))
    return lam_max / smoothing_range, lam_max


def bounds_from_dense(A: np.ndarray, smoothing_range: float, safety: float = 1.35):
    """Chebyshev bounds from a host power iteration on the dense
    Jacobi-preconditioned matrix ``D^-1 A`` (the multigrid COARSEST level).

    lambda_max(D^-1 A) of a Jacobi-preconditioned 2nd-order FEM operator is
    governed by element-local properties, not the mesh size — measured
    across the sine-mapped hierarchy levels it drifts < 1.5% (2.504 at 15k
    DoFs vs 2.534 at 912k) — so one coarse-level estimate serves every
    level. ``safety`` (1.35 vs deal.II's 1.2 on same-level estimates)
    covers the cross-level drift; an overestimate only softens the
    smoother, an underestimate would amplify high modes."""
    d = np.diag(A).copy()
    rng = np.random.default_rng(42)
    u = rng.standard_normal(A.shape[0])
    u /= np.linalg.norm(u)
    lam = 1.0
    for _ in range(50):
        v = (A @ u) / d
        lam = np.linalg.norm(v)
        u = v / lam
    lam_max = safety * lam
    return lam_max / smoothing_range, lam_max


class Multigrid:
    """Geometric multigrid V-cycle; use ``mg.vcycle`` as the callable
    preconditioner of :func:`solve_cg` (or compose with solvers/ir.py for
    mixed-precision outer refinement).

    make_op: ``FESpace -> operator`` with ``vmult`` + ``compute_diagonal``
    (any MatrixFreeOperator). Default: Poisson on the level-appropriate
    fast backend.

    bounds: Chebyshev eigenvalue bounds — ``"coarse"`` (default: one host
    estimate on the coarsest dense matrix, shared by all levels),
    ``"per-level"`` (jitted device power iteration per level — costs one
    XLA vmult compile per level; for meshes whose coarse levels
    misrepresent the fine spectrum), or an explicit ``(lo, hi)`` tuple.
    """

    def __init__(
        self,
        space: FESpace,
        make_op: Optional[Callable[[FESpace], object]] = None,
        smooth_degree: int = 3,
        smoothing_range: float = 20.0,
        coarse_max_dofs: int = 4000,
        fine_op=None,
        bounds="coarse",
    ):
        """``fine_op``: the already-constructed finest-level operator (the
        one the driver solves with). Passing it skips rebuilding the level-0
        operator — on mapped meshes that means recomputing the full
        per-qpoint isoparametric geometry (~90 s at 1M DoFs, the largest
        single r2 MG setup cost)."""
        if make_op is None:
            from ..models import PoissonOperator

            def make_op(s):
                backend = "structured" if s.mesh.is_mapped else "separable"
                return PoissonOperator(s, backend=backend)

        self.smooth_degree = smooth_degree

        # ---------------- hierarchy ---------------- #
        spaces = [space]
        while (
            all(m % 2 == 0 for m in spaces[-1].mesh.n_elements)
            and spaces[-1].n_dofs > coarse_max_dofs
        ):
            spaces.append(
                FESpace(coarsen_mesh(spaces[-1].mesh), space.basis, space.dtype)
            )
        if len(spaces) == 1 and space.n_dofs > coarse_max_dofs:
            raise ValueError(
                f"mesh {space.mesh.n_elements} cannot coarsen: "
                f"{space.n_dofs} DoFs in a single level (need even element "
                "counts to build a hierarchy). A mesh at or below "
                f"coarse_max_dofs={coarse_max_dofs} would instead use the "
                "exact dense solve as a single-level preconditioner."
            )
        if spaces[-1].n_dofs > max(coarse_max_dofs, 8000):
            # e.g. (10,10,10) at p=5 coarsens once to (5,5,5) = 17,576
            # DoFs and then stops on odd counts — refuse rather than
            # silently building a multi-GB dense inverse
            raise ValueError(
                f"coarsest level {spaces[-1].mesh.n_elements} still has "
                f"{spaces[-1].n_dofs} DoFs (> {max(coarse_max_dofs, 8000)}) "
                "— element counts stop halving too early for a dense "
                "coarse solve; choose a mesh with more powers of two"
            )
        self.spaces = spaces
        self.ops = [make_op(s) for s in spaces[1:]]
        if fine_op is not None:
            assert fine_op.space is space, "fine_op must be built on `space`"
            self.ops.insert(0, fine_op)
        else:
            self.ops.insert(0, make_op(space))

        # ---------------- dense coarse matrix (host) ---------------- #
        # one batched host GEMM per plane; also yields the Chebyshev
        # eigenvalue estimate for free (instead of a vmapped-vmult
        # materialization and per-level eager power iterations)
        from ..models.operator_base import assemble_dense

        try:
            A_c = assemble_dense(
                self.ops[-1], max_dofs=max(coarse_max_dofs, 8000)
            )
        except NotImplementedError:
            # operators without a weak_form() (custom quad-point bodies)
            # keep the make_op contract via the vmapped vmult-over-identity
            # materialization — slower setup, same matrix
            n_c = spaces[-1].n_dofs
            eye = jnp.eye(n_c, dtype=spaces[-1].dtype)
            A_c = np.asarray(
                jax.vmap(self.ops[-1].vmult)(eye), dtype=np.float64
            ).T
        self._coarse_inv = jnp.asarray(
            np.linalg.inv(A_c), dtype=spaces[-1].dtype
        )

        # per-level Jacobi diagonals + Chebyshev bounds (coarsest level
        # uses the dense inverse — no smoother there)
        self.dinv = [op.jacobi_preconditioner() for op in self.ops[:-1]]
        if bounds == "coarse":
            b = bounds_from_dense(A_c, smoothing_range)
            self.bounds = [b] * (len(self.ops) - 1)
        elif bounds == "per-level":
            self.bounds = [
                _chebyshev_bounds(op.vmult, dinv, s, smoothing_range)
                for op, dinv, s in zip(self.ops[:-1], self.dinv, spaces[:-1])
            ]
        elif isinstance(bounds, str):
            raise ValueError(
                f"bounds={bounds!r}: expected 'coarse', 'per-level', or an "
                "explicit (lam_min, lam_max) pair"
            )
        else:  # explicit (lam_min, lam_max)
            lam = tuple(float(v) for v in bounds)
            if len(lam) != 2:
                raise ValueError(
                    f"explicit bounds must be (lam_min, lam_max), got {bounds!r}"
                )
            self.bounds = [lam] * (len(self.ops) - 1)

        # per-level-pair 1D prolongation tables (coarse -> fine), in the
        # sweep convention mat[out, in]
        p = space.degree
        nodes = space.basis.nodes
        self.prolong_mats = []
        for fine, coarse in zip(spaces[:-1], spaces[1:]):
            mats = []
            for ax, mc in enumerate(coarse.mesh.n_elements):  # (mx, my, mz)
                fw = None if fine.mesh.widths is None else fine.mesh.widths[ax]
                mats.append(
                    jnp.asarray(prolongation_1d(mc, p, nodes, fw), dtype=space.dtype)
                )
            # grid axes are (z, y, x) = mesh axes (2, 1, 0)
            self.prolong_mats.append((mats[2], mats[1], mats[0]))


    @property
    def n_levels(self) -> int:
        return len(self.spaces)

    # ------------------------- components ------------------------- #
    def _prolong(self, level: int, u_c: jnp.ndarray) -> jnp.ndarray:
        """coarse (level+1) -> fine (level) nodal interpolation."""
        Pz, Py, Px = self.prolong_mats[level]
        u = u_c.reshape(self.spaces[level + 1].grid_shape)
        u = sweep(sweep(sweep(u, Px, 2), Py, 1), Pz, 0)
        return u.reshape(-1)

    def _restrict(self, level: int, r_f: jnp.ndarray) -> jnp.ndarray:
        """fine (level) -> coarse (level+1): R = P^T (transpose sweeps),
        then zero coarse constrained rows (the residual lives in the
        homogeneous-Dirichlet subspace on every level)."""
        Pz, Py, Px = self.prolong_mats[level]
        r = r_f.reshape(self.spaces[level].grid_shape)
        r = sweep(
            sweep(sweep(r, Px, 2, transpose=True), Py, 1, transpose=True),
            Pz,
            0,
            transpose=True,
        )
        return self.spaces[level + 1].zero_constrained_values(r.reshape(-1))

    def _smooth(self, level: int, r: jnp.ndarray, z0=None) -> jnp.ndarray:
        return chebyshev_smooth(
            self.ops[level].vmult,
            self.dinv[level],
            self.bounds[level],
            self.smooth_degree,
            r,
            z0,
        )

    # --------------------------- V-cycle --------------------------- #
    def vcycle(self, r: jnp.ndarray) -> jnp.ndarray:
        """One symmetric V(k,k) cycle applied to a residual: the
        preconditioner callable (plug into solve_cg's ``diag`` slot).
        Linear and symmetric, so plain (non-flexible) CG is sound."""
        return self._vcycle(0, self.spaces[0].zero_constrained_values(r))

    def _vcycle(self, level: int, r: jnp.ndarray) -> jnp.ndarray:
        if level == self.n_levels - 1:
            # pinned precision: the default bf16 matmul would put a ~1e-3
            # error on the coarse correction (see ops/sum_factorization.py)
            return jnp.matmul(
                self._coarse_inv, r, precision=jax.lax.Precision.HIGHEST
            )
        z = self._smooth(level, r)  # pre-smooth from zero
        res = r - self.ops[level].vmult(z)
        zc = self._vcycle(level + 1, self._restrict(level, res))
        z = z + self._prolong(level, zc)
        return self._smooth(level, r, z0=z)  # post-smooth

    def __call__(self, r: jnp.ndarray) -> jnp.ndarray:
        return self.vcycle(r)

    def vcycle_vector(self, r: jnp.ndarray) -> jnp.ndarray:
        """Component-vmapped V-cycle for vector-valued (BP2/BP4/BP6)
        systems on ``[n_components, n]`` arrays: the vector operator is
        block-diagonal with identical scalar blocks, so the exact vector
        preconditioner is the scalar V-cycle per component."""
        return jax.vmap(self.vcycle)(r)
