"""Element geometry: Jacobians, JxW, and merged diffusion coefficients.

Equivalent of the reference's geometry tables
(``MappingQGeneric`` -> per-qpoint ``inv_jacobian``/``JxW`` consumed at
``bp5/step-64.cu:90-113``) and of the ``JacobianFunctor`` coefficient
precompute (``bp5/step-64.cu:60-114``): the merged symmetric tensor
``C(q) = JxW(q) * J^{-1} J^{-T}`` with dim*(dim+1)/2 = 6 independent entries,
so the Poisson quad-point operation is a single symmetric 3x3 contraction
(the ``MERGED_COEFFICIENTS`` switch, ``bp5/step-64.cu:47``).

Mesh classes supported:

- **uniform brick** (the only case the reference benchmarks): the Jacobian
  is one diagonal for every element; ``C(q) = det(J) * w3d(q) * diag(1/h^2)``
  — three trace-time scalars, zero metric HBM traffic.
- **graded tensor-product**: per-axis element widths; Jacobians stay
  diagonal but vary per element. Every factor still separates per axis, so
  the Kronecker fast path survives (ops/separable.py absorbs the widths
  into its per-axis assembled tables); the dense ``[n_cells, n_q, 6]``
  tables feed the general gather/structured backends.
- **mapped (deformed) meshes** (:class:`~..mesh.MappedMesh`): full
  per-(cell, qpoint) Jacobians from the degree-p isoparametric interpolant
  of the deformation (``MappingQGeneric`` semantics, reference L-16); all
  six merged-coefficient planes are generally non-zero, exercising the
  complete symmetric contraction (``bp5/step-64.cu:164-188``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from .basis import Basis1D
from .mesh import BrickMesh

__all__ = ["Geometry"]


def _tensor_weights(basis: Basis1D) -> np.ndarray:
    w = basis.q_weights
    return w[:, None, None] * w[None, :, None] * w[None, None, :]


def _det_inv_3x3(J: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Closed-form cofactor det + inverse of ``[..., 3, 3]`` batches.
    numpy's ``linalg.det``/``inv`` gufuncs take tens of seconds on the
    millions of tiny matrices a 1M-DoF mapped mesh produces (LAPACK per
    matrix); the vectorized cofactor arithmetic is ~50x faster."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = np.empty_like(J)
    inv[..., 0, 0] = A
    inv[..., 1, 0] = B
    inv[..., 2, 0] = C
    inv[..., 0, 1] = c * h - b * i
    inv[..., 1, 1] = a * i - c * g
    inv[..., 2, 1] = b * g - a * h
    inv[..., 0, 2] = b * f - c * e
    inv[..., 1, 2] = c * d - a * f
    inv[..., 2, 2] = a * e - b * d
    inv /= det[..., None, None]
    return det, inv


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Metric terms for a mesh + quadrature rule.

    ``uniform`` selects the constant fast path (scalar ``h``/``det_j``/
    ``inv_h2``); the per-element arrays are available for both mesh kinds.
    """

    mesh: BrickMesh
    basis: Basis1D
    w3d: np.ndarray  # [qz, qy, qx]

    @staticmethod
    def from_mesh(mesh: BrickMesh, basis: Basis1D) -> "Geometry":
        w3d = _tensor_weights(basis)
        w3d.setflags(write=False)
        return Geometry(mesh, basis, w3d)

    # ---------------------------------------------------------------- #
    @property
    def uniform(self) -> bool:
        return self.mesh.is_uniform

    @property
    def mapped(self) -> bool:
        return self.mesh.is_mapped

    @property
    def n_q(self) -> int:
        return self.basis.n_q ** 3

    @property
    def h(self) -> tuple[float, float, float]:
        return self.mesh.h

    @property
    def det_j(self) -> float:
        hx, hy, hz = self.mesh.h
        return hx * hy * hz

    @property
    def inv_h2(self) -> tuple[float, float, float]:
        hx, hy, hz = self.mesh.h
        return (1.0 / hx**2, 1.0 / hy**2, 1.0 / hz**2)

    @property
    def const_merged_diag(self) -> tuple[float, float, float]:
        """diag of det(J) * J^{-1} J^{-T} (uniform only); multiply by
        w3d(q) to get C(q)."""
        d = self.det_j
        return tuple(d * ih2 for ih2 in self.inv_h2)

    # ---------------------------------------------------------------- #
    # per-element diagonal factors (uniform or graded)
    # ---------------------------------------------------------------- #
    def det_per_cell(self) -> np.ndarray:
        """[n_cells] det(J_e) in cell order (ez, ey, ex), x fastest."""
        hx, hy, hz = self.mesh.h_axes()
        return (
            hz[:, None, None] * hy[None, :, None] * hx[None, None, :]
        ).reshape(-1)

    def merged_diag_per_cell(self) -> np.ndarray:
        """[n_cells, 3] diag of det(J_e) J_e^{-1} J_e^{-T}: per-axis
        (hy hz / hx, hx hz / hy, hx hy / hz)."""
        hx, hy, hz = self.mesh.h_axes()
        HX = hx[None, None, :]
        HY = hy[None, :, None]
        HZ = hz[:, None, None]
        out = np.stack(
            [
                (HY * HZ / HX).reshape(-1),
                (HX * HZ / HY).reshape(-1),
                (HX * HY / HZ).reshape(-1),
            ],
            axis=-1,
        )
        return out

    # ---------------------------------------------------------------- #
    # mapped (deformed) meshes: isoparametric Jacobian tables
    # ---------------------------------------------------------------- #
    def _iter_jacobian_slabs(self):
        """Yield ``(sl, xq_slab, J_slab)`` per z-slab of elements: the
        degree-p isoparametric physical qpoints and Jacobians
        ``J[c, r] = d x_c / d xi_r`` (xi = the element's unit reference
        coordinate). Both yielded arrays are REUSED buffers — consumers
        copy what they keep. Slab streaming is the point: this box's
        fresh-page fault path (VMM userfaultfd) services first touches at
        ~25-90 MB/s, so materialized bytes — not FLOPs — dominate mapped
        setup; every temporary here stays slab-sized and warm."""
        mesh, basis = self.mesh, self.basis
        p1 = basis.n_dofs
        mx, my, mz = mesh.n_elements
        edges = mesh.edges_1d()
        haxes = mesh.h_axes()
        # per-axis nodal brick coordinates per element: [m_d, p1]
        ax, ay, az = [
            edges[d][:-1, None] + haxes[d][:, None] * basis.nodes[None, :]
            for d in range(3)
        ]
        S, D = basis.S, basis.D
        n_q = self.n_q
        npe = my * mx  # elements per z-slab

        def sweep(x, Mk, Mj, Mi):
            t = np.einsum("ekjic,qi->ekjqc", x, Mi, optimize=True)
            t = np.einsum("ekjqc,rj->ekrqc", t, Mj, optimize=True)
            return np.einsum("ekrqc,sk->esrqc", t, Mk, optimize=True)

        Jslab = np.empty((npe, n_q, 3, 3))
        X = np.zeros((my, mx, p1, p1, p1, 3))  # local (k,j,i)=(z,y,x)
        X[..., 0] = ax[None, :, None, None, :]
        X[..., 1] = ay[:, None, None, :, None]
        for ez in range(mz):
            X[..., 2] = az[ez, None, None, :, None, None]
            x = mesh.map_points(X).reshape(npe, p1, p1, p1, 3)
            xq_slab = sweep(x, S, S, S).reshape(npe, n_q, 3)
            # assemble the slab contiguously, then one bulk copy (strided
            # per-column writes into big arrays hit the slow fault path)
            Jslab[:, :, :, 0] = sweep(x, S, S, D).reshape(npe, n_q, 3)
            Jslab[:, :, :, 1] = sweep(x, S, D, S).reshape(npe, n_q, 3)
            Jslab[:, :, :, 2] = sweep(x, D, S, S).reshape(npe, n_q, 3)
            yield slice(ez * npe, (ez + 1) * npe), xq_slab, Jslab

    @cached_property
    def _mapped_core(self):
        """(x_q ``[E, n_q, 3]``, det ``[E, n_q]``, coef ``[E, n_q, 6]``)
        for a mapped mesh — the three tables every operator/RHS/diagonal
        consumer actually needs, in ONE slab-streamed pass. The full
        ``[E, n_q, 3, 3]`` J / J^{-1} tensors are deliberately NOT
        materialized here (302 MB of first-touch at 1M DoFs on the slow
        fault path — see :meth:`_iter_jacobian_slabs`); the rare full-
        tensor consumers go through :attr:`_mapped_tables`."""
        n_cells, n_q = self.mesh.n_cells, self.n_q
        w = self.w3d.reshape(-1)
        xq = np.empty((n_cells, n_q, 3))
        dets = np.empty((n_cells, n_q))
        coef = np.empty((n_cells, n_q, 6))
        planes = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        cslab = None
        min_det = np.inf
        for sl, xq_slab, Jslab in self._iter_jacobian_slabs():
            xq[sl] = xq_slab
            det_s, Jinv_s = _det_inv_3x3(Jslab)
            min_det = min(min_det, float(det_s.min()))
            dets[sl] = det_s
            G = np.matmul(Jinv_s, np.swapaxes(Jinv_s, -1, -2))
            jxw = det_s * w[None, :]
            if cslab is None:
                cslab = np.empty((Jslab.shape[0], n_q, 6))
            for plane, (r, s) in enumerate(planes):
                cslab[:, :, plane] = jxw * G[:, :, r, s]
            coef[sl] = cslab
        if min_det <= 0:
            raise ValueError(
                "mapped mesh: non-positive Jacobian determinant "
                f"(min {min_det:.3e}) — mapping folds the mesh"
            )
        return xq, dets, coef

    @cached_property
    def _mapped_tables(self):
        """(x_q, J ``[E, n_q, 3, 3]``, det, J^{-1} ``[E, n_q, 3, 3]``) —
        the FULL-tensor variant for consumers that need J or J^{-1}
        per qpoint (FEEvaluation physical gradients, ``jacobian_full``).
        Reuses the core tables; the second slab pass re-runs the cheap
        sweeps and materializes the two big tensors only when asked."""
        xq, dets, _ = self._mapped_core
        n_cells, n_q = self.mesh.n_cells, self.n_q
        J = np.empty((n_cells, n_q, 3, 3))
        Jinv = np.empty((n_cells, n_q, 3, 3))
        for sl, _xq, Jslab in self._iter_jacobian_slabs():
            J[sl] = Jslab
            _, Jinv[sl] = _det_inv_3x3(Jslab)
        return xq, J, dets, Jinv

    def jacobian_full(self, dtype=np.float64) -> np.ndarray:
        """``[n_cells, n_q, 3, 3]`` Jacobian ``d x / d xi`` per qpoint."""
        if self.mapped:
            return self._mapped_tables[1].astype(dtype)
        hx, hy, hz = self.mesh.h_axes()
        mzyx = tuple(reversed(self.mesh.n_elements))
        J = np.zeros((self.mesh.n_cells, 3, 3), dtype=dtype)
        J[:, 0, 0] = np.broadcast_to(hx[None, None, :], mzyx).reshape(-1)
        J[:, 1, 1] = np.broadcast_to(hy[None, :, None], mzyx).reshape(-1)
        J[:, 2, 2] = np.broadcast_to(hz[:, None, None], mzyx).reshape(-1)
        return np.broadcast_to(
            J[:, None, :, :], (self.mesh.n_cells, self.n_q, 3, 3)
        ).copy()

    def det_q_full(self) -> np.ndarray:
        """``[n_cells, n_q]`` det(J) per qpoint."""
        if self.mapped:
            return self._mapped_core[1]
        return np.broadcast_to(
            self.det_per_cell()[:, None], (self.mesh.n_cells, self.n_q)
        )

    # ---------------------------------------------------------------- #
    # general dense tables (all mesh kinds)
    # ---------------------------------------------------------------- #
    def jxw_full(self, dtype=np.float64) -> np.ndarray:
        """``[n_cells, n_q]`` JxW table."""
        w = self.w3d.reshape(-1)
        return (self.det_q_full() * w[None, :]).astype(dtype)

    def merged_coef_full(self, dtype=np.float64) -> np.ndarray:
        """``[n_cells, n_q, 6]`` merged coefficient
        ``C(q) = JxW(q) * J^{-1} J^{-T}``, symmetric order
        (xx,xy,xz,yy,yz,zz) — what ``JacobianFunctor`` writes
        (``bp5/step-64.cu:98-113``). Diagonal on axis-aligned cells; full on
        mapped meshes. The mapped table is cached (operator setup AND
        diagonal/coarse assembly all consume it)."""
        w = self.w3d.reshape(-1)
        if self.mapped:
            return self._merged_coef_mapped.astype(dtype, copy=False)
        md = self.merged_diag_per_cell()  # [E, 3]
        coef = np.zeros((self.mesh.n_cells, self.n_q, 6), dtype=dtype)
        coef[:, :, 0] = md[:, 0:1] * w[None, :]
        coef[:, :, 3] = md[:, 1:2] * w[None, :]
        coef[:, :, 5] = md[:, 2:3] * w[None, :]
        return coef

    @property
    def _merged_coef_mapped(self) -> np.ndarray:
        """f64 mapped merged-coefficient table (slab-streamed in
        :attr:`_mapped_core`, cached there)."""
        return self._mapped_core[2]

    def inv_jacobian_full(self, dtype=np.float64) -> np.ndarray:
        """``[n_cells, n_q, 3, 3]`` inverse Jacobian per qpoint."""
        if self.mapped:
            return self._mapped_tables[3].astype(dtype)
        return _det_inv_3x3(self.jacobian_full())[1].astype(dtype)

    def q_points_phys(self) -> np.ndarray:
        """``[n_cells, n_q, 3]`` physical quadrature points, cell order
        (ez,ey,ex) flattened, qpoint order (qz,qy,qx), x fastest."""
        if self.mapped:
            return self._mapped_core[0]
        mesh, basis = self.mesh, self.basis
        qp = basis.q_points
        edges = mesh.edges_1d()
        haxes = mesh.h_axes()
        axes = [
            edges[d][:-1, None] + haxes[d][:, None] * qp[None, :] for d in range(3)
        ]
        ax, ay, az = axes  # [m_d, q1]
        mx, my, mz = mesh.n_elements
        q1 = basis.n_q
        X = np.zeros((mz, my, mx, q1, q1, q1, 3))
        X[..., 0] = ax[None, None, :, None, None, :]
        X[..., 1] = ay[None, :, None, None, :, None]
        X[..., 2] = az[:, None, None, :, None, None]
        return X.reshape(mesh.n_cells, self.n_q, 3)
