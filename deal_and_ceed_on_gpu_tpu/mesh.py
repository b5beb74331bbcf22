"""Structured brick meshes with lexicographic continuous Q_p DoF numbering.

Replacement for the reference's L0 layer
(``parallel::distributed::Triangulation`` + p4est + ``DoFHandler``/``FE_Q`` +
``AffineConstraints``; call sites ``bp5/step-64.cu:310-358,660-663``):
on a structured brick every map the GPU code stores as per-cell index tables
(``local_to_global``, constraint masks) is pure index arithmetic, so the
element<->global DoF relation is *computed*, never gathered from memory, and
partitioning for SPMD is a block decomposition of the element grid.

Conventions
-----------
- dim = 3 (2D/1D fall out of the same arithmetic but are not exercised yet).
- Elements indexed by (ez, ey, ex), x fastest.
- Global DoFs on the tensor grid of per-axis node lines; global id
  ``g = ix + Nx*(iy + Ny*iz)`` with ``Nd = m_d*p + 1`` nodes per axis.
- The whole boundary carries a zero-Dirichlet constraint (reference
  ``bp5/step-64.cu:351-358``: ``interpolate_boundary_values`` on id 0).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

__all__ = ["BrickMesh", "MappedMesh", "shear_map", "sine_map"]


@dataclasses.dataclass(frozen=True)
class BrickMesh:
    """A uniform axis-aligned hexahedral brick mesh.

    Equivalent of ``GridGenerator::subdivided_hyper_rectangle`` +
    ``refine_global`` (``bp5/step-64.cu:661-663``): ``n_elements[d]`` cells
    along axis d covering ``[lower[d], upper[d]]``.
    """

    n_elements: tuple[int, int, int]  # (mx, my, mz)
    lower: tuple[float, float, float] = (0.0, 0.0, 0.0)
    upper: tuple[float, float, float] = (1.0, 1.0, 1.0)
    # graded tensor-product meshes: per-axis element widths (len m_d).
    # None = uniform. Tensor-product grading keeps the Kronecker fast path:
    # every geometric factor separates per axis.
    widths: tuple | None = None

    def __post_init__(self):
        if self.widths is not None:
            w = tuple(np.asarray(a, dtype=np.float64) for a in self.widths)
            for d in range(3):
                assert w[d].shape == (self.n_elements[d],)
                span = self.upper[d] - self.lower[d]
                assert abs(w[d].sum() - span) < 1e-10 * max(abs(span), 1.0)
                w[d].setflags(write=False)
            object.__setattr__(self, "widths", w)

    @property
    def is_uniform(self) -> bool:
        return self.widths is None and not self.is_mapped

    @property
    def is_mapped(self) -> bool:
        """True when a smooth deformation is applied on top of the brick
        (see :class:`MappedMesh`); geometry then carries full per-qpoint
        Jacobians instead of per-axis widths."""
        return False

    def deform(
        self,
        mapping: Callable[[np.ndarray], np.ndarray],
        mapping_jacobian: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    ) -> "MappedMesh":
        """Deform this brick by a smooth map ``x = phi(X)`` of its physical
        coordinates (the deal.II ``MappingQGeneric`` general-geometry path,
        reference L-16; Jacobians consumed at ``bp5/step-64.cu:90-113``).
        The discrete geometry is the degree-p isoparametric interpolant of
        ``phi`` at the element nodal points."""
        return MappedMesh(
            self.n_elements,
            self.lower,
            self.upper,
            self.widths,
            mapping=mapping,
            mapping_jacobian=mapping_jacobian,
        )

    @staticmethod
    def graded(breaks_x, breaks_y, breaks_z) -> "BrickMesh":
        """Tensor-product mesh from per-axis breakpoint arrays (len m_d+1,
        strictly increasing)."""
        bks = [np.asarray(b, dtype=np.float64) for b in (breaks_x, breaks_y, breaks_z)]
        for b in bks:
            assert np.all(np.diff(b) > 0), "breakpoints must increase"
        return BrickMesh(
            tuple(b.size - 1 for b in bks),
            tuple(float(b[0]) for b in bks),
            tuple(float(b[-1]) for b in bks),
            widths=tuple(np.diff(b) for b in bks),
        )

    @staticmethod
    def subdivided_hyper_rectangle(
        subdivisions: tuple[int, int, int],
        lower=(0.0, 0.0, 0.0),
        upper=None,
    ) -> "BrickMesh":
        if upper is None:
            # reference BP5 convention: unit-size cells, domain [0, s_d]^d
            upper = tuple(float(s) for s in subdivisions)
        return BrickMesh(tuple(int(s) for s in subdivisions), tuple(lower), tuple(upper))

    @staticmethod
    def hyper_cube(left: float = 0.0, right: float = 1.0) -> "BrickMesh":
        return BrickMesh((1, 1, 1), (left,) * 3, (right,) * 3)

    def refine_global(self, times: int = 1) -> "BrickMesh":
        f = 2**times
        widths = None
        if self.widths is not None:
            widths = tuple(np.repeat(w / f, f) for w in self.widths)
        # dataclasses.replace preserves the concrete class (MappedMesh keeps
        # its mapping through refinement)
        return dataclasses.replace(
            self, n_elements=tuple(m * f for m in self.n_elements), widths=widths
        )

    @staticmethod
    def bp5_cycle(cycle: int) -> "BrickMesh":
        """The BP5 benchmark's geometric mesh sweep (``bp5/step-64.cu:629-663``):
        cycle -> subdivisions in {1,2,3}x{1,2}x{1,2} + global refinement, giving
        cell counts growing by ~2x per cycle."""
        n_refine = cycle // 6
        rem = cycle % 6
        subdiv = [1, 1, 1]
        if rem == 1 and cycle > 1:
            subdiv = [3, 2, 2]
            n_refine -= 1
        elif rem == 2:
            subdiv = [2, 1, 1]
        elif rem == 3:
            subdiv = [3, 1, 1]
        elif rem == 4:
            subdiv = [2, 2, 1]
        elif rem == 5:
            subdiv = [3, 2, 1]
        return BrickMesh.subdivided_hyper_rectangle(tuple(subdiv)).refine_global(n_refine)

    # ------------------------------------------------------------------ #
    @property
    def n_cells(self) -> int:
        mx, my, mz = self.n_elements
        return mx * my * mz

    @property
    def h(self) -> tuple[float, float, float]:
        """Element extents per axis — uniform meshes only."""
        if not self.is_uniform:
            raise ValueError("graded mesh: use h_axes()")
        return tuple(
            (self.upper[d] - self.lower[d]) / self.n_elements[d] for d in range(3)
        )

    def h_axes(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-axis element width arrays (len m_d), uniform or graded."""
        if self.widths is not None:
            return self.widths
        return tuple(
            np.full(self.n_elements[d], (self.upper[d] - self.lower[d]) / self.n_elements[d])
            for d in range(3)
        )

    def edges_1d(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-axis element edge coordinates (len m_d + 1)."""
        hx, hy, hz = self.h_axes()
        return tuple(
            self.lower[d] + np.concatenate([[0.0], np.cumsum(w)])
            for d, w in enumerate((hx, hy, hz))
        )

    # ------------------------------------------------------------------ #
    # DoF handler functionality for continuous Q_p elements
    # ------------------------------------------------------------------ #
    def n_nodes(self, degree: int) -> tuple[int, int, int]:
        """Global node-line counts per axis: N_d = m_d * p + 1."""
        return tuple(m * degree + 1 for m in self.n_elements)

    def n_dofs(self, degree: int) -> int:
        nx, ny, nz = self.n_nodes(degree)
        return nx * ny * nz

    def node_coords_1d(self, degree: int, nodes_1d: np.ndarray) -> list[np.ndarray]:
        """Physical coordinates of the global node lines per axis, given the
        (p+1) reference nodal points in [0,1] (GLL for FE_Q)."""
        out = []
        edges = self.edges_1d()
        haxes = self.h_axes()
        for d in range(3):
            # element e covers [edge_e, edge_e + h_e]; interior nodes are
            # shared so keep unique lexicographic lines
            lines = edges[d][:-1, None] + haxes[d][:, None] * nodes_1d[None, :]
            uniq = np.concatenate([lines[:, :-1].reshape(-1), lines[-1:, -1]])
            out.append(uniq)
        return out

    def element_dof_map(self, degree: int) -> np.ndarray:
        """``local_to_global``: int32 ``[n_cells, (p+1)^3]`` map from cell-local
        lexicographic DoF index to global DoF (reference L-1 table,
        ``bp5/fe_evaluation_gl.h:135-152``). Only needed by the general
        gather backend — the structured backend never materializes it.
        Large meshes use the native C++ builder when available."""
        p = degree
        if self.n_cells * (p + 1) ** 3 > 1 << 22:
            from .utils import native

            mx_, my_, mz_ = self.n_elements
            out = native.element_dof_map(mx_, my_, mz_, p)
            if out is not None:
                return out
        nx, ny, nz = self.n_nodes(p)
        mx, my, mz = self.n_elements
        ex = np.arange(mx) * p  # global start index per element, axis x
        ey = np.arange(my) * p
        ez = np.arange(mz) * p
        lx = np.arange(p + 1)
        gx = ex[:, None] + lx[None, :]  # [mx, p+1]
        gy = ey[:, None] + lx[None, :]
        gz = ez[:, None] + lx[None, :]
        # global id = ix + Nx*(iy + Ny*iz); element order (ez,ey,ex), local (k,j,i)
        g = (
            gx[None, None, :, None, None, :]
            + nx * gy[None, :, None, None, :, None]
            + nx * ny * gz[:, None, None, :, None, None]
        )  # [mz, my, mx, p+1(k), p+1(j), p+1(i)]
        return np.ascontiguousarray(
            g.reshape(self.n_cells, (p + 1) ** 3), dtype=np.int32
        )

    def boundary_dof_mask(self, degree: int) -> np.ndarray:
        """Boolean ``[n_dofs]`` mask of DoFs on the domain boundary (all six
        faces), i.e. the zero-Dirichlet constrained set (reference L-15,
        ``bp5/step-64.cu:351-358``)."""
        nx, ny, nz = self.n_nodes(degree)
        ix = np.arange(nx)
        iy = np.arange(ny)
        iz = np.arange(nz)
        bx = (ix == 0) | (ix == nx - 1)
        by = (iy == 0) | (iy == ny - 1)
        bz = (iz == 0) | (iz == nz - 1)
        mask = (
            bx[None, None, :] | by[None, :, None] | bz[:, None, None]
        )  # [nz, ny, nx]
        return mask.reshape(-1)

    def map_points(self, X: np.ndarray) -> np.ndarray:
        """Apply the mesh deformation to brick coordinates (identity here)."""
        return X

    def interior_multiplicity(self, degree: int) -> np.ndarray:
        """How many elements share each global DoF — useful for tests and for
        counting-based assembly checks."""
        p = degree
        counts = []
        for d in range(3):
            n = self.n_nodes(p)[d]
            c = np.ones(n)
            if self.n_elements[d] > 1:
                c[p:-1:p] = 2.0 if p > 0 else 1.0
                c[p::p] = 2.0
                c[-1] = 1.0
            counts.append(c)
        cx, cy, cz = counts
        return (cz[:, None, None] * cy[None, :, None] * cx[None, None, :]).reshape(-1)


@dataclasses.dataclass(frozen=True)
class MappedMesh(BrickMesh):
    """A brick mesh deformed by a smooth map ``x = phi(X)``.

    Topology, DoF numbering, constraints, and partitioning are those of the
    underlying brick (``X`` coordinates); only the *geometry* changes — per
    element and quadrature point the full (generally non-diagonal) Jacobian
    ``J = dx/dxi`` is carried, exactly what the reference's
    ``MappingQGeneric`` tables provide (``inv_jacobian``/``JxW`` read at
    ``bp5/step-64.cu:90-113``). The discrete mapping is isoparametric: the
    degree-p interpolant of ``phi`` at the FE nodal points, matching
    ``MappingQGeneric<dim>(p)`` (``bp5/step-64.cu:234``).

    ``mapping`` takes ``[..., 3]`` brick coordinates to ``[..., 3]``
    physical coordinates; the optional ``mapping_jacobian`` returns the
    analytic ``[..., 3, 3]`` ``d phi_c / d X_r`` (tests use it to validate
    the interpolated Jacobians).
    """

    mapping: Callable[[np.ndarray], np.ndarray] = None
    mapping_jacobian: Optional[Callable[[np.ndarray], np.ndarray]] = None

    @property
    def is_mapped(self) -> bool:
        return True

    def map_points(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(self.mapping(np.asarray(X, dtype=np.float64)))


def shear_map(s_xy: float = 0.0, s_xz: float = 0.0, s_yz: float = 0.0):
    """Affine shear ``x += s_xy*y + s_xz*z; y += s_yz*z`` — the simplest
    deformation with a full (non-diagonal, constant) Jacobian; its analytic
    Jacobian is exact at any mapping degree."""
    M = np.array(
        [[1.0, s_xy, s_xz], [0.0, 1.0, s_yz], [0.0, 0.0, 1.0]]
    )

    def phi(X):
        return X @ M.T

    def jac(X):
        return np.broadcast_to(M, X.shape[:-1] + (3, 3)).copy()

    return phi, jac


def sine_map(amplitude: float = 0.05, periods: int = 1):
    """Smooth volume-preserving-ish wave deformation of the unit cube (a
    Kershaw-style smoothly varying metric): every Jacobian entry varies per
    quadrature point and all six merged-coefficient planes are non-zero."""
    a, k = amplitude, 2.0 * np.pi * periods

    def phi(X):
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        return np.stack(
            [
                x + a * np.sin(k * y) * np.sin(k * z),
                y + a * np.sin(k * x) * np.sin(k * z),
                z + a * np.sin(k * x) * np.sin(k * y),
            ],
            axis=-1,
        )

    def jac(X):
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        J = np.zeros(X.shape[:-1] + (3, 3))
        sx, cx = np.sin(k * x), np.cos(k * x)
        sy, cy = np.sin(k * y), np.cos(k * y)
        sz, cz = np.sin(k * z), np.cos(k * z)
        J[..., 0, 0] = 1.0
        J[..., 0, 1] = a * k * cy * sz
        J[..., 0, 2] = a * k * sy * cz
        J[..., 1, 0] = a * k * cx * sz
        J[..., 1, 1] = 1.0
        J[..., 1, 2] = a * k * sx * cz
        J[..., 2, 0] = a * k * cx * sy
        J[..., 2, 1] = a * k * sx * cy
        J[..., 2, 2] = 1.0
        return J

    return phi, jac
