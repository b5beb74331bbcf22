"""1D finite-element bases and quadrature on the unit reference interval [0, 1].

Equivalent of the reference's shape-value tables: the 1D
interpolation matrix ``S[q, p+1]`` and derivative matrix ``D[q, p+1]`` that
feed the sum-factorization sweeps (reference: deal.II
``internal::EvaluatorTensorProduct`` as used by
``bp5/fe_evaluation_gl.h:192-250``, and the ``COLLOCATION`` /
``QGaussLobatto`` switch in ``bp5/step-64.cu:47-49,243-247``).

Everything here is numpy/float64 host-side setup code; the matrices are tiny
((p+1) x q with p <= 8ish) and are baked into the traced JAX computation as
constants.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

__all__ = [
    "gauss_points",
    "gauss_lobatto_points",
    "lagrange_eval",
    "Basis1D",
    "basis_tables_3d",
]


def basis_tables_3d(basis: "Basis1D") -> tuple[np.ndarray, np.ndarray]:
    """Dense 3D basis tables: values ``V[(p+1)^3, n_q^3]`` and reference
    gradients ``G[3, (p+1)^3, n_q^3]`` (local dof order (k,j,i) with i=x
    fastest, qpoint order (qz,qy,qx) with qx fastest). Small; used for
    general-geometry setup (diagonals, oracle assembly), never on the hot
    path — the hot path stays sum-factorized."""
    S, D = basis.S, basis.D  # [q, p+1]
    V = np.einsum("ck,bj,ai->kjicba", S, S, S)
    Gx = np.einsum("ck,bj,ai->kjicba", S, S, D)
    Gy = np.einsum("ck,bj,ai->kjicba", S, D, S)
    Gz = np.einsum("ck,bj,ai->kjicba", D, S, S)
    n, q = basis.n_dofs**3, basis.n_q**3
    return V.reshape(n, q), np.stack(
        [Gx.reshape(n, q), Gy.reshape(n, q), Gz.reshape(n, q)]
    )


def gauss_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points and weights on [0, 1]. ``n`` points: exact to
    degree 2n-1 (reference quadrature ``QGauss(p+1)``, ``bp5/step-64.cu:243``)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (x + 1.0) / 2.0, w / 2.0


def gauss_lobatto_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto-Legendre points and weights on [0, 1] (n >= 2 points,
    includes endpoints; exact to degree 2n-3). These are both the FE_Q nodal
    support points and the ``QGaussLobatto`` collocation quadrature
    (reference ``bp5/step-64.cu:245-247``)."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        x = np.array([-1.0, 1.0])
    else:
        # interior GLL points are the roots of P'_{n-1}
        leg = np.polynomial.legendre.Legendre.basis(n - 1)
        x = np.concatenate([[-1.0], leg.deriv().roots(), [1.0]])
    x = np.sort(x)
    # w_i = 2 / (n(n-1) P_{n-1}(x_i)^2)
    pn = np.polynomial.legendre.Legendre.basis(n - 1)(x)
    w = 2.0 / (n * (n - 1) * pn**2)
    return (x + 1.0) / 2.0, w / 2.0


def lagrange_eval(nodes: np.ndarray, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values and first derivatives of the Lagrange basis through ``nodes``
    evaluated at ``pts``.

    Returns ``(S, D)`` with ``S[q, j] = phi_j(pts[q])`` and
    ``D[q, j] = phi_j'(pts[q])``. Stable direct product formulas in float64
    (degrees here are <= ~16, far below where Lagrange conditioning bites).
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    pts = np.asarray(pts, dtype=np.float64)
    n = nodes.shape[0]
    S = np.empty((pts.shape[0], n))
    D = np.empty((pts.shape[0], n))
    for j in range(n):
        others = np.delete(nodes, j)
        denom = np.prod(nodes[j] - others)
        # phi_j(x) = prod_k (x - x_k) / denom
        diffs = pts[:, None] - others[None, :]  # [q, n-1]
        S[:, j] = np.prod(diffs, axis=1) / denom
        # phi_j'(x) = sum_m prod_{k != m} (x - x_k) / denom
        dsum = np.zeros_like(pts)
        for m in range(n - 1):
            mask = np.ones(n - 1, dtype=bool)
            mask[m] = False
            dsum += np.prod(diffs[:, mask], axis=1)
        D[:, j] = dsum / denom
    return S, D


@dataclasses.dataclass(frozen=True)
class Basis1D:
    """1D tensor-product building block for Q_p elements.

    Attributes
    ----------
    degree: polynomial degree p.
    nodes:  p+1 nodal (support) points in [0,1] — GLL, matching FE_Q.
    q_points, q_weights: quadrature rule with ``n_q`` points in [0,1].
    S: ``[n_q, p+1]`` interpolation matrix (values at quadrature points).
    D: ``[n_q, p+1]`` derivative matrix (d/dx at quadrature points, unit cell).
    collocation: True iff quadrature points coincide with nodes (then S == I
        and the value-interpolation sweeps can be skipped — the reference's
        ``FEEvaluationGL`` fast path, ``bp5/fe_evaluation_gl.h:26``).
    """

    degree: int
    nodes: np.ndarray
    q_points: np.ndarray
    q_weights: np.ndarray
    S: np.ndarray
    D: np.ndarray
    collocation: bool

    @property
    def n_dofs(self) -> int:
        return self.degree + 1

    @property
    def n_q(self) -> int:
        return self.q_points.shape[0]

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(degree: int, n_q: int | None = None, rule: str = "gauss_lobatto") -> "Basis1D":
        """Build a degree-p basis with an ``n_q``-point rule.

        rule="gauss_lobatto", n_q=p+1  -> BP5/BP6 collocation setting
        rule="gauss",         n_q=p+1  -> step-64 / default FE_Q setting
        rule="gauss",         n_q=p+2  -> BP1/BP3 full-quadrature setting
        """
        if degree < 1:
            raise ValueError("degree must be >= 1")
        n_q = degree + 1 if n_q is None else n_q
        nodes, _ = gauss_lobatto_points(degree + 1)
        if rule == "gauss_lobatto":
            qp, qw = gauss_lobatto_points(n_q)
        elif rule == "gauss":
            qp, qw = gauss_points(n_q)
        else:
            raise ValueError(f"unknown quadrature rule: {rule}")
        S, D = lagrange_eval(nodes, qp)
        collocation = rule == "gauss_lobatto" and n_q == degree + 1
        if collocation:
            # exactly identity up to roundoff; snap it so the einsum path can
            # drop the interpolation sweeps without numerical drift
            S = np.eye(n_q)
        for arr in (nodes, qp, qw, S, D):
            arr.setflags(write=False)
        return Basis1D(degree, nodes, qp, qw, S, D, collocation)
