"""BP5/BP3 Poisson operator: dst = stiffness(src) with merged coefficients.

Rebuild of ``LocalPoissonOperator`` + ``PoissonOperator``
(``bp5/step-64.cu:118-276``): evaluate gradients only, contract with the
merged symmetric coefficient tensor ``C(q) = JxW(q) * J^{-1} J^{-T}`` per
quadrature point (``bp5/step-64.cu:160-188``), integrate gradients only.

Coefficient representations (see geometry.py):
- ``merged_const`` — uniform brick fast path: C(q) = w3d(q) * diag(c), three
  trace-time scalars; zero metric HBM traffic.
- ``merged_full`` — per-(cell,q) symmetric 6-plane arrays, the layout the
  reference's ``JacobianFunctor`` precomputes (``bp5/step-64.cu:60-114``);
  exercises the general-mesh path.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator

__all__ = ["PoissonOperator"]


class PoissonOperator(MatrixFreeOperator):
    needs_values = False
    needs_gradients = True

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        coefficient: str = "merged_const",
    ):
        if backend == "stencil":
            # one-pass Triton kernel on the natural grid (ops/stencil.py):
            # GLL collocation on a uniform or graded brick
            from ..ops.stencil import StencilOperator

            super().__init__(space, backend)
            self.coefficient = coefficient
            self._stencil = StencilOperator(space.mesh, space.basis, space.dtype)
            return
        super().__init__(space, backend)
        geo = space.geometry
        if coefficient == "merged_const" and not geo.uniform:
            # graded meshes: per-element coefficients (cell-loop backends)
            coefficient = "merged_full"
        self.coefficient = coefficient
        if backend == "separable":
            # Kronecker fast path (uniform mesh): see ops/separable.py
            from ..ops.separable import poisson_terms

            self._sep_terms = poisson_terms(space.mesh, space.basis, space.dtype)
            return
        if coefficient == "merged_const":
            c = geo.const_merged_diag
            self._cdiag = tuple(jnp.asarray(ci, dtype=space.dtype) for ci in c)
            self._w3d = jnp.asarray(self.w3d_layout(), dtype=space.dtype)
        elif coefficient == "merged_full":
            coef = self.to_layout(geo.merged_coef_full())  # [..., 6]
            self._coef = jnp.asarray(coef, dtype=space.dtype)
        else:
            raise ValueError(f"unknown coefficient mode {coefficient!r}")

    def vmult(self, src: jnp.ndarray) -> jnp.ndarray:
        if self.backend == "stencil":
            return self._stencil(src)
        return super().vmult(src)

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend == "stencil":
            self._stencil.fold_scale(s)
            return
        if self.backend in ("structured", "gather"):
            if self.coefficient == "merged_const":
                self._cdiag = tuple(c * s for c in self._cdiag)
            else:
                self._coef = self._coef * s
            return
        super()._apply_fold_scale(s)

    def _compute_diagonal(self):
        from .operator_base import tensor_product_diagonal

        return tensor_product_diagonal(self.space, gradient=True)

    def weak_form(self):
        return True, None, None

    def shard_table_names(self):
        """The 6-plane merged coefficient is position-dependent on
        graded/mapped meshes (uniform bricks use trace-time scalars)."""
        if self.backend in ("structured", "gather") and self.coefficient == "merged_full":
            return ("_coef",)
        return ()

    def quad_point_op(self, vals, grads):
        gx, gy, gz = grads
        if self.coefficient == "merged_const":
            cx, cy, cz = self._cdiag
            w = self._w3d
            return None, (gx * (cx * w), gy * (cy * w), gz * (cz * w))
        c = self._coef
        # symmetric 3x3 contraction, 6 planes (xx,xy,xz,yy,yz,zz) —
        # mirrors bp5/step-64.cu:164-188
        fx = c[..., 0] * gx + c[..., 1] * gy + c[..., 2] * gz
        fy = c[..., 1] * gx + c[..., 3] * gy + c[..., 4] * gz
        fz = c[..., 2] * gx + c[..., 4] * gy + c[..., 5] * gz
        return None, (fx, fy, fz)
