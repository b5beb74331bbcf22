"""step-64 Helmholtz operator: dst = (-laplace + a(x)) src.

Rebuild of ``HelmholtzOperator`` + ``LocalHelmholtzOperator`` +
``HelmholtzOperatorQuad`` (``step-64/step-64.cu:131-311``): full
evaluate(values, gradients) -> ``submit_value(a(x)*u*JxW)`` +
``submit_gradient(JxW * J^{-1}J^{-T} grad u)`` -> integrate(values,
gradients). The varying coefficient ``a(x) = 10 / (0.05 + 2|x|^2)``
(``step-64/step-64.cu:96-118``) is evaluated once at setup over the physical
quadrature points — the ``evaluate_coefficients``/``VaryingCoefficientFunctor``
equivalent (reference L-3).
"""

from __future__ import annotations

from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator

__all__ = ["HelmholtzOperator", "default_coefficient"]


def default_coefficient(x: np.ndarray) -> np.ndarray:
    """a(x) = 10 / (0.05 + 2 |x|^2)  (step-64/step-64.cu:96-118)."""
    return 10.0 / (0.05 + 2.0 * np.sum(x * x, axis=-1))


class HelmholtzOperator(MatrixFreeOperator):
    needs_values = True
    needs_gradients = True

    def __init__(
        self,
        space: FESpace,
        backend: str = "structured",
        coefficient_fn: Callable[[np.ndarray], np.ndarray] = default_coefficient,
    ):
        if backend in ("separable", "stencil"):
            # GLL collocation only: the varying-coefficient mass term is a
            # GLOBAL DIAGONAL (gather-diag-scatter over coinciding
            # node/quadrature points), so Helmholtz = Poisson Kronecker
            # terms + one diagonal term — the full fast path survives
            # (the stencil kernel reads that diagonal as its value field)
            if not space.basis.collocation:
                raise ValueError(
                    f"{backend} Helmholtz requires GLL collocation (the "
                    "Gauss-rule mass term with varying a(x) is not separable)"
                )
            from ..ops.separable import poisson_terms

            super().__init__(space, backend)
            # the assembled a(x)*JxW diagonal depends on the block's
            # physical position and cannot be sliced per shard
            self._dist_unsupported = (
                f"{backend} Helmholtz has a position-dependent global "
                "diagonal; use backend='structured' for distribution"
            )
            geo = space.geometry
            xq = geo.q_points_phys()
            a_q = np.asarray(coefficient_fn(xq), dtype=np.float64)
            self._a_q_raw = a_q
            ajxw = (a_q * geo.jxw_full()).reshape(-1)
            dvec = np.zeros(space.n_dofs)
            np.add.at(dvec, space.mesh.element_dof_map(space.degree).reshape(-1), ajxw)
            nz, ny, nx = space.grid_shape
            if backend == "stencil":
                from ..ops.stencil import StencilOperator

                self._stencil = StencilOperator(
                    space.mesh, space.basis, space.dtype, value_diag=dvec
                )
                return
            self._sep_terms = poisson_terms(space.mesh, space.basis, space.dtype) + [
                {
                    "coef": 1.0,
                    "band": [],
                    "diag": jnp.asarray(dvec.reshape(nz, ny, nx), space.dtype),
                }
            ]
            return
        super().__init__(space, backend)
        geo = space.geometry
        xq = geo.q_points_phys()  # [n_cells, n_q, 3]
        a_q = np.asarray(coefficient_fn(xq), dtype=np.float64)
        self._a_q_raw = a_q  # kept for compute_diagonal
        # fold JxW into the value coefficient: a(x_q) * JxW(e, q)
        self._coef_val = jnp.asarray(
            self.to_layout(a_q * geo.jxw_full()), dtype=space.dtype
        )
        self._full_contraction = geo.mapped
        if geo.uniform:
            self._cdiag = tuple(
                jnp.asarray(c, dtype=space.dtype) for c in geo.const_merged_diag
            )
            self._w3d = jnp.asarray(self.w3d_layout(), dtype=space.dtype)
            self._coef_g = None
        else:
            # graded: diagonal planes only; mapped: all six planes live
            self._coef_g = jnp.asarray(
                self.to_layout(geo.merged_coef_full()), dtype=space.dtype
            )

    def vmult(self, src: jnp.ndarray) -> jnp.ndarray:
        if self.backend == "stencil":
            return self._stencil(src)
        return super().vmult(src)

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend == "stencil":
            self._stencil.fold_scale(s)
            return
        if self.backend in ("structured", "gather"):
            self._coef_val = self._coef_val * s
            if self._coef_g is None:
                self._cdiag = tuple(c * s for c in self._cdiag)
            else:
                self._coef_g = self._coef_g * s
            return
        super()._apply_fold_scale(s)

    def _compute_diagonal(self):
        from .operator_base import tensor_product_diagonal

        return tensor_product_diagonal(
            self.space, gradient=True, value_q=self._a_q_raw
        )

    def weak_form(self):
        return True, self._a_q_raw, None

    def shard_table_names(self):
        """The value coefficient a(x_q)*JxW depends on the block's physical
        position (reference ``VaryingCoefficientFunctor``,
        ``step-64/step-64.cu:69-118``); the gradient tables do too on
        graded/mapped meshes."""
        if self.backend in ("separable", "stencil"):
            return ()
        if self._coef_g is not None:
            return ("_coef_val", "_coef_g")
        return ("_coef_val",)

    def quad_point_op(self, vals, grads):
        gx, gy, gz = grads
        if self._coef_g is None:
            cx, cy, cz = self._cdiag
            w = self._w3d
            flux = (gx * (cx * w), gy * (cy * w), gz * (cz * w))
        elif self._full_contraction:
            c = self._coef_g
            # symmetric 3x3 contraction (bp5/step-64.cu:164-188)
            flux = (
                c[..., 0] * gx + c[..., 1] * gy + c[..., 2] * gz,
                c[..., 1] * gx + c[..., 3] * gy + c[..., 4] * gz,
                c[..., 2] * gx + c[..., 4] * gy + c[..., 5] * gz,
            )
        else:
            c = self._coef_g
            flux = (c[..., 0] * gx, c[..., 3] * gy, c[..., 5] * gz)
        return vals * self._coef_val, flux
