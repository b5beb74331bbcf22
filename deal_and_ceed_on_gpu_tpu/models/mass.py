"""BP1 mass operator: dst = M src (values-only quad-point op).

CEED BP1 configuration (BASELINE.json): full Gauss quadrature q = p+2, i.e.
the rectangular-interpolation path the reference's collocation evaluator was
built to skip (SURVEY.md section 7 item 7). Exercises ``evaluate(values)`` /
``integrate(values)`` with non-square S.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..fe_space import FESpace
from .operator_base import MatrixFreeOperator

__all__ = ["MassOperator"]


class MassOperator(MatrixFreeOperator):
    needs_values = True
    needs_gradients = False

    def __init__(self, space: FESpace, backend: str = "structured"):
        super().__init__(space, backend)
        if backend == "separable":
            from ..ops.separable import mass_terms

            self._sep_terms = mass_terms(space.mesh, space.basis, space.dtype)
            return
        self._jxw = jnp.asarray(self.jxw_layout(), dtype=space.dtype)

    def _apply_fold_scale(self, s: float) -> None:
        if self.backend == "separable":
            return super()._apply_fold_scale(s)
        self._jxw = self._jxw * s

    def quad_point_op(self, vals, grads):
        return vals * self._jxw, None

    def _compute_diagonal(self):
        from .operator_base import tensor_product_diagonal

        return tensor_product_diagonal(self.space, value_const=1.0)

    def weak_form(self):
        return False, None, 1.0

    def shard_table_names(self):
        """JxW is position-dependent on graded/mapped meshes."""
        if self.backend != "separable" and not self.space.geometry.uniform:
            return ("_jxw",)
        return ()
