"""Auxiliary subsystems: checkpoint/restore, profiling helpers, step-64
driver end-to-end (golden values), VTU from the driver."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np

from deal_and_ceed_on_gpu_tpu.drivers import step64
from deal_and_ceed_on_gpu_tpu.utils.checkpoint import load_state, save_state
import pytest

from deal_and_ceed_on_gpu_tpu.utils.profiling import op_stats, roofline, trace


def test_checkpoint_roundtrip(tmp_path):
    x = jnp.arange(10.0)
    g = np.ones((3, 4))
    p = save_state(tmp_path / "ck.npz", {"x": x, "g": g}, {"it": 7, "res": 1e-9})
    arrays, meta = load_state(p)
    np.testing.assert_array_equal(arrays["x"], np.arange(10.0))
    np.testing.assert_array_equal(arrays["g"], g)
    assert meta == {"it": 7, "res": 1e-9}


def test_op_stats_and_roofline():
    import jax

    f = jax.jit(lambda x: x * 2.0)
    s = op_stats(f, jnp.ones(1000), n_warmup=1, n_iter=3, work_items=1000)
    assert s["best_s"] > 0 and s["items_per_s"] > 0
    r = roofline(12_468_001, 5, "NVIDIA H100 80GB HBM3")
    # f32: 8 bytes per DoF at 3.35 TB/s
    np.testing.assert_allclose(r["bandwidth_bound_gdofs"], 3350.0 / 8)
    r64 = roofline(12_468_001, 5, "NVIDIA H100 80GB HBM3", dtype_bytes=8)
    np.testing.assert_allclose(r64["bandwidth_bound_gdofs"], 3350.0 / 16)
    assert r64["compute_bound_gdofs"] < r["compute_bound_gdofs"]
    with pytest.raises(ValueError, match="no published peaks"):
        roofline(1000, 5, "cpu")


def test_trace_default_dir_follows_tmpdir(tmp_path, monkeypatch):
    """Without a logdir the trace lands under the process's temp dir, so
    two runs with their own ``TMPDIR`` never share a trace directory."""
    import jax

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with trace() as logdir:
        jax.block_until_ready(jnp.ones(8) * 2.0)
    assert logdir == os.path.join(str(tmp_path), "jax_trace")
    assert os.path.isdir(logdir)


def test_step64_driver_golden(tmp_path):
    """End-to-end correctness oracle for the tutorial workload: iteration
    count and L2 norm are golden values (self-consistent across solver and
    backend variants; the reference compares by eye vs CPU deal.II)."""
    r1 = step64.run(n_refine=2, degree=3, dtype="float64", use_merged=False)
    r2 = step64.run(
        n_refine=2,
        degree=3,
        dtype="float64",
        use_merged=True,
        vtu_path=str(tmp_path / "sol.vtr"),
    )
    assert r1["n_iterations"] == r2["n_iterations"]
    np.testing.assert_allclose(r1["l2_norm"], r2["l2_norm"], rtol=1e-10)
    # golden values (f64, CPU): regression fingerprints of the whole stack
    assert r1["n_iterations"] == 60
    np.testing.assert_allclose(r1["l2_norm"], 0.020526851356887806, rtol=1e-9)
    # golden: stable fingerprints of the discretization
    assert (tmp_path / "sol.vtr").exists()
    gather = step64.run(n_refine=2, degree=3, dtype="float64", backend="gather")
    assert gather["n_iterations"] == r1["n_iterations"]
    np.testing.assert_allclose(gather["l2_norm"], r1["l2_norm"], rtol=1e-12)


def test_adaptive_checkpoint_roundtrip(tmp_path):
    """An AMR state (mesh + solution) survives save/load: the rebuilt
    space has identical DoF numbering and the resumed solve is a no-op."""
    import jax.numpy as jnp
    import numpy as np

    from deal_and_ceed_on_gpu_tpu import BrickMesh
    from deal_and_ceed_on_gpu_tpu.adaptive import (
        AdaptiveMesh,
        AdaptivePoissonOperator,
        AdaptiveSpace,
        assemble_rhs_adaptive,
    )
    from deal_and_ceed_on_gpu_tpu.solvers import (
        ReductionControl,
        SolverControl,
        solve_cg,
    )
    from deal_and_ceed_on_gpu_tpu.utils.checkpoint import (
        load_adaptive_state,
        save_adaptive_state,
    )

    amesh = AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0, 7))
    space = AdaptiveSpace(amesh, 2)
    op = AdaptivePoissonOperator(space)
    b = assemble_rhs_adaptive(space, 1.0)
    control = ReductionControl(400, tolerance=0.0, reduction=1e-11)
    x, _ = solve_cg(op.vmult, b, control)

    p = save_adaptive_state(tmp_path / "amr.npz", space, x, meta={"step": 3})
    space2, x2, meta = load_adaptive_state(p)
    assert meta["step"] == 3
    assert space2.n_dofs == space.n_dofs
    np.testing.assert_array_equal(
        np.asarray(space2.elem_dof_map), np.asarray(space.elem_dof_map)
    )
    np.testing.assert_allclose(np.asarray(x2), np.asarray(x), rtol=0, atol=0)
    # resuming the solve from the checkpoint converges immediately
    # (absolute tolerance: a reduction target would re-measure from the
    # already-tiny warm-start residual)
    op2 = AdaptivePoissonOperator(space2)
    b2 = assemble_rhs_adaptive(space2, 1.0)
    abs_control = SolverControl(400, 1e-10 * float(jnp.linalg.norm(b2)))
    _, info = solve_cg(op2.vmult, b2, abs_control, x0=x2)
    assert int(info["n_iterations"]) <= 1
