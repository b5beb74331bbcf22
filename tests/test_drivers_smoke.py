"""Driver smoke tests (CPU): the CLIs stay runnable end-to-end."""

import numpy as np
import pytest

from deal_and_ceed_on_gpu_tpu.drivers import bp, bp5


def test_bp5_run_cycle_smoke():
    cfg = bp5.BP5Config(
        degree=2, n_iterations=10, n_repetitions=1, dtype="float64",
        backend="separable", modes=("pcg-standard", "pcg-merged", "fdm-direct", "vmult"),
    )
    res = bp5.run_cycle(12, cfg)
    assert set(res) >= {"pcg-standard", "pcg-merged", "fdm-direct", "vmult", "l2_norm"}
    assert res["vmult"] > 0 and np.isfinite(res["l2_norm"])


def test_bp5_distributed_cycle_smoke():
    """Distributed driver: pcg-merged + vmult on a 2x2 block mesh (cycle 9
    has mx,my,mz = 2,2,3 — uneven in z, exercising the padding path)."""
    cfg = bp5.BP5Config(
        degree=2, n_iterations=10, n_repetitions=1, dtype="float64",
        backend="structured", modes=("pcg-merged", "vmult"),
    )
    res = bp5.run_cycle_distributed(9, 2, 2, cfg)
    assert res["pcg-merged"] > 0 and res["vmult"] > 0


def test_bp_sweep_smoke():
    res = bp.run_sweep(
        "bp1", degrees=[2], target_dofs=2000, n_iterations=5, n_repetitions=1,
        dtype="float64", modes=("pcg-merged",),
    )
    assert res[2]["pcg-merged"] > 0


def test_bp5_stencil_backend_cycle_smoke(stencil_interpret):
    """run_cycle with backend='stencil': solves and the vmult chain on the
    natural-grid kernel (interpreted on the CPU); the solve converges as
    the separable run's does."""
    cfg = bp5.BP5Config(
        degree=2, n_iterations=12, n_repetitions=1, dtype="float64",
        backend="stencil", modes=("pcg-standard", "pcg-merged", "vmult"),
    )
    res = bp5.run_cycle(8, cfg)
    assert res["pcg-merged"] > 0 and res["vmult"] > 0
    assert np.isfinite(res["l2_norm"])
    ref = bp5.run_cycle(8, bp5.BP5Config(**{**cfg.__dict__, "backend": "separable"}))
    assert res["true_rel_res"] < 1e-10 and ref["true_rel_res"] < 1e-10
    np.testing.assert_allclose(res["l2_norm"], ref["l2_norm"], rtol=1e-12)


def test_bp5_separable_sweep_modes_agree():
    """``sep_mode`` reaches the operator: matmul and shifted-add sweeps
    solve the same system to the same solution."""
    cfg = bp5.BP5Config(
        degree=3, n_iterations=12, n_repetitions=1, dtype="float64",
        backend="separable", modes=("pcg-merged",),
    )
    ref = bp5.run_cycle(8, cfg)
    res = bp5.run_cycle(8, bp5.BP5Config(**{**cfg.__dict__, "sep_mode": "stencil"}))
    np.testing.assert_allclose(
        np.asarray(res["solution"]), np.asarray(ref["solution"]), rtol=1e-11, atol=1e-13
    )
    np.testing.assert_allclose(res["l2_norm"], ref["l2_norm"], rtol=1e-12)


def test_bp5_pcg_ir_mode_smoke():
    """pcg-ir mode: mixed-precision refinement to a true f64 1e-10
    residual inside the driver."""
    cfg = bp5.BP5Config(
        degree=2, n_iterations=10, n_repetitions=1, dtype="float64",
        backend="separable", modes=("pcg-ir",),
    )
    res = bp5.run_cycle(10, cfg)
    assert res["pcg-ir"] > 0 and np.isfinite(res["l2_norm"])


@pytest.mark.parametrize("backend", ["separable", "structured"])
def test_bp5_gauss_rule_cycle_smoke(backend):
    """run_cycle with a Gauss rule (BP3-style) on the XLA backends that
    serve it."""
    cfg = bp5.BP5Config(
        degree=2, n_iterations=12, n_repetitions=1, dtype="float64",
        backend=backend, rule="gauss", modes=("pcg-merged",),
    )
    res = bp5.run_cycle(8, cfg)
    assert res["pcg-merged"] > 0 and np.isfinite(res["l2_norm"])
    assert 0 < res["true_rel_res"] < 1


def test_amr_driver_cli_smoke(tmp_path, monkeypatch, capsys):
    """The AMR CLI end-to-end: MG preconditioner, f32 reduction default,
    and VTU output all work through main()."""
    import sys

    from deal_and_ceed_on_gpu_tpu.drivers import amr

    out = tmp_path / "sol.vtu"
    monkeypatch.setattr(
        sys, "argv",
        ["amr", "--base", "3", "--steps", "1", "--precond", "mg",
         "--dtype", "float32", "--write-solution", str(out)],
    )
    amr.main()
    text = capsys.readouterr().out
    assert "estimate" in text and str(out) in text
    assert out.exists() and out.stat().st_size > 0
    # the f32 default target (1e-5) must actually converge: no step may
    # burn the full 800-iteration budget
    its = [int(line.split()[3]) for line in text.splitlines()
           if line.strip() and line.split()[0].isdigit()]
    assert its and max(its) < 800


def test_bp5_auto_backend_resolves_by_size():
    """backend='auto' on the CPU: separable for GLL and Gauss rules on a
    brick (the stencil kernel needs a GPU)."""
    cfg = bp5.BP5Config(
        degree=2, n_iterations=8, n_repetitions=1, dtype="float64",
        backend="auto", modes=("pcg-merged",),
    )
    res = bp5.run_cycle(10, cfg)  # 35k DoFs -> separable
    assert res["pcg-merged"] > 0 and np.isfinite(res["l2_norm"])
    cfg = bp5.BP5Config(
        degree=2, n_iterations=8, n_repetitions=1, dtype="float64",
        backend="auto", rule="gauss", modes=("pcg-merged",),
    )
    res = bp5.run_cycle(8, cfg)
    assert res["pcg-merged"] > 0 and np.isfinite(res["l2_norm"])


@pytest.mark.parametrize(
    "mesh,rule,platform,want",
    [
        ("uniform", "gauss_lobatto", "gpu", "stencil"),
        ("uniform", "gauss_lobatto", "cpu", "separable"),
        ("graded", "gauss_lobatto", "gpu", "stencil"),
        ("uniform", "gauss", "gpu", "separable"),
        ("mapped", "gauss_lobatto", "gpu", "structured"),
        ("mapped", "gauss", "cpu", "structured"),
    ],
)
def test_bp5_auto_backend_choice(monkeypatch, mesh, rule, platform, want):
    from deal_and_ceed_on_gpu_tpu import BrickMesh, sine_map

    m = {
        "uniform": BrickMesh((2, 2, 2)),
        "graded": BrickMesh((2, 1, 1), widths=((0.3, 0.7), (1.0,), (1.0,))),
        "mapped": BrickMesh((2, 2, 2)).deform(*sine_map(0.05)),
    }[mesh]
    monkeypatch.setattr(bp5.jax, "default_backend", lambda: platform)
    assert bp5.auto_backend(m, rule) == want


@pytest.mark.parametrize("backend", ["pallas", "pallas_general", "pallas_qgrid", "triton"])
def test_bp5_removed_backend_raises(backend):
    cfg = bp5.BP5Config(
        degree=2, n_iterations=4, n_repetitions=1, dtype="float64",
        backend=backend, modes=("pcg-merged",),
    )
    with pytest.raises(ValueError, match="unknown backend"):
        bp5.run_cycle(7, cfg)


def test_bp5_f64_stencil_cycle_smoke(stencil_interpret):
    """f64 runs on the kernel path itself: no refusal, no fallback."""
    cfg = bp5.BP5Config(
        degree=3, n_iterations=10, n_repetitions=1, dtype="float64",
        backend="stencil", modes=("pcg-merged", "vmult"),
    )
    res = bp5.run_cycle(7, cfg)
    assert res["pcg-merged"] > 0 and res["vmult"] > 0
    assert res["solution"].dtype == np.float64
