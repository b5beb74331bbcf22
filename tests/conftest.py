"""Test configuration: CPU backend with 8 virtual devices (multi-device
sharding tests without a multi-GPU host) and float64 enabled (the reference
is double precision throughout, ``bp5/step-64.cu:206``).

Card-only tests carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them unless JAX's first device is a GPU. They run on a GPU
machine with ``DLCG_TESTS_ON_GPU=1 python -m pytest -m gpu tests/``; that
variable leaves the platform to JAX instead of forcing the CPU."""

import functools
import os

import pytest

ON_GPU = os.environ.get("DLCG_TESTS_ON_GPU") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

if not ON_GPU:
    assert jax.devices()[0].platform == "cpu", jax.devices()
    assert len(jax.devices()) >= 8, "need xla_force_host_platform_device_count=8"


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {platform!r}")


@pytest.fixture
def stencil_interpret(monkeypatch):
    """Run the Triton stencil kernel through the Pallas interpreter: the
    CPU has no Triton lowering."""
    from deal_and_ceed_on_gpu_tpu.ops import stencil

    orig = stencil.stencil_apply

    @functools.wraps(orig)
    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(stencil, "stencil_apply", interpreted)
