"""``bench.py`` and ``chip_smoke.py`` refuse to measure without a GPU, the
format of their last line, and where the compile cache lands."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from deal_and_ceed_on_gpu_tpu.utils import device, enable_compilation_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("argv", [[], ["--backend", "separable"]])
def test_bench_refuses_cpu(argv):
    bench = _load("bench")
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main(argv)


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    smoke = _load("chip_smoke")
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_result_line_format():
    line = device.result_line()
    rec = json.loads(line)
    assert list(rec) == ["ok", "device"] and rec["ok"] is True
    d = jax.devices()
    assert rec["device"] == {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}
    assert "\n" not in line


def test_result_line_extra_fields():
    rec = json.loads(device.result_line(metric="m", value=1.5))
    assert rec["metric"] == "m" and rec["value"] == 1.5 and set(rec["device"]) == {"platform", "kind", "count"}


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script fails and prints no
    result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache() == str(tmp_path)
    # the variable is JAX's own: no directory is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = enable_compilation_cache()
        assert d == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d and os.path.isdir(d)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
