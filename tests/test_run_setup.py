"""Run-time setup shared by the entry points: the compile-cache location,
the device peak table, the GPU requirement of measurement paths, and the
benchmark's exit status."""

import importlib.util
import json
import os

import jax
import pytest

from g2o_tpu.utils import cache, device, flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_honours_env(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []                     # nothing else is set in code


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    first = cache.enable_compile_cache()
    assert first == cache.enable_compile_cache() == \
        os.path.join(REPO, ".cache", "jax")
    assert ("jax_compilation_cache_dir", first) in calls


class _Dev:
    def __init__(self, kind, platform="gpu"):
        self.device_kind = kind
        self.platform = platform


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "H100 SXM5"])
def test_peak_table_resolves_h100(kind):
    assert flops.device_peak_flops(_Dev(kind)) == 495e12
    assert flops.device_peaks(_Dev(kind))["f32_flops_per_s"] == 67e12


def test_peak_table_refuses_unknown_device():
    with pytest.raises(ValueError, match="no peak rates"):
        flops.device_peak_flops(_Dev("cpu"))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        device.require_gpu(_Dev("cpu", platform="cpu"))
    gpu = _Dev("NVIDIA H100 80GB HBM3")
    assert device.require_gpu(gpu) is gpu


def test_chip_smoke_phase0_refuses_cpu():
    """chip_smoke never carries on when JAX finds no GPU."""
    chip_smoke = _load_script("chip_smoke")
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit):
        chip_smoke.phase_device()


def test_bench_exits_nonzero_when_a_config_raises(monkeypatch, tmp_path,
                                                  capsys):
    bench = _load_script("bench")

    def boom(dev):
        raise RuntimeError("config failed")

    monkeypatch.setattr(bench, "RUNNERS",
                        [("ok", lambda dev: {"sec_per_iter": 1.0}),
                         ("broken", boom)])
    monkeypatch.setattr(device, "require_gpu",
                        lambda: jax.devices()[0])
    monkeypatch.setattr(device, "card_info", lambda: "test card, 1.00 W")
    monkeypatch.setattr(cache, "enable_compile_cache", lambda: "")
    out = tmp_path / "result.json"
    assert bench.main(["--out", str(out)]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "broken" in line["errors"] and "ok" in line["configs"]
    assert line["card"] == "test card, 1.00 W"
    full = json.loads(out.read_text())
    assert full["extra"]["configs"]["ok"]["sec_per_iter"] == 1.0
