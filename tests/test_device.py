"""Accelerator plumbing (cdlrm_tpu/utils/device.py): the compile-cache
helper, the GPU requirement, the device peak table and nvidia-smi
parsing."""

import os

import jax
import pytest

from cdlrm_tpu.utils import device


@pytest.fixture
def config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    return calls


def test_compile_cache_honours_env(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert "jax_compilation_cache_dir" not in config_updates


def test_compile_cache_default_is_checkout_path(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = device.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(root, ".jax_cache") == device.DEFAULT_CACHE_DIR
    assert config_updates["jax_compilation_cache_dir"] == got


def test_require_gpu_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(device.AcceleratorMissing, match="needs a GPU"):
        device.require_gpu("this check")


@pytest.mark.parametrize("kind,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
])
def test_device_peak_known(kind, gbps):
    assert device.device_peak(kind).hbm_gbps == gbps


@pytest.mark.parametrize("kind", ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB"])
def test_device_peak_unknown_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        device.device_peak(kind)


@pytest.mark.parametrize("line,name,limit", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n", "NVIDIA H100 80GB HBM3", 500.0),
    ("NVIDIA H100 PCIe, 350.00 W", "NVIDIA H100 PCIe", 350.0),
    ("NVIDIA H100 NVL, [N/A]", "NVIDIA H100 NVL", None),
])
def test_parse_nvidia_smi(line, name, limit):
    info = device.parse_nvidia_smi(line)
    assert (info.name, info.power_limit_w) == (name, limit)
    assert info.line == line.strip()


@pytest.mark.parametrize("line", ["", "no comma here", ", 700.00 W",
                                  "NVIDIA H100 PCIe, lots"])
def test_parse_nvidia_smi_rejects(line):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(line)


def test_query_gpus_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(device.shutil, "which", lambda exe: None)
    assert device.query_gpus() == []
