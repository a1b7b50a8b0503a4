"""Accelerator plumbing shared by the CLI, the benchmarks and the chip smoke:
the persistent compilation cache, the accelerator requirement of every
measurement path, the device peak table and ``nvidia-smi`` parsing.

Nothing here imports jax at module import time; each function imports it
when called, so the tests' CPU forcing (tests/conftest.py) stays first.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import NamedTuple, Optional

# the checkout root: cdlrm_tpu/utils/device.py -> ../../
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands: JAX
    reads it itself and no other directory is set here. Otherwise the cache
    lives at the fixed path ``<checkout>/.jax_cache`` (gitignored): the path
    is part of the cache key, so a directory that moves never hits.
    Idempotent; call it before the first compile."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env_dir or DEFAULT_CACHE_DIR
    if not env_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache every executable: steps recompile per config otherwise
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


class AcceleratorMissing(RuntimeError):
    """A measurement path found no GPU; it never falls back to the CPU."""


def require_gpu(what: str) -> None:
    """Raise unless JAX's default backend is a GPU with at least one
    device."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu" or not jax.devices():
        raise AcceleratorMissing(
            f"{what} needs a GPU; JAX found backend {backend!r}"
        )


class DevicePeak(NamedTuple):
    hbm_gbps: float  # device-memory bandwidth, GB/s (1e9 bytes/s)
    bf16_tflops: float  # dense tensor-core bf16 rate, no sparsity


# Published peaks at the full power limit (NVIDIA H100 / H200 data sheets),
# keyed by ``jax.Device.device_kind``. A kind that is not here is an error:
# a roofline share against a guessed peak is not a measurement.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeak(3350.0, 989.0),  # H100 SXM
    "NVIDIA H100 PCIe": DevicePeak(2000.0, 756.0),
    "NVIDIA H100 NVL": DevicePeak(3900.0, 835.0),
    "NVIDIA H200": DevicePeak(4800.0, 989.0),  # H200 SXM
}


def device_peak(device_kind: str) -> DevicePeak:
    """Peak table lookup; raises KeyError on a device kind it does not
    know."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no peak rates recorded for device kind {device_kind!r}; add "
            "it to cdlrm_tpu/utils/device.py DEVICE_PEAKS with its source"
        ) from None


class GpuInfo(NamedTuple):
    name: str
    power_limit_w: Optional[float]  # None when nvidia-smi reports [N/A]
    line: str  # the raw line, printed as nvidia-smi gave it


def parse_nvidia_smi(line: str) -> GpuInfo:
    """Parse one line of
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    line = line.strip()
    name, sep, power = line.rpartition(",")
    if not sep or not name.strip():
        raise ValueError(f"not a name,power.limit line: {line!r}")
    power = power.strip()
    limit = None
    if power.endswith("W"):
        limit = float(power[:-1].strip())
    elif power not in ("[N/A]", "N/A", "[Not Supported]"):
        raise ValueError(f"unreadable power limit in {line!r}")
    return GpuInfo(name.strip(), limit, line)


def query_gpus() -> list:
    """One :class:`GpuInfo` per card that ``nvidia-smi`` lists; empty when
    the tool is absent."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [parse_nvidia_smi(ln) for ln in out.splitlines() if ln.strip()]
