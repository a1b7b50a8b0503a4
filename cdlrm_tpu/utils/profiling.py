"""Tracing / profiling utilities.

The reference parses --enable-profiling and --plot-compute-graph but never
uses them (/root/reference/main_no_ddp.py:106-107, SURVEY.md §5); its only
timing is cuda-synchronized wall clock (time_wrap, main_no_ddp.py:224-226).
Here:
- device_time(): block_until_ready-fenced wall clock (the JAX equivalent of
  torch.cuda.synchronize + time.time()).
- profile_trace(): context manager around jax.profiler for real XLA traces
  viewable in TensorBoard/Perfetto — implementing the flag the reference
  only parses.
- StepTimer: windowed ms/it accounting matching the reference's printout
  (main_no_ddp.py:458-473).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax


def device_time(*arrays) -> float:
    """Wall clock after all given device arrays are ready."""
    if arrays:
        jax.block_until_ready(arrays)
    return time.time()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """jax.profiler trace scope; no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def ms_per_iter(self) -> float:
        dt = time.perf_counter() - self._t0
        return 1000.0 * dt / max(1, self.steps)
