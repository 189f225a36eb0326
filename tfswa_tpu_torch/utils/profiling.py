"""Profiling and step timing (counterpart of ``tfswa_tpu/utils/profiling.py``).

  - :func:`trace`: ``torch.profiler`` around a region (CPU, and CUDA when
    there is a card), written as a Chrome trace into a directory;
  - :func:`annotate`: a named region in that trace
    (``torch.profiler.record_function``) and, on the card, an NVTX range;
  - :func:`detect_chip`, :data:`PEAK_FLOPS`, :func:`flops_of` (FLOPs of
    one call, counted by ``torch.utils.flop_counter``: the matrix products
    and convolutions of PyTorch's operators; the hand-written kernels,
    called through ctypes, are not seen);
  - :class:`StepTimer` (step time, rates, MFU against the chip's peak) and
    :func:`device_memory_report`.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# Peak dense bf16 compute a device, FLOP/s (public figures: NVIDIA's data
# sheet for the H100 SXM at 700 W; the JAX package's nominal CPU figure)
PEAK_FLOPS = {
    "h100": 989e12,
    "cpu": 1e11,
}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed region (CPU activity, and CUDA activity when a
    card is there) and write it as a Chrome trace,
    ``log_dir/trace_<pid>_<ns>.json``.  Yields the profiler, whose
    ``events()`` hold the region's operators and annotations."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_"
                                                   f"{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in profiler timelines (and an NVTX range on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def detect_chip() -> str:
    """"h100" on an H100, "cpu" without a card, "gpu" on another card
    (which has no entry in PEAK_FLOPS)."""
    if not torch.cuda.is_available():
        return "cpu"
    return "h100" if "H100" in torch.cuda.get_device_name(0) else "gpu"


def flops_of(fn, *args) -> Optional[float]:
    """The FLOPs of one call ``fn(*args)`` (run once, under
    ``FlopCounterMode``), or None when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return float(counter.get_total_flops()) or None


class StepTimer:
    """Host-clock time between consecutive :meth:`tick` calls.  In a
    device-bound loop the host is held back by the device's queue, so the
    interval is the step's time.  :meth:`restart` forgets the last tick, so
    that a pause (validation, checkpoints) is not counted as a step.  With
    ``flops_per_step`` (one process's, which drives one card), :meth:`metrics`
    gives the MFU against one card's peak (PEAK_FLOPS; none on a card
    without an entry)."""

    def __init__(self, flops_per_step: Optional[float] = None,
                 items_per_step: Optional[int] = None):
        self.flops_per_step = flops_per_step
        self.items_per_step = items_per_step
        self.peak = PEAK_FLOPS.get(detect_chip())
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def restart(self) -> None:
        self._last = None

    def metrics(self, window: int = 50) -> Dict[str, float]:
        """Mean step time over the last ``window`` intervals, and rates."""
        if not self._times:
            return {}
        step_time = float(np.mean(self._times[-window:]))
        out = {"step_time_s": step_time, "steps_per_sec": 1.0 / step_time}
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / step_time
        if self.flops_per_step and self.peak:
            out["mfu"] = self.flops_per_step / step_time / self.peak
        return out


def device_memory_report() -> Dict[str, Dict[str, float]]:
    """Per CUDA device, GB: allocated now (``in_use_gb``), the most
    allocated since the last reset (``peak_gb``), reserved by the caching
    allocator (``reserved_gb``) and the card's memory (``limit_gb``).
    Empty without a CUDA device."""
    report = {}
    if not torch.cuda.is_available():
        return report
    for i in range(torch.cuda.device_count()):
        report[f"cuda:{i}"] = {
            "in_use_gb": torch.cuda.memory_allocated(i) / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated(i) / 1e9,
            "reserved_gb": torch.cuda.memory_reserved(i) / 1e9,
            "limit_gb": torch.cuda.get_device_properties(i).total_memory / 1e9,
        }
    return report
