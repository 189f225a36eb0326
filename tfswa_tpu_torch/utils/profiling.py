"""Step timing and device memory for the training loop (counterpart of
``StepTimer`` and ``device_memory_report`` in
``tfswa_tpu/utils/profiling.py``).  The trace and annotation helpers are
not ported yet."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch


class StepTimer:
    """Host-clock time between consecutive :meth:`tick` calls.  In a
    device-bound loop the host is held back by the device's queue, so the
    interval is the step's time.  :meth:`restart` forgets the last tick, so
    that a pause (validation, checkpoints) is not counted as a step."""

    def __init__(self, items_per_step: Optional[int] = None):
        self.items_per_step = items_per_step
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
