"""Gradient checkpointing (rematerialisation) helpers (counterpart of
``tfswa_tpu/optimization/remat.py``).

The model applies it itself through ``ModelConfig.remat`` (each TFSWABlock
under ``torch.utils.checkpoint``, ``models/tfswa_unet.py``); this module
holds the config object, ``checkpoint_fn`` / ``checkpoint_sequential``,
the activation-memory estimate and the device memory counters.  ``torch.utils.checkpoint`` saves nothing of the
function's inside, which is the JAX package's policy ``"none"``; its save
policies (``"dots"``, ...) have no torch counterpart and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from torch.utils.checkpoint import checkpoint

from ..utils.profiling import device_memory_report


def checkpoint_fn(fn: Callable, policy: str = "none") -> Callable:
    """``fn`` recomputed in the backward instead of keeping its inside."""
    if policy != "none":
        raise NotImplementedError(
            f"remat policy {policy!r} has no torch counterpart; only 'none' is ported")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def checkpoint_sequential(fns: Sequence[Callable], segments: int = 2) -> Callable:
    """A chain of functions in ``segments`` segments, each recomputed in the
    backward instead of keeping its inside (the JAX function)."""
    fns = list(fns)
    seg_size = max(1, (len(fns) + segments - 1) // segments)

    def run(fs, x):
        for f in fs:
            x = f(x)
        return x

    segs = [fns[i:i + seg_size] for i in range(0, len(fns), seg_size)]

    def forward(x):
        for fs in segs:
            x = checkpoint(run, fs, x, use_reentrant=False)
        return x

    return forward


@dataclasses.dataclass
class CheckpointConfig:
    """Config-object API: ``apply`` returns a copy of a ModelConfig with
    remat set to ``enabled``."""

    enabled: bool = True
    policy: str = "none"

    def apply(self, model_config):
        if self.policy != "none":
            raise NotImplementedError(
                f"remat policy {self.policy!r} has no torch counterpart; only 'none' is ported")
        return dataclasses.replace(model_config, remat=self.enabled)


def estimate_activation_memory(batch: int, freq_bins: int, time_frames: int,
                               dims: Sequence[int], depths: Sequence[int],
                               bytes_per_el: int = 4) -> dict:
    """The JAX package's analytic estimate of the blocks' activation memory,
    with and without remat: about 6 activations of (B, H, W, C) a block,
    and with remat one a block (a sixth)."""
    per_stage = []
    h, w = freq_bins, time_frames
    for level, (d, c) in enumerate(zip(depths, dims)):
        per_stage.append(d * 6 * batch * h * w * c)
        if level < len(dims) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
    total = sum(per_stage) * bytes_per_el
    with_remat = total / 6.0
    return {"no_remat_gb": total / 1e9, "with_remat_gb": with_remat / 1e9,
            "savings_gb": (total - with_remat) / 1e9,
            "savings_pct": 100.0 * (1 - with_remat / max(total, 1))}


def get_memory_stats() -> dict:
    """Live memory of each CUDA device, GB, under the JAX function's keys;
    empty without one."""
    return {dev: {"bytes_in_use_gb": r["in_use_gb"], "peak_bytes_in_use_gb": r["peak_gb"],
                  "bytes_limit_gb": r["limit_gb"]}
            for dev, r in device_memory_report().items()}
