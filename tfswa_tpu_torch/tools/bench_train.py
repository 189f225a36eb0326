"""Train-step throughput at the flagship configuration, as the JAX
package's ``tools/bench_train.py``: steps/s, audio-s/s and MFU of the whole
train step (STFT -> model forward and backward -> clip -> AdamW) in bf16 +
remat.

    python -m tfswa_tpu_torch.tools.bench_train [--batch 4] [--steps 8] [--remat none]
        [--device cuda]

The model is the flagship from ``create_train_state`` (seed 0); the batch is
noise from numpy seed 0 (mixtures, then the targets).  A step's time is the
host clock over ``--steps`` steps after a warm-up step, ending in a
synchronize on the card.  MFU: a step's FLOPs, 3 x those of one plain-route
forward of one segment times the batch (``utils.profiling.flops_of`` sees
PyTorch's operators, not the kernels: the trainer's count), over the step
time and ``utils.profiling.PEAK_FLOPS`` of the card (None on a card that
has no entry).  The last line is a JSON object of the numbers, with the
kernel launches a step (66 B1-train + 66 B2 without remat, 132 + 66 with).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from ..config import Config
from ..ops.stft import STFTProcessor
from ..training.train_state import _spectrograms, create_train_state, make_train_step
from ..utils.profiling import PEAK_FLOPS, detect_chip, flops_of
from . import _common
from .bench_train_ablate import STEMS, make_batch


def step_flops(model, proc: STFTProcessor, mixtures: torch.Tensor,
               freq_policy: str = "full") -> Optional[float]:
    """3 x the FLOPs of one plain-route forward of one segment, times the
    batch (the trainer's count)."""
    plain = model.clone(attention_impl="xla").eval()
    x = _spectrograms(proc, mixtures[:1], {}, freq_policy)[0]
    with torch.no_grad():
        flops = flops_of(plain, x)
    return None if flops is None else 3.0 * flops * mixtures.shape[0]


def throughput(state, step, mixtures, targets, steps: int, seconds: float) -> dict:
    """Step time, rates and the kernel launches a step."""
    before = _common.counts()
    ms = _common.wall_ms(lambda: step(state, mixtures, targets), steps, mixtures.device)
    return {"step_time_ms": ms, "steps_per_sec": 1e3 / ms,
            "audio_sec_per_sec": mixtures.shape[0] * seconds / (ms / 1e3),
            "launches": _common.launches_per_call(before, steps + 1)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--remat", default="tfswa_block", choices=["none", "tfswa_block"])
    ap.add_argument("--attention_impl", default="pallas", choices=["pallas", "xla"])
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "bench_train")
    if device is None:
        return 2
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    cfg.model.remat = args.remat != "none"
    cfg.model.attention_impl = args.attention_impl
    cfg.data.segment_seconds = args.seconds
    cfg.train.use_mrstft = False
    proc = STFTProcessor(cfg.stft)
    model, state = create_train_state(cfg, steps_per_epoch=1000, device=str(device))
    step = make_train_step(model, proc, stems=STEMS)
    mixtures, targets = make_batch(args.batch, int(args.seconds * cfg.stft.sample_rate), device)
    res = throughput(state, step, mixtures, targets, args.steps, args.seconds)
    flops = step_flops(model, proc, mixtures)
    peak = PEAK_FLOPS.get(detect_chip())
    res["mfu"] = flops / (res["step_time_ms"] / 1e3) / peak if flops and peak else None
    print(json.dumps({"metric": "train_step",
                      "config": f"B={args.batch} {args.seconds}s bf16 remat={args.remat} "
                                f"attn={args.attention_impl}",
                      **res, "flops_per_step": flops, "device": _common.device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
