"""Attribute the train step's time, as the JAX package's
``tools/bench_train_ablate.py``: five variants of the flagship train step
at B = 4 x 6 s (bf16 + remat), each a strict subset of the full step:

  pre     STFT of mixture + targets, mono magnitudes, model input (no model)
  fwd     pre + model forward + mask + loss                   (no grad)
  fwdbwd  fwd + the backward                                  (no optimizer)
  opt     clip + AdamW update alone, on the gradients fwdbwd left
  full    make_train_step

Differences attribute the time: STFT glue = pre, backward = fwdbwd - fwd,
optimizer and dispatch = full - fwdbwd.

    python -m tfswa_tpu_torch.tools.bench_train_ablate [--batch 4] [--seconds 6] [--device cuda]

The model is the flagship from ``create_train_state`` (seed 0) in bf16
through "pallas" (B1-train + B2 in a step with grad; B1 in "fwd"), remat
unless ``--no-remat``; the batch is noise from numpy seed 0.  Each
variant's time is the host clock over ``--iters`` calls after a warm-up,
ending in a synchronize on the card.  ``--chunk-sweep`` times "fwdbwd" at
each plain-route score-plane budget (``ops.fused_block.MAX_SCORE_BYTES``,
the counterpart of the JAX package's ``TFSWA_CHUNK_MB``; on "pallas" only
the plain-route chunks move).  The last line is a JSON object of the
numbers, with each variant's kernel launches a call.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..ops import fused_block
from ..ops.masking import apply_trainer_masks
from ..ops.stft import STFTProcessor
from ..training.losses import source_separation_loss
from ..training.train_state import _spectrograms, create_train_state, make_train_step
from . import _common

STEMS = ("vocals", "other")


def make_batch(B: int, S: int, device, seed: int = 0):
    """Mixtures (B, 2, S) and targets {stem: (B, 2, S)} of noise from a
    numpy seed, drawn in the JAX tool's order."""
    gen = np.random.default_rng(seed)

    def draw():
        return torch.from_numpy(gen.standard_normal((B, 2, S)).astype(np.float32)).to(device)

    mixtures = draw()
    return mixtures, {k: draw() for k in STEMS}


def loss_value(model, proc: STFTProcessor, mixtures, targets, freq_policy: str = "full"):
    """The JAX tool's loss: the model in train mode, the trainer-convention
    masks on the mono mixture magnitude, the L1 loss of the stems."""
    model.train()
    model_input, mono, target_mags = _spectrograms(proc, mixtures, targets, freq_policy)
    pred = apply_trainer_masks(model(model_input), mono.abs(), len(STEMS))
    pred_mags = {k: pred[:, i] for i, k in enumerate(STEMS)}
    return source_separation_loss(pred_mags, target_mags, use_mrstft=False)["total_loss"]


def variants(state, proc: STFTProcessor, mixtures, targets, freq_policy: str = "full"):
    """The five variants, each a call with no arguments."""
    model = state.model
    step = make_train_step(model, proc, stems=STEMS, freq_policy=freq_policy)

    def fwd():
        with torch.no_grad():
            return loss_value(model, proc, mixtures, targets, freq_policy)

    def fwdbwd():
        state.tx.zero_grad()
        loss = loss_value(model, proc, mixtures, targets, freq_policy)
        loss.backward()
        return loss

    return {"pre": lambda: _spectrograms(proc, mixtures, targets, freq_policy),
            "fwd": fwd, "fwdbwd": fwdbwd, "opt": state.tx.step,
            "full": lambda: step(state, mixtures, targets)}


def ablate(state, proc, mixtures, targets, iters: int, freq_policy: str = "full") -> Dict:
    """ms a call of each variant (in order: opt takes fwdbwd's gradients)
    and each one's kernel launches a call."""
    res, launches = {}, {}
    for name, fn in variants(state, proc, mixtures, targets, freq_policy).items():
        before = _common.counts()
        res[f"{name}_ms"] = _common.wall_ms(fn, iters, mixtures.device)
        launches[name] = _common.launches_per_call(before, iters + 1)
        print(f"{name:7s} {res[name + '_ms']:8.1f} ms", flush=True)
    res["backward_ms"] = res["fwdbwd_ms"] - res["fwd_ms"]
    res["residual_ms"] = res["full_ms"] - res["fwdbwd_ms"]
    res["launches"] = launches
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--chunk-sweep", type=str, default=None,
                    help="comma-separated score-plane budgets in MB: time fwdbwd at each "
                         "and exit")
    ap.add_argument("--no-remat", action="store_true",
                    help="no torch.utils.checkpoint around the TFSWABlocks")
    ap.add_argument("--freq_policy", default="full",
                    help="'crop_pow2' drops the Nyquist row (1025 -> 1024 bins) like "
                         "train.freq_policy")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "bench_train_ablate")
    if device is None:
        return 2
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    cfg.model.remat = not args.no_remat
    cfg.model.attention_impl = "pallas"
    cfg.data.segment_seconds = args.seconds
    cfg.train.use_mrstft = False
    proc = STFTProcessor(cfg.stft)
    S = int(args.seconds * cfg.stft.sample_rate)
    B = args.batch
    _, state = create_train_state(cfg, steps_per_epoch=1000, device=str(device))
    mixtures, targets = make_batch(B, S, device)
    name = _common.device_name(device)
    if args.chunk_sweep:
        sweep, orig = {}, fused_block.MAX_SCORE_BYTES
        fn = variants(state, proc, mixtures, targets, args.freq_policy)["fwdbwd"]
        try:
            for mb in args.chunk_sweep.split(","):
                fused_block.MAX_SCORE_BYTES = int(float(mb) * 2 ** 20)
                sweep[mb] = _common.wall_ms(fn, args.iters, device)
                print(f"fwdbwd @ {mb:>4} MB  {sweep[mb]:8.1f} ms", flush=True)
        finally:
            fused_block.MAX_SCORE_BYTES = orig
        print(json.dumps({"chunk_sweep_fwdbwd_ms": sweep, "device": name}))
        return 0
    res = ablate(state, proc, mixtures, targets, args.iters, args.freq_policy)
    res["device"] = name
    res["config"] = (f"B={B} {args.seconds}s bf16 {'remat' if cfg.model.remat else 'no-remat'} "
                     f"pallas")
    # a full MUSDB18 epoch: 100 train tracks of about 3.5 min, random-offset
    # segments, about 860 steps at batch 4; the reference recipe's 300 epochs
    steps_per_epoch = 860 * 4 // B
    res["musdb_300ep_proj_hours"] = res["full_ms"] / 1e3 * steps_per_epoch * 300 / 3600
    print(f"projected full-MUSDB training (300 epochs, {steps_per_epoch} steps/epoch at "
          f"B={B}): {res['musdb_300ep_proj_hours']:.1f} h on one card")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
