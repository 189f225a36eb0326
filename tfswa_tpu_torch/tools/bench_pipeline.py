"""Per-component timing of the separation pipeline, as the JAX package's
``tools/bench_pipeline.py``: one batch of segments broken into the STFT,
the model forward, masks + iSTFT, and the copy of the audio to the host.

    python -m tfswa_tpu_torch.tools.bench_pipeline [--batch 4] [--seconds 10] [--device cuda]

The model is the flagship in bf16 through ``--attention`` ("pallas": B1)
with random weights from seed 0; the input is ``--batch`` x 2 x
``--seconds`` of noise at 44.1 kHz from numpy seed 0, n_fft 2048, hop 512.
Each part's time is the host clock over ``--iters`` calls after a warm-up,
ending in a synchronize on the card; the copy is timed alone (``.cpu()``).
The last line is a JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import STFTConfig
from ..ops.masking import trainer_masked_complex
from ..ops.stft import STFTProcessor
from . import _common


def stft_part(proc: STFTProcessor, wav: torch.Tensor) -> torch.Tensor:
    return proc.stft(wav)


def forward_part(model, proc: STFTProcessor, spec: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(proc.to_model_input(spec))


def mask_istft_part(proc: STFTProcessor, out: torch.Tensor, spec: torch.Tensor,
                    length: int) -> torch.Tensor:
    """The trainer-convention masks on the mono mixture, then the iSTFT:
    (B, 2, length) audio."""
    mono = spec.mean(dim=1)
    masked = trainer_masked_complex(out, mono.abs(), mono.angle(), 2)
    return proc.istft(masked, length=length)


def pipeline_times(model, proc: STFTProcessor, wav: torch.Tensor, iters: int) -> dict:
    """ms of each part and the rate of the whole, in audio-s/s."""
    dev = wav.device
    S = wav.shape[-1]
    spec = stft_part(proc, wav)
    out = forward_part(model, proc, spec)
    audio = mask_istft_part(proc, out, spec, S)
    res = {"stft_ms": _common.wall_ms(lambda: stft_part(proc, wav), iters, dev),
           "forward_ms": _common.wall_ms(lambda: forward_part(model, proc, spec), iters, dev),
           "mask_istft_ms": _common.wall_ms(lambda: mask_istft_part(proc, out, spec, S),
                                            iters, dev)}
    _common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        audio.cpu()
    res["d2h_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    res["d2h_mb"] = audio.numel() * audio.element_size() / 1e6
    res["total_ms"] = sum(res[k] for k in ("stft_ms", "forward_ms", "mask_istft_ms", "d2h_ms"))
    res["audio_s_per_s"] = wav.shape[0] * S / proc.sample_rate / (res["total_ms"] / 1e3)
    res["spec_shape"] = list(spec.shape)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--attention", default="pallas")
    ap.add_argument("--iters", type=int, default=4)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "bench_pipeline")
    if device is None:
        return 2
    proc = STFTProcessor(STFTConfig(n_fft=2048, hop_length=512))
    S = int(args.seconds * proc.sample_rate)
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 2, S)).astype(np.float32)).to(device)
    model = _common.flagship(device, attention_impl=args.attention)
    before = _common.counts()
    res = pipeline_times(model, proc, wav, args.iters)
    res["launches"] = _common.launches_per_call(before, args.iters + 2)
    print(f"device: {_common.device_name(device)}, spec shape {tuple(res['spec_shape'])}")
    for k in ("stft", "forward", "mask_istft", "d2h"):
        print(f"{k:10s}: {res[k + '_ms']:8.1f} ms")
    print(f"total     : {res['total_ms']:8.1f} ms -> {res['audio_s_per_s']:.1f} audio-sec/sec")
    print(json.dumps({"device": _common.device_name(device), "batch": args.batch,
                      "seconds": args.seconds, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
