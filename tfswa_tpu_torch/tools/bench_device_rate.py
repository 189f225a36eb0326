"""Device-only rate of the separation pipeline, as the JAX package's
``tools/bench_device_rate.py``: device-OLA windows chained on the card
(window k's output feeds a zero-weighted mix into window k + 1's input, so
the card runs them back to back with no host round trip and one
synchronize at the end), against the wall rate of ``separate()`` on a
track of as many windows.

    python -m tfswa_tpu_torch.tools.bench_device_rate [--windows 6] [--repeats 2] [--device cuda]

The model is the flagship in bf16 through "pallas" with random weights from
seed 0, in the headline ``SourceSeparator`` (10 s segments, overlap 0.25,
batches of 8, float16 transfers, ``device_ola=True``, 60 s windows).  The
device-only time of a window is (t_M - t_1) / (M - 1) for chains of M =
``--windows`` and 1 windows (the one h2d copy and the final synchronize
cancel); its rate is the new audio a window adds (K hops) over that time.
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
from ..ops.stft import STFTProcessor
from . import _common
from .bench_ola_windows import separator


def chain_seconds(sep, win: torch.Tensor, m: int) -> float:
    """Host seconds of ``m`` windows chained on the device, one synchronize."""
    K = sep.ola_window_segments
    cur = win
    _common.sync(win.device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(m):
            acc = sep._device_ola_window(cur, K)
            # a pure data dependency: numerically the original input
            cur = (win.float() + 0.0 * acc[0].float()).to(win.dtype)
    _common.sync(win.device)
    return time.perf_counter() - t0


def rates(sep, windows: int, repeats: int, seed: int = 0) -> dict:
    """The device-only rate (best of ``repeats``) and the wall rate of
    ``separate()`` on a track of ``windows`` windows, in audio-s/s."""
    K, seg, hop = sep.ola_window_segments, sep.segment_samples, sep.hop_samples
    W = (K - 1) * hop + seg
    audio_per_window = K * hop / sep.sample_rate
    rng = np.random.default_rng(seed)
    win = sep._put(sep._encode_host(rng.standard_normal(W).astype(np.float32) * 0.3))
    chain_seconds(sep, win, 1)                           # warm-up
    best, runs = 0.0, []
    for _ in range(repeats):
        t1 = chain_seconds(sep, win, 1)
        tm = chain_seconds(sep, win, windows)
        per_win = (tm - t1) / (windows - 1)
        runs.append({"t1_s": t1, f"t{windows}_s": tm, "ms_per_window": per_win * 1e3})
        print(f"t1 {t1:.3f}s  t{windows} {tm:.3f}s  -> {per_win * 1e3:.0f} ms/window = "
              f"{audio_per_window / per_win:.2f} audio-sec/sec device-only", flush=True)
        best = max(best, audio_per_window / per_win)
    n = (windows * K - 1) * hop + seg                    # a track of `windows` windows
    audio = (rng.standard_normal(n) * 0.3).astype(np.float32)
    t0 = time.perf_counter()
    sep.separate(audio)
    wall = n / sep.sample_rate / (time.perf_counter() - t0)
    return {"K": K, "window_samples": W, "audio_s_per_window": audio_per_window,
            "device_only_audio_s_per_s": best, "wall_audio_s_per_s": wall, "runs": runs}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--stft_precision", default="highest")
    ap.add_argument("--freq_policy", default="full")
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    if args.windows < 2:
        ap.error("--windows must be at least 2")
    device = _common.device_or_none(args, "bench_device_rate")
    if device is None:
        return 2
    model = _common.flagship(device)
    proc = STFTProcessor(STFTConfig(n_fft=2048, hop_length=512, precision=args.stft_precision))
    sep = separator(model, proc, 60.0, 10.0, 8, "float16", 0.25, args.freq_policy, device)
    before = _common.counts()
    res = rates(sep, args.windows, args.repeats)
    windows_run = 1 + args.repeats * (1 + args.windows) + args.windows
    res["launches_per_window"] = _common.launches_per_call(before, windows_run)
    print(json.dumps({"metric": "device_only_separation_rate",
                      "device": _common.device_name(device), **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
