"""Sweep of the device-OLA serving geometry, as the JAX package's
``tools/bench_ola_windows.py``: window size (``ola_bucket_seconds``),
segment length, segment batch, transfer codec and overlap trade the
batch's efficiency, the overlap's redundant compute and the transfers
against each other.

    python -m tfswa_tpu_torch.tools.bench_ola_windows --buckets 60 121
    python -m tfswa_tpu_torch.tools.bench_ola_windows --buckets 30 60 --segment_lengths 6 10 \\
        --dtypes float16 int16 --repeats 2

The model is the flagship in bf16 through "pallas" with random weights from
seed 0, in a ``SourceSeparator`` (trainer masks, stems vocals and other,
``device_ola=True``) at n_fft 2048 / hop 512; the track is ``--track_seconds``
of two sines and noise (numpy seed 0).  Each geometry's rate is the best of
``--repeats`` separations after a warm-up one, host clock around
``separate()`` (which ends with the stems on the host).  The last line is a
JSON object of the sweep and its best geometry.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..config import STFTConfig
from ..evaluation.inference import SourceSeparator
from ..ops.stft import STFTProcessor
from . import _common


def track(seconds: float, sr: int) -> np.ndarray:
    n = int(seconds * sr)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def separator(model, proc, bucket: float, seg_len: float, batch: int, dtype: str,
              overlap: float, freq_policy: str, device) -> SourceSeparator:
    return SourceSeparator(model, proc, segment_length=seg_len, overlap=overlap,
                           mask_mode="trainer", stem_names=("vocals", "other"),
                           segment_batch=batch, transfer_dtype=dtype, device_ola=True,
                           ola_bucket_seconds=bucket, freq_policy=freq_policy, device=device)


def sweep(model, proc, audio: np.ndarray, grid, repeats: int, freq_policy: str,
          device) -> list:
    """One row a geometry (bucket, segment length, batch, dtype, overlap):
    its window's segments K, its best rate in audio-s/s and the kernel
    launches a separation."""
    seconds = audio.shape[-1] / proc.sample_rate
    rows = []
    for bucket, seg_len, bs, dt_name, ov in grid:
        sep = separator(model, proc, bucket, seg_len, bs, dt_name, ov, freq_policy, device)
        before = _common.counts()
        sep.separate(audio)                      # warm-up
        rate = 0.0
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = sep.separate(audio)
            rate = max(rate, seconds / (time.perf_counter() - t0))
        if not all(np.isfinite(v).all() for v in out.values()):
            raise RuntimeError(f"non-finite stems at bucket {bucket}, segment {seg_len}")
        rows.append({"bucket_s": bucket, "segment_s": seg_len, "batch": bs, "dtype": dt_name,
                     "overlap": ov, "K": sep.ola_window_segments, "audio_s_per_s": rate,
                     "launches": _common.launches_per_call(before, repeats + 1)})
        print(f"bucket {bucket:6.1f}s seg {seg_len:4.1f}s ov {ov:.2f} bs {bs:2d} {dt_name:>7}"
              f"  K={sep.ola_window_segments:3d}  {rate:6.2f} audio-sec/sec", flush=True)
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--buckets", type=float, nargs="+", default=[60.0])
    ap.add_argument("--segment_lengths", type=float, nargs="+", default=[10.0])
    ap.add_argument("--batches", type=int, nargs="+", default=[8])
    ap.add_argument("--dtypes", nargs="+", default=["float16"])
    ap.add_argument("--overlaps", type=float, nargs="+", default=[0.25])
    ap.add_argument("--freq_policy", default="full")
    ap.add_argument("--stft_precision", default="highest")
    ap.add_argument("--track_seconds", type=float, default=120.0)
    ap.add_argument("--repeats", type=int, default=1)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "bench_ola_windows")
    if device is None:
        return 2
    model = _common.flagship(device)
    proc = STFTProcessor(STFTConfig(n_fft=2048, hop_length=512, precision=args.stft_precision))
    grid = list(itertools.product(args.buckets, args.segment_lengths, args.batches, args.dtypes,
                                  args.overlaps))
    rows = sweep(model, proc, track(args.track_seconds, proc.sample_rate), grid, args.repeats,
                 args.freq_policy, device)
    best = max(rows, key=lambda r: r["audio_s_per_s"])
    print(f"best: {best['audio_s_per_s']:.2f} as/s at bucket={best['bucket_s']} "
          f"seg={best['segment_s']} bs={best['batch']} dtype={best['dtype']} "
          f"overlap={best['overlap']}")
    print(json.dumps({"device": _common.device_name(device), "sweep": rows, "best": best}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
