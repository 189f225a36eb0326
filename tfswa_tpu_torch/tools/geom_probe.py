"""Serving geometry probe, as the JAX package's ``tools/geom_probe.py``:
B1 (``fused_row_block``) timed at every stage shape of one segment for two
geometries, the full spectrogram of a 10 s segment (F = 1025, T = 862)
and the Nyquist-cropped one of an 8.905 s segment (F = 1024, T = 768),
weighted by the blocks a shape has in a forward (depths (2, 2, 6, 2) and
the mirrored decoder), as ms of row blocks per second of audio.

    python -m tfswa_tpu_torch.tools.geom_probe [--iters 8] [--device cuda]

Rows from ``torch.randn`` and the kernel lab's parameters
(``kernel_lab.make_params``) from generator seed 0 at each shape, bf16, 8
heads; a call's time is the median of ``--iters`` calls after a warm-up,
by CUDA events on the card.  The effective audio of a segment is 0.75 of
its length (the serving overlap of 0.25).  The last line is a JSON object
of the numbers, with B1's launches a timed call.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from ..ops.fused_block import fused_row_block
from . import _common
from .kernel_lab import make_params, timeit

GEOMETRIES = [
    ("current 10.0s/full  (F=1025, T=862)", 1025, 862, 10.0 * 0.75),
    ("aligned 8.905s/crop (F=1024, T=768)", 1024, 768, (767 * 512 / 44100) * 0.75),
]


def stage_shapes(F: int, T: int, B: int = 1):
    """(label, R, N, C, n_blocks) for every TFSWA stage at spectrogram (F,
    T); n_blocks counts the encoder's and the mirrored decoder's visits."""
    def swa_windows(f, t):
        return (((f + 7) // 8 * 8) // 8) * (((t + 7) // 8 * 8) // 8) * B

    shapes = []
    f, t = F, T
    for i, (C, nb) in enumerate(zip((32, 64, 128, 256), (4, 4, 12, 2))):
        shapes.append((f"s{i} tsa", B * f, t, C, nb))
        shapes.append((f"s{i} fsa", B * t, f, C, nb))
        shapes.append((f"s{i} swa", swa_windows(f, t), 64, C, nb))
        f, t = (f + 2 - 4) // 2 + 1, (t + 2 - 4) // 2 + 1   # conv k4 s2 p1
    return shapes


def probe(geometry, iters: int, device, dtype=torch.bfloat16, heads: int = 8) -> dict:
    """ms of B1 at each stage shape of one geometry, and their weighted
    total a segment and a second of effective audio."""
    label, F, T, eff_audio = geometry
    rows_out, total = [], 0.0
    cuda = torch.device(device).type == "cuda"
    with torch.no_grad():
        for name, R, N, C, nb in stage_shapes(F, T):
            gen = torch.Generator().manual_seed(0)
            rows = torch.randn(R, N, C, generator=gen).to(dtype).to(device)
            p = make_params(C, gen, dtype, str(device))
            ms = timeit(lambda: fused_row_block(rows, p, heads), iters, cuda)
            rows_out.append({"shape": name, "R": R, "N": N, "C": C, "blocks": nb, "ms": ms})
            print(f"  {name:8s} R={R:6d} N={N:4d} C={C:3d} x{nb:2d}: {ms:8.2f} ms", flush=True)
            total += ms * nb
            del rows
    return {"geometry": label, "F": F, "T": T, "effective_audio_s": eff_audio,
            "shapes": rows_out, "total_ms": total, "ms_per_audio_s": total / eff_audio}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "geom_probe")
    if device is None:
        return 2
    print(f"device: {_common.device_name(device)}")
    out = []
    before = _common.counts()
    for geometry in GEOMETRIES:
        print(f"\n=== {geometry[0]}: effective audio/segment {geometry[3]:.3f}s")
        res = probe(geometry, args.iters, device)
        print(f"  TOTAL attention: {res['total_ms']:9.1f} ms/segment => "
              f"{res['ms_per_audio_s']:8.2f} ms per audio-sec")
        out.append(res)
    calls = sum(len(r["shapes"]) for r in out) * (args.iters + 1)
    print(json.dumps({"device": _common.device_name(device), "geometries": out,
                      "launches": _common.launches_per_call(before, calls)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
