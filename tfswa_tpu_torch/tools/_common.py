"""What the measuring tools share (the counterparts of the JAX package's
``tools/bench_*.py``, ``forward_ablation.py``, ``geom_probe.py``): the
``--device`` flag and its refusal without a card, the flagship model, timing
that ends in a synchronize on the card, and the kernels' launch counts (a
tool reports its launches per call, so that a run can show that it went
through the kernels)."""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional

import torch

from ..models import TFSWAUNet
from ..ops.fused_block import (fused_row_block, fused_row_block_bwd, fused_row_block_int8,
                               fused_row_block_train)
from ..ops.lab_block import lab_row_block
from ..ops.row_attention import flash_row_attention

# the kernels by their names in PERF.md: (wrapper, counter)
KERNELS = {"B1": fused_row_block, "B1-train": fused_row_block_train, "B2": fused_row_block_bwd,
           "B3": fused_row_block_int8, "B4": flash_row_attention, "L": lab_row_block}


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; with no card the tool stops with exit code 2) "
                         "or cpu (the kernels' plain versions)")


def device_or_none(args, name: str) -> Optional[torch.device]:
    """The tool's device; None (after a message) when the card is asked for
    and there is none: the tool then exits 2, it never falls back."""
    if args.device == "cuda" and not torch.cuda.is_available():
        print(f"{name}: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return None
    return torch.device(args.device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def flagship(device, dtype: torch.dtype = torch.bfloat16, attention_impl: str = "pallas",
             seed: int = 0) -> TFSWAUNet:
    """The flagship model (in/out 4, depths (2, 2, 6, 2), dims (32, 64, 128,
    256), 8 heads) with weights from ``seed``, in eval mode."""
    return TFSWAUNet(4, 4, attention_impl=attention_impl, dtype=dtype,
                     generator=torch.Generator().manual_seed(seed)).to(device).eval()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn: Callable[[], object], iters: int, device, warm: bool = True) -> float:
    """ms a call of ``fn``: host clock around ``iters`` calls that ends in a
    synchronize on the card, after one warm-up call (``warm``)."""
    if warm:
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / max(iters, 1)


def counts() -> Dict[str, int]:
    """Every kernel's launches so far, bf16 and ("<name>-f32") f32."""
    out = {k: w.launches for k, w in KERNELS.items()}
    out.update({f"{k}-f32": w.launches_f32 for k, w in KERNELS.items()})
    return out


def launches_per_call(before: Dict[str, int], calls: int) -> Dict[str, float]:
    """The launches since ``before`` of each kernel that launched, per call."""
    now = counts()
    return {k: (now[k] - before[k]) / calls for k in now if now[k] != before[k]}
