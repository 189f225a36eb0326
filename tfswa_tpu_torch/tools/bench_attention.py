"""Microbenchmark of the row attention, as the JAX package's
``tools/bench_attention.py``: B4 (``flash_row_attention``, "pallas")
against the chunked plain attention ("xla": ``mha_rows`` on 16 rows at a
time, PyTorch's operators), per shape of one 10 s segment of the flagship.

    python -m tfswa_tpu_torch.tools.bench_attention [--dtype bfloat16] [--device cuda]

At each shape the rows, Wqkv and Wo come from numpy seed 0 as in the JAX
tool (N(0, 1) rows, weights N(0, 0.05^2), bias 0).  A call's time is the
median of ``--iters`` calls after a warm-up, by CUDA events on the card;
TF/s counts the qkv and out-projection products and the two attention
products (4 R H N^2 D).  The last line is a JSON object of the numbers,
with B4's launches a timed call.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..models.attention import mha_rows
from ..ops.row_attention import flash_row_attention
from . import _common
from .kernel_lab import FAILURES, timeit

SHAPES = [
    ("enc0 TSA", 862, 1025, 32, 8),
    ("enc0 FSA", 1025, 862, 32, 8),
    ("enc0 SWA", 13932, 64, 32, 8),
    ("enc1 TSA", 431, 512, 64, 8),
    ("enc1 SWA", 3456, 64, 64, 8),
    ("enc2 TSA", 216, 256, 128, 8),
    ("bottleneck TSA", 108, 128, 256, 8),
]


def xla_chunked(rows, wq, wp, b, H: int, chunk: int = 16):
    """The plain attention 16 rows at a time (the JAX tool's lax.map)."""
    return torch.cat([mha_rows(rows[i:i + chunk], wq, wp, b, H)
                      for i in range(0, rows.shape[0], chunk)])


IMPLS = {"xla": xla_chunked, "pallas": flash_row_attention}


def shape_inputs(R: int, N: int, C: int, dtype: torch.dtype, device):
    """Rows, Wqkv, Wo and the bias from numpy seed 0 (the JAX tool's order)."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).to(device)

    rows = t(rng.standard_normal((R, N, C)))
    wq = t(rng.standard_normal((C, 3 * C)) * 0.05)
    wp = t(rng.standard_normal((C, C)) * 0.05)
    return rows, wq, wp, t(np.zeros(C))


def flops(R: int, N: int, C: int, H: int) -> float:
    return 2 * R * N * (3 * C * C + C * C) + 4 * R * H * N * N * (C // H)


def bench_shape(label, R, N, C, H, impls, iters: int, dtype, device) -> dict:
    args = shape_inputs(R, N, C, dtype, device)
    cuda = torch.device(device).type == "cuda"
    res = {"shape": label, "R": R, "N": N, "C": C, "flops": flops(R, N, C, H)}
    with torch.no_grad():
        for name in impls:
            before = _common.counts()
            try:
                ms = timeit(lambda: IMPLS[name](*args, H), iters, cuda)
            except FAILURES as exc:
                res[f"{name}_failed"] = str(exc)[:120]
                continue
            res[f"{name}_ms"] = ms
            res[f"{name}_tflops"] = res["flops"] / ms / 1e9
            res.setdefault("launches", {})[name] = _common.launches_per_call(before, iters + 1)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--impls", default="xla,pallas")
    ap.add_argument("--iters", type=int, default=8)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    impls = [v for v in args.impls.split(",") if v]
    unknown = [v for v in impls if v not in IMPLS]
    if unknown:
        ap.error(f"unknown impls {unknown}; known: {sorted(IMPLS)}")
    device = _common.device_or_none(args, "bench_attention")
    if device is None:
        return 2
    dtype = getattr(torch, args.dtype)
    print(f"device: {_common.device_name(device)}, dtype {args.dtype}")
    out, rc = [], 0
    for label, R, N, C, H in SHAPES:
        res = bench_shape(label, R, N, C, H, impls, args.iters, dtype, device)
        line = f"{label:16s} R={R:5d} N={N:4d} C={C:3d}"
        for name in impls:
            line += (f"  {name} {res[name + '_ms']:8.2f} ms ({res[name + '_tflops']:5.1f} TF/s)"
                     if name + "_ms" in res else f"  {name} FAILED: {res[name + '_failed']}")
            rc = rc or int(name + "_failed" in res)
        print(line, flush=True)
        out.append(res)
    print(json.dumps({"device": _common.device_name(device), "dtype": args.dtype,
                      "shapes": out}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
