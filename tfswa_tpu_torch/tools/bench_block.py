"""Microbenchmark of the row block, as the JAX package's
``tools/bench_block.py``: B1 (``fused_row_block``, "fused") against the
attention-only kernel route ("pallas_attn": B4 in the block, the LNs and
the MLP in PyTorch) and the plain block ("xla": ``row_transformer_block``'s
plain route, PyTorch's operators), per shape.

    python -m tfswa_tpu_torch.tools.bench_block [--dtype bfloat16] [--check] [--device cuda]

At each shape of ``SHAPES`` the rows and then the parameters come from
numpy seed 0 as in the JAX tool (``make_params``: kernels N(0, 0.05^2),
LN scales 1, biases 0).  ``--check`` prints B1's largest difference from
the plain block.  A call's time is the median of ``--iters`` calls after a
warm-up, by CUDA events on the card.  The last line is a JSON object of the
numbers, with each route's kernel launches a timed call (one B1 or one B4).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from ..models.attention import RowBlockParams, row_transformer_block
from ..ops.fused_block import fused_row_block
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
IMPLS = {
    "fused": lambda r, p, H: fused_row_block(r, p, H),
    "pallas_attn": lambda r, p, H: row_transformer_block(r, p, H, attention_impl="pallas_attn"),
    "xla": lambda r, p, H: row_transformer_block(r, p, H, attention_impl="xla"),
}


def make_params(C: int, rng: np.random.Generator, dtype: torch.dtype,
                device="cpu") -> RowBlockParams:
    """The JAX tool's parameters from a numpy generator."""
    hid = 4 * C

    def r(*s, scale=0.05):
        return torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(
            dtype).to(device)

    def const(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    return RowBlockParams(
        norm1_scale=const(C, 1.0), norm1_bias=const(C, 0.0), qkv_kernel=r(C, 3 * C),
        proj_kernel=r(C, C), proj_bias=const(C, 0.0), norm2_scale=const(C, 1.0),
        norm2_bias=const(C, 0.0), fc1_kernel=r(C, hid), fc1_bias=const(hid, 0.0),
        fc2_kernel=r(hid, C), fc2_bias=const(C, 0.0))


def shape_inputs(R: int, N: int, C: int, dtype: torch.dtype, device):
    """Rows, then parameters, from numpy seed 0 (the JAX tool's order)."""
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.standard_normal((R, N, C)).astype(np.float32))
    return rows.to(dtype).to(device), make_params(C, rng, dtype, device)


def check_error(rows, p, H: int):
    """B1's largest difference from the plain block, and relative to the
    plain block's largest magnitude."""
    ref = IMPLS["xla"](rows, p, H).float()
    got = IMPLS["fused"](rows, p, H).float()
    err = (ref - got).abs().max().item()
    return err, err / (ref.abs().max().item() or 1.0)


def bench_shape(label, R, N, C, H, impls, iters: int, check: bool, dtype, device) -> dict:
    rows, p = shape_inputs(R, N, C, dtype, device)
    cuda = torch.device(device).type == "cuda"
    res = {"shape": label, "R": R, "N": N, "C": C}
    with torch.no_grad():
        if check:
            res["max_abs_err"], res["rel_err"] = check_error(rows, p, H)
        for name in impls:
            before = _common.counts()
            try:
                res[f"{name}_ms"] = timeit(lambda: IMPLS[name](rows, p, H), iters, cuda)
            except FAILURES as exc:
                res[f"{name}_failed"] = str(exc)[:150]
                continue
            res.setdefault("launches", {})[name] = _common.launches_per_call(before, iters + 1)
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--impls", default="fused,pallas_attn,xla")
    ap.add_argument("--iters", type=int, default=8)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    impls = [v for v in args.impls.split(",") if v]
    unknown = [v for v in impls if v not in IMPLS]
    if unknown:
        ap.error(f"unknown impls {unknown}; known: {sorted(IMPLS)}")
    device = _common.device_or_none(args, "bench_block")
    if device is None:
        return 2
    dtype = getattr(torch, args.dtype)
    print(f"device: {_common.device_name(device)}, dtype {args.dtype}")
    out, rc = [], 0
    for label, R, N, C, H in SHAPES:
        res = bench_shape(label, R, N, C, H, impls, args.iters, args.check, dtype, device)
        line = f"{label:16s} R={R:5d} N={N:4d} C={C:3d}"
        if args.check:
            line += f"  max_abs_err {res['max_abs_err']:.3e} (rel {res['rel_err']:.3e})"
        for name in impls:
            line += (f"  {name} {res[name + '_ms']:8.2f} ms" if name + "_ms" in res
                     else f"  {name} FAILED: {res[name + '_failed']}")
            rc = rc or int(name + "_failed" in res)
        print(line, flush=True)
        out.append(res)
    print(json.dumps({"device": _common.device_name(device), "dtype": args.dtype,
                      "shapes": out}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
