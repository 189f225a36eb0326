"""Split the flagship forward's cost: the row blocks (attention) against
everything else (convs, BatchNorm, down/upsampling, fusion), as the JAX
package's ``tools/forward_ablation.py``.

The "identity" arm patches ``models.attention.row_transformer_block`` to
return its rows unchanged: shape-preserving, so the rest of the network
runs as it is.

    python -m tfswa_tpu_torch.tools.forward_ablation [--batch 8] [--seconds 10] [--device cuda]

The model is the flagship in bf16 through "pallas" (B1 in every row block)
with random weights from seed 0, on inputs of ``--batch`` x 4 x 1025 x T
(T the frames of ``--seconds`` at hop 512, 44.1 kHz) from numpy seed 0.  A
forward's time is the host clock over ``--iters`` forwards after a warm-up,
ending in a synchronize on the card.  The last line is a JSON object of the
numbers, with each arm's kernel launches a forward (66 B1 in the full arm,
none in the identity arm).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..models import attention as attn_mod
from . import _common


@contextlib.contextmanager
def attention_as_identity() -> Iterator[None]:
    """Every row block returns its rows (the JAX tool's patch)."""
    orig = attn_mod.row_transformer_block
    attn_mod.row_transformer_block = lambda rows, p, num_heads, **kw: rows
    try:
        yield
    finally:
        attn_mod.row_transformer_block = orig


def forward(model, x: torch.Tensor) -> torch.Tensor:
    with torch.inference_mode():
        return model(x)


def forward_arms(model, x: torch.Tensor, iters: int) -> dict:
    """ms a forward of the full model and of its identity arm, and each
    arm's kernel launches a forward."""
    res = {}
    for arm in ("full", "identity"):
        with contextlib.ExitStack() as stack:
            if arm == "identity":
                stack.enter_context(attention_as_identity())
            before = _common.counts()
            res[f"{arm}_ms"] = _common.wall_ms(lambda: forward(model, x), iters, x.device)
            res.setdefault("launches", {})[arm] = _common.launches_per_call(before, iters + 1)
    res["attention_ms"] = res["full_ms"] - res["identity_ms"]
    res["attention_share"] = res["attention_ms"] / res["full_ms"]
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=6)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _common.device_or_none(args, "forward_ablation")
    if device is None:
        return 2
    T = int(args.seconds * 44100) // 512 + 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, 4, 1025, T)).astype(np.float32)).to(device)
    model = _common.flagship(device)
    print(f"device: {_common.device_name(device)}, input {tuple(x.shape)}")
    res = forward_arms(model, x, args.iters)
    print(f"full forward    : {res['full_ms']:8.1f} ms")
    print(f"attention as id : {res['identity_ms']:8.1f} ms")
    print(f"=> attention    : {res['attention_ms']:8.1f} ms  ({100 * res['attention_share']:.0f}%)")
    print(f"=> conv/bn/glue : {res['identity_ms']:8.1f} ms  "
          f"({100 * res['identity_ms'] / res['full_ms']:.0f}%)")
    print(json.dumps({"device": _common.device_name(device), "batch": args.batch,
                      "seconds": args.seconds, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
