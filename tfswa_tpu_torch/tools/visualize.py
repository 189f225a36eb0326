"""ASCII architecture dump + per-module parameter breakdown (the JAX
package's ``tools/visualize.py``).

    python -m tfswa_tpu_torch.tools.visualize [--depths 2,2,6,2] [--dims 32,64,128,256] \\
        [--device cuda]

The architecture lines are the JAX tool's for the same arguments.  The
table has one row per top-level module of the JAX model's parameters,
named by the port's module (``weights.top_modules`` holds the map), in the
model's order, then the total and its fp32, bf16 and int8 sizes.  The
model is built on ``--device`` ("cuda" unless "cpu" is asked for; with no
card it stops with exit code 2).
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from ..models import TFSWAUNet
from ..weights import top_modules


def architecture_lines(depths: Sequence[int], dims: Sequence[int], in_channels: int,
                       out_channels: int, height: int, width: int) -> List[str]:
    """The diagram below the header, line by line."""
    def blocks(n: int) -> str:
        return " -> ".join(f"TFSWA({'W' if i % 2 == 0 else 'SW'})" for i in range(n))

    lines = [f"input  (B, {in_channels}, {height}, {width})",
             f"  stem Conv7x7 -> BN -> GELU           [{dims[0]:4d} ch]"]
    h, w = height, width
    for s in range(3):
        lines.append(f"  enc{s}  {blocks(depths[s]):42s} [{dims[s]:4d} ch, {h}x{w}]  --skip-->")
        h, w = (h + 2 - 4) // 2 + 1, (w + 2 - 4) // 2 + 1
        lines.append(f"  down{s} Conv4x4/2 -> BN -> GELU         [{dims[s+1]:4d} ch, {h}x{w}]")
    lines.append(f"  bottleneck {blocks(depths[3]):38s} [{dims[3]:4d} ch, {h}x{w}]")
    for d, s in enumerate(range(2, -1, -1)):
        h, w = h * 2, w * 2
        lines.append(f"  up{d}   ConvT4x4/2 -> BN -> GELU        [{dims[s]:4d} ch, ~{h}x{w}] "
                     "<--skip--")
        lines.append(f"  dec{d}  {blocks(depths[s]):42s} [{dims[s]:4d} ch]")
    lines.append("  head Conv3x3 -> BN -> GELU -> Conv1x1 -> sigmoid")
    lines.append(f"output (B, {out_channels}, {height}, {width})  masks in [0, 1]")
    return lines


def parameter_table(model: TFSWAUNet) -> Tuple[List[Tuple[str, int]], int]:
    """([(port module, parameter count)] for each JAX top-level module, the
    total parameter count)."""
    params = dict(model.named_parameters())
    rows = [(name, sum(p.numel() for k, p in params.items() if k.startswith(name + ".")))
            for name in top_modules(model.depths)]
    return rows, sum(p.numel() for p in params.values())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", default="2,2,6,2")
    ap.add_argument("--dims", default="32,64,128,256")
    ap.add_argument("--in_channels", type=int, default=2)
    ap.add_argument("--out_channels", type=int, default=2)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("visualize: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 2

    depths = tuple(int(x) for x in args.depths.split(","))
    dims = tuple(int(x) for x in args.dims.split(","))
    model = TFSWAUNet(args.in_channels, args.out_channels, depths=depths, dims=dims,
                      generator=torch.Generator().manual_seed(0)).to(args.device)
    rows, total = parameter_table(model)
    width = max(24, *(len(name) for name, _ in rows))    # the port's names run longer
    print("=" * 64)
    print("TFSWA-UNet (tfswa_tpu_torch)")
    print("=" * 64)
    for line in architecture_lines(depths, dims, args.in_channels, args.out_channels,
                                   args.height, args.width):
        print(line)
    print("-" * 64)
    print(f"{'module':{width}s} {'params':>12s} {'share':>7s}")
    for name, c in rows:
        print(f"{name:{width}s} {c:12,d} {100*c/total:6.2f}%")
    print("-" * 64)
    print(f"{'TOTAL':{width}s} {total:12,d}")
    print(f"fp32 {total*4/1e6:.2f} MB | bf16 {total*2/1e6:.2f} MB | int8 {total/1e6:.2f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
