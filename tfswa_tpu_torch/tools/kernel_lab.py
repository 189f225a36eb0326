"""Kernel lab of the fused row block B1 (counterpart of the JAX package's
``tools/kernel_lab.py``): its variants timed, checked against the plain
block, and its stage ablation.

    python -m tfswa_tpu_torch.tools.kernel_lab                  # time variants
    python -m tfswa_tpu_torch.tools.kernel_lab --check          # each vs the plain block
    python -m tfswa_tpu_torch.tools.kernel_lab --ablate         # stage ablation of B1
    python -m tfswa_tpu_torch.tools.kernel_lab --grad           # time the backward
    python -m tfswa_tpu_torch.tools.kernel_lab --variants prod,ptf32 --shapes SWA

It runs on the card (``--device cuda``, the default; with no card it stops)
or, with ``--device cpu``, the plain versions on the CPU.  Times are the
median of ``--iters`` calls after a warm-up call, by CUDA events on the
card.  The last line printed is a JSON object of the kernels' launch counts
(bf16 and f32 apart).  ``--dtype float32`` runs the f32 forms: B1 f32 and
the lab's f32 kernel (``fused_block_lab_forward_f32``).

Variants (``ops/lab_block.py`` holds the lab forms):
  prod      B1, ``fused_row_block`` (under grad: B1-train and B2)
  xla       the plain block (``row_transformer_block(attention_impl="xla")``)
  hpair     B1's function where the TPU kernel pairs heads; keeps its guard
            (2N <= 128 and an even head count)
  nopair, d16, d4, wofold
            B1's function in other TPU tile layouts (head pairing off,
            score depth compacted to 16 or D, out-projection folded over
            sublanes): on the card they run B1's kernels
  exp2bf16, sbf16
            exp2 of the bf16-rounded clamped score (one function)
  ptf32     p left f32 into AV and the denominator
  noclamp   no SCORE_CLAMP (diagnostic: scores past 128 overflow)
Every variant other than prod and xla raises under grad, as in the JAX
package, and ``--grad`` prints FAILED for it.  Any other failure (a
refused input, a failed launch) is printed as FAILED too, and the exit
code is then 1.

``--ablate`` cuts B1 after each stage, qkv -> scores -> exp2 -> av ->
attn -> full, and prints each stage's ms and the difference from the one
before (what that part costs).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

import torch

from ..models.attention import RowBlockParams, row_transformer_block
from ..ops.fused_block import fused_row_block, fused_row_block_bwd, fused_row_block_train
from ..ops.lab_block import STAGES, lab_row_block

SHAPES = [
    ("enc0 TSA", 862, 1025, 32, 8),
    ("enc0 FSA", 1025, 862, 32, 8),
    ("enc0 SWA", 13932, 64, 32, 8),
    ("enc1 TSA", 431, 512, 64, 8),
    ("enc1 SWA", 3456, 64, 64, 8),
    ("enc2 TSA", 216, 256, 128, 8),
    ("enc2 SWA", 1024, 64, 128, 8),
    ("bottleneck TSA", 108, 128, 256, 8),
    ("bottleneck SWA", 256, 64, 256, 8),
]


def block_hpair(rows, p, num_heads):
    """B1's function at the shapes where the TPU kernel pairs heads."""
    if 2 * rows.shape[1] > 128 or num_heads % 2:
        raise ValueError("hpair targets 2N <= 128 with even heads")
    return lab_row_block(rows, p, num_heads)


def _b1_layout(rows, p, num_heads):
    """B1's function (a TPU tile layout of it in the JAX package)."""
    return lab_row_block(rows, p, num_heads)


VARIANTS = {
    "prod": lambda r, p, H: fused_row_block(r, p, H),
    "xla": lambda r, p, H: row_transformer_block(r, p, H, attention_impl="xla"),
    "hpair": block_hpair,
    "nopair": _b1_layout,
    "exp2bf16": lambda r, p, H: lab_row_block(r, p, H, score_bf16=True),
    "sbf16": lambda r, p, H: lab_row_block(r, p, H, score_bf16=True),
    "d16": _b1_layout,
    "d4": _b1_layout,
    "wofold": _b1_layout,
    "ptf32": lambda r, p, H: lab_row_block(r, p, H, p_f32=True),
    "noclamp": lambda r, p, H: lab_row_block(r, p, H, clamp=False),
}
# what a failing call raises: a refused form, a guard, a failed launch
FAILURES = (RuntimeError, ValueError, TypeError, NotImplementedError)


def refused(exc: Exception) -> bool:
    """Whether a failure is one the JAX tool has too, and no fault: hpair's
    guard, or a lab form asked for a gradient."""
    return (isinstance(exc, ValueError) and "hpair targets" in str(exc)) or \
        (isinstance(exc, RuntimeError) and "no gradient" in str(exc))


def make_params(C: int, gen: torch.Generator, dtype: torch.dtype,
                device: str = "cpu") -> RowBlockParams:
    """The JAX tool's parameters: kernels N(0, 0.05^2) from ``gen`` (qkv,
    proj, fc1, fc2 in that order), LN scales 1, biases 0."""
    hid = 4 * C

    def r(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(device)

    def full(n, v):
        return torch.full((n,), v, dtype=dtype, device=device)

    return RowBlockParams(
        norm1_scale=full(C, 1.0), norm1_bias=full(C, 0.0),
        qkv_kernel=r(C, 3 * C), proj_kernel=r(C, C), proj_bias=full(C, 0.0),
        norm2_scale=full(C, 1.0), norm2_bias=full(C, 0.0),
        fc1_kernel=r(C, hid), fc1_bias=full(hid, 0.0),
        fc2_kernel=r(hid, C), fc2_bias=full(C, 0.0),
    )


def timeit(fn, iters: int, cuda: bool) -> float:
    """ms of one call: a warm-up call, then the median of ``iters`` calls,
    each timed by CUDA events on the card (``cuda``), else by the host clock."""
    fn()
    times = []
    if cuda:
        torch.cuda.synchronize()
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def grad_call(fn, rows, p, num_heads: int):
    """The gradient of sum(fn(rows, p)^2) wrt rows and every parameter (a
    ones cotangent would let the forward's last product fold away)."""
    r = rows.detach().requires_grad_()
    pr = type(p)(*(t.detach().requires_grad_() for t in p))
    loss = fn(r, pr, num_heads).float().square().sum()
    return torch.autograd.grad(loss, [r, *pr])


def check(names: List[str], dtype: torch.dtype, device: str) -> bool:
    """Each variant against the plain block on 8 rows of 64 x 32 (row 0
    x 30), within B1's block limit 0.0625 * max(max|ref| / 4, 1)."""
    gen = torch.Generator().manual_seed(1)
    rows = torch.randn(8, 64, 32, generator=gen)
    rows[0] *= 30.0
    rows = rows.to(dtype).to(device)
    p = make_params(32, gen, dtype, device)
    ok = True
    with torch.no_grad():
        ref = VARIANTS["xla"](rows, p, 8).float()
        den = ref.abs().max().item() or 1.0
        tol = 0.0625 * max(den / 4.0, 1.0)
        for name in names:
            if name == "xla":
                continue
            try:
                got = VARIANTS[name](rows, p, 8).float()
            except FAILURES as exc:
                print(f"  {name:9s}: FAILED: {str(exc)[:80]}")
                ok = False
                continue
            err = (ref - got).abs().max().item()
            fin = bool(torch.isfinite(got).all())
            good = fin and err <= tol
            ok = ok and good
            print(f"  {name:9s}: max_abs_err {err:.3e} (rel {err / den:.3e}) "
                  f"finite={fin} limit {tol:.3e} {'ok' if good else 'MISS'}")
    return ok


def ablate_line(label: str, rows, p, num_heads: int, iters: int, cuda: bool):
    """Each stage's ms and its difference from the stage before; None in
    place of the line when a stage fails."""
    R, N, C = rows.shape
    line = f"{label:15s} R={R:5d} N={N:4d} C={C:3d}"
    prev = None
    with torch.no_grad():
        for stage in STAGES:
            try:
                t = timeit(lambda: lab_row_block(rows, p, num_heads, stage), iters, cuda)
            except FAILURES as exc:
                print(f"{line}  {stage} FAIL({str(exc)[:60]})")
                return None
            line += f"  {stage} {t:8.3f}" + ("" if prev is None else f" ({t - prev:+.3f})")
            prev = t
    return line


def parse_shapes(custom: str):
    shapes = []
    for spec in custom.split(";"):
        label, dims = spec.split(":")
        r, n, c, h = (int(v) for v in dims.split(","))
        shapes.append((label, r, n, c, h))
    return shapes


def launch_counts():
    """The kernels' launch counts, bf16 ("launches") and f32 ("launches_f32")."""
    fns = (lab_row_block, fused_row_block, fused_row_block_train, fused_row_block_bwd)
    return {"launches": {f.__name__: f.launches for f in fns},
            "launches_f32": {f.__name__: f.launches_f32 for f in fns}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--grad", action="store_true",
                    help="time the BACKWARD per shape: autograd of each variant wrt "
                         "(rows, params), summed-square loss")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--shapes", default="", help="run the shapes whose label holds this")
    ap.add_argument("--variants", default="prod,hpair")
    ap.add_argument("--custom", default="",
                    help="shapes 'label:R,N,C,H;label:R,N,C,H', replacing the list")
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)
    names = [v for v in args.variants.split(",") if v]
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("kernel_lab: no CUDA device (--device cpu runs the plain versions)",
              file=sys.stderr)
        return 2
    shapes = parse_shapes(args.custom) if args.custom else SHAPES
    cuda = args.device == "cuda"

    where = torch.cuda.get_device_name(0) if cuda else "cpu"
    print(f"device: {where}, dtype {args.dtype}", flush=True)
    rc = 0
    if args.check:
        rc = 0 if check(names, dtype, args.device) else 1
        print(json.dumps(launch_counts()))
        return rc

    for label, R, N, C, H in shapes:
        if args.shapes and args.shapes not in label:
            continue
        gen = torch.Generator().manual_seed(0)
        rows = torch.randn(R, N, C, generator=gen).to(dtype).to(args.device)
        p = make_params(C, gen, dtype, args.device)
        if args.ablate:
            line = ablate_line(label, rows, p, H, args.iters, cuda)
            if line is None:
                rc = 1
            else:
                print(line, flush=True)
            continue
        line = f"{label:15s} R={R:5d} N={N:4d} C={C:3d}"
        for name in names:
            fn = VARIANTS[name]
            try:
                if args.grad:
                    t = timeit(lambda: grad_call(fn, rows, p, H), args.iters, cuda)
                else:
                    with torch.no_grad():
                        t = timeit(lambda: fn(rows, p, H), args.iters, cuda)
                line += f"  {'grad:' if args.grad else ''}{name} {t:8.3f} ms"
            except FAILURES as exc:
                line += f"  {name} FAILED: {str(exc)[:80]}"
                if not refused(exc):
                    rc = 1
        print(line, flush=True)
    print(json.dumps(launch_counts()))
    return rc


if __name__ == "__main__":
    sys.exit(main())
