"""int8 serving A/B: the flagship bf16 forward through "pallas" against the
same weights through ``quantize_dynamic(compute="int8")``, then the
quantized model's output against the f32 model's (the JAX package's
``tools/bench_int8.py``).

    python -m tfswa_tpu_torch.tools.bench_int8 [--iters 4] [--seconds 3 10] [--device cuda]

The model is the flagship (in/out 4, depths (2,2,6,2), dims
(32,64,128,256)) with random weights from seed 0, on inputs of batch 2 at
n_fft 2048 / hop 512 / 44.1 kHz, ``--seconds`` long.  It runs on the card
(``--device cuda``, the default; with no card it stops with exit code 2)
or, with ``--device cpu``, on the kernels' plain versions (slow: use small
``--seconds``).  A forward's time is the host clock over ``--iters``
forwards after a warm-up, ending in a synchronize on the card.  The last
line is a JSON object of the numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import TFSWAUNet
from ..optimization.quantization import compare_models, quantize_dynamic


def input_shape(seconds: float):
    """(B=2, 4, freq, frames) at n_fft 2048 / hop 512, 44.1 kHz."""
    return (2, 4, 1025, int(seconds * 44100) // 512 + 1)


def timeit(fn, x: torch.Tensor, iters: int) -> float:
    """Seconds a call of ``fn(x)``, after one warm-up call."""
    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    with torch.no_grad():
        fn(x)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        sync()
    return (time.perf_counter() - t0) / iters


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--seconds", type=float, nargs="+", default=[3.0],
                    help="segment lengths to A/B")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_int8: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    print(f"device: {torch.cuda.get_device_name(0) if device.type == 'cuda' else 'cpu'}")
    rng = np.random.default_rng(0)

    bf16 = TFSWAUNet(4, 4, attention_impl="pallas", dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0)).to(device)
    qmodel, stats = quantize_dynamic(bf16, compute="int8")
    res = {"device": args.device, "compression_ratio": stats["compression_ratio"],
           "seconds": {}}
    for sec in args.seconds:
        x = torch.from_numpy(rng.standard_normal(input_shape(sec)).astype(np.float32)).to(device)
        t16 = timeit(bf16, x, args.iters)
        print(f"[{sec:4.1f} s] bf16 pallas forward  : {t16 * 1e3:8.1f} ms")
        t8 = timeit(qmodel, x, args.iters)
        print(f"[{sec:4.1f} s] int8-compute forward : {t8 * 1e3:8.1f} ms  (speedup "
              f"{t16 / t8:.2f}x, {stats['compression_ratio']:.1f}x smaller)")
        res["seconds"][str(sec)] = {"bf16_ms": t16 * 1e3, "int8_ms": t8 * 1e3}

    f32 = TFSWAUNet(4, 4).to(device)
    f32.load_state_dict(bf16.state_dict())
    diff = compare_models(f32, qmodel, input_shape=(1, 4, 257, 65))
    print(f"int8 output delta vs f32  : mae={diff['mae']:.4g} max={diff['max_abs']:.4g}")
    res["vs_f32"] = diff
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
