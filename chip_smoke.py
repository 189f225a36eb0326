#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tfswa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # the whole run (about a minute on an H100)
    python3 chip_smoke.py --quick   # build + kernel-vs-plain checks only

Phases, each of which fails the run (exit code 1) when it fails:
  1. the card's name and power limit; build of the CUDA sources (nvcc, sm_90a);
  2. the fused row-block kernel against its plain PyTorch version at each
     of the 12 (N, C) of the main path (bf16, a slice of 64 rows, three kinds
     of weights: flat, peaked and clamped softmax), on the block's output
     and on its attention output before the out-projection, with
     kernel / plain / library times and the bound at the full row counts of
     a batch of 8 ten-second segments;
  3. the main path: the flagship model (random weights from a seed, bf16,
     in/out 4, depths (2,2,6,2), dims (32,64,128,256)) in a SourceSeparator
     with the EvalConfig.fast_serving() knobs separates a 120 s synthetic
     track; the kernel's launch count must be 66 per model forward; then
     one more separation under torch.profiler for device time by kernel;
  4. the separated audio of one 10 s segment through the kernel route
     against the plain route (same weights, bf16), as an SNR;
  5. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.
Long results go to chiprun_out/chip_smoke.json.  Without a CUDA device, or
outside a checkout of the repository, the run exits non-zero with no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), dense: bf16 tensor-core rate
# and HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# (stage, attention, N, C, R) of the row block at full width: batch of 8
# ten-second segments at 44.1 kHz, n_fft 2048, hop 512, Nyquist row cropped
# (F = 1024, T = 862), SWA padded to multiples of 8.
SHAPES = [
    (0, "TSA", 1024, 32, 6896), (0, "FSA", 862, 32, 8192), (0, "SWA", 64, 32, 110592),
    (1, "TSA", 512, 64, 3448), (1, "FSA", 431, 64, 4096), (1, "SWA", 64, 64, 27648),
    (2, "TSA", 256, 128, 1720), (2, "FSA", 215, 128, 2048), (2, "SWA", 64, 128, 6912),
    (3, "TSA", 128, 256, 856), (3, "FSA", 107, 256, 1024), (3, "SWA", 64, 256, 1792),
]
# TFSWABlocks per stage in one forward: 2 enc + 2 dec, 2 + 2, 6 + 6, 2
BLOCKS_PER_STAGE = {0: 4, 1: 4, 2: 12, 3: 2}
HEADS = 8
CHECK_ROWS = 64
SNR_MIN_DB = 30.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(R: int, N: int, C: int, hidden: int):
    """Least time for one block call: rows in and out plus weights once, in
    bf16, over the HBM rate; the products and scores/AV (bf16 operands)
    over the bf16 tensor-core peak."""
    nbytes = 2 * (2 * R * N * C + 4 * C * C + 2 * C * hidden + 6 * C + hidden)
    flops = 2 * R * N * (4 * C * C + 2 * C * hidden) + 4 * R * N * N * C
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# The kernel is checked on three kinds of weights at every shape, so that
# the attention's own share of the result is large enough to see a fault:
#   flat:   qkv std 0.05, scores of std ~0.1-1 (log2 units), near-uniform
#           softmax; a padded key that added exp2(0) = 1 shows here;
#   peaked: qkv std 1.44/sqrt(C), scores of std ~3, a few keys dominate;
#   clamp:  peaked, LN1 scale x6, so that scores pass SCORE_CLAMP and the
#           clamp decides the result (without it, inf/inf).
# score std = log2(e) * C * qkv_std^2 for unit-variance LN output.
REGIMES = {"flat": (None, 1.0), "peaked": (1.44, 1.0), "clamp": (1.44, 6.0)}


def random_params(torch, RowBlockParams, C: int, gen, regime: str = "flat"):
    hid = 4 * C
    qkv_c, ln_scale = REGIMES[regime]
    qkv_std = 0.05 if qkv_c is None else qkv_c / C ** 0.5

    def r(*shape, std=0.05):
        return torch.randn(*shape, generator=gen) * std

    p = RowBlockParams(
        norm1_scale=ln_scale * (1.0 + r(C, std=0.1)), norm1_bias=r(C, std=0.1),
        qkv_kernel=r(C, 3 * C, std=qkv_std), proj_kernel=r(C, C), proj_bias=r(C, std=0.01),
        norm2_scale=1.0 + r(C, std=0.1), norm2_bias=r(C, std=0.1),
        fc1_kernel=r(C, hid), fc1_bias=r(hid, std=0.01),
        fc2_kernel=r(hid, C), fc2_bias=r(C, std=0.01))
    return RowBlockParams(*(t.cuda() for t in p))


def max_score(torch, x, p, H: int) -> float:
    """Largest pre-clamp score q.k (log2 units, Wq pre-scaled as the kernel
    does) over the first 4 rows of x."""
    import torch.nn.functional as F

    x = x[:4].float()
    C = x.shape[-1]
    D = C // H
    n1 = F.layer_norm(x, (C,), p.norm1_scale, p.norm1_bias, 1e-5)
    q = (n1 @ p.qkv_kernel[:, :C]) * (D ** -0.5 * 1.4426950408889634)
    k = n1 @ p.qkv_kernel[:, C:2 * C]
    q = q.unflatten(-1, (H, D)).transpose(1, 2)
    k = k.unflatten(-1, (H, D)).transpose(1, 2)
    return (q @ k.transpose(-1, -2)).max().item()


def bf16_ulp(v: float) -> float:
    """One bf16 ULP (8 significant bits) at magnitude v."""
    return 2.0 ** (math.floor(math.log2(max(v, 2.0 ** -100))) - 7)


def library_block(torch, rows, p, H: int):
    """Yardstick only (the port never calls it): the same block from
    PyTorch library calls (F.layer_norm, cuBLAS matmuls,
    F.scaled_dot_product_attention), chunked over rows to bound memory."""
    import torch.nn.functional as F

    R, N, C = rows.shape
    D = C // H
    w = [t.to(rows.dtype) for t in p]
    (n1s, n1b, wqkv, wo, bo, n2s, n2b, w1, b1, w2, b2) = w
    chunk = max(1, (1 << 30) // (H * N * N * 4))
    outs = []
    for r0 in range(0, R, chunk):
        x = rows[r0:r0 + chunk]
        Rc = x.shape[0]
        h = F.layer_norm(x, (C,), n1s, n1b, 1e-5)
        qkv = (h @ wqkv).view(Rc, N, 3, H, D).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        y = x + a.transpose(1, 2).reshape(Rc, N, C) @ wo + bo
        h = F.layer_norm(y, (C,), n2s, n2b, 1e-5)
        outs.append(y + F.gelu(h @ w1 + b1) @ w2 + b2)
    return torch.cat(outs)


def check_shape(torch, N: int, C: int, gen):
    """The kernel against its plain version on CHECK_ROWS rows, for each
    kind of weights in REGIMES.  Two quantities are held:
      out:  the block's output, max abs err <= 0.0625 * max(max|ref| / 4, 1)
            (2 bf16 ULP at magnitude 4, scaled with the output);
      attn: the attention output before the out-projection, max abs err
            <= 4 bf16 ULP at max|ref attn|.  Both sides round q, k, v and p
            to bf16 at the same points; an f32 sum in another order flips a
            rounding now and then, which moves a peaked softmax by up to
            ~2 ULP.
    Returns the per-regime results and the flat regime's parameters."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.fused_block import (SCORE_CLAMP, fused_row_block_parts,
                                                 fused_row_block_reference_parts)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        got, got_attn = fused_row_block_parts(x, p, HEADS)
        torch.cuda.synchronize()
        ref, ref_attn = fused_row_block_reference_parts(x, p, HEADS)
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 0.0625 * max(scale / 4.0, 1.0)
        a_err = (got_attn.float() - ref_attn.float()).abs().max().item()
        a_scale = ref_attn.float().abs().max().item()
        a_tol = 4 * bf16_ulp(a_scale)
        s_max = max_score(torch, x, p, HEADS)
        finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(got_attn.float()).all())
        ok = finite and err <= tol and a_err <= a_tol
        if regime == "clamp" and s_max <= SCORE_CLAMP:
            ok = False   # the slice would not test the clamp
        res[regime] = {"max_abs_err": err, "tol": tol, "max_abs_ref": scale,
                       "attn_max_abs_err": a_err, "attn_tol": a_tol,
                       "attn_max_abs_ref": a_scale, "max_score": s_max, "ok": ok}
    return res, flat


def phase_kernels(torch, quick: bool):
    from tfswa_tpu_torch.ops.fused_block import fused_row_block, fused_row_block_reference

    gen = torch.Generator().manual_seed(1)
    rows_out, misses, max_err = [], [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "bound_bytes_ms": 0.0}
    for stage, attn, N, C, R in SHAPES:
        checks, p = check_shape(torch, N, C, gen)
        entry = {"stage": stage, "attn": attn, "N": N, "C": C, "R_full": R,
                 "checks": checks}
        for regime, c in checks.items():
            log(f"kernel check stage {stage} {attn} N={N} C={C} {regime:6s}: "
                f"out err {c['max_abs_err']:.5f} (tol {c['tol']:.4f}), attn err "
                f"{c['attn_max_abs_err']:.5f} (tol {c['attn_tol']:.4f}), max score "
                f"{c['max_score']:.1f} {'ok' if c['ok'] else 'MISS'}")
            if not c["ok"]:
                misses.append(f"N={N} C={C} {regime}")
            max_err = max(max_err, c["max_abs_err"])
        if not quick:
            xf = torch.randn(R, N, C, generator=gen).cuda().to(torch.bfloat16)
            k_ms = cuda_ms(torch, lambda: fused_row_block(xf, p, HEADS), 3)
            pl_ms = cuda_ms(torch, lambda: fused_row_block_reference(xf, p, HEADS), 1)
            lib_ms = cuda_ms(torch, lambda: library_block(torch, xf, p, HEADS), 3)
            b_ms, b_by = bound_ms(R, N, C, 4 * C)
            calls = BLOCKS_PER_STAGE[stage]
            entry.update(kernel_ms=k_ms, plain_ms=pl_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by, calls_per_forward=calls)
            for k, v in (("ms", k_ms), ("plain_ms", pl_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms)):
                totals[k] += calls * v
            if b_by == "bytes":
                totals["bound_bytes_ms"] += calls * b_ms
            log(f"  full R={R}: kernel_ms {k_ms:.3f} plain_ms {pl_ms:.3f} "
                f"library_ms {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by})")
            del xf
            torch.cuda.empty_cache()
        rows_out.append(entry)
    if misses:
        fail("fused_row_block disagrees with its plain version at " + "; ".join(misses))
    return rows_out, max_err, totals


def make_separator(torch, impl: str):
    from tfswa_tpu_torch.config import EvalConfig, ModelConfig, STFTConfig
    from tfswa_tpu_torch.evaluation import SourceSeparator
    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    cfg = ModelConfig(in_channels=4, out_channels=4, attention_impl=impl,
                      dtype="bfloat16")
    model = TFSWAUNet.from_config(cfg, generator=torch.Generator().manual_seed(0))
    ev = EvalConfig.fast_serving()
    return SourceSeparator(
        model, STFTProcessor(STFTConfig(n_fft=2048, hop_length=512)),
        segment_length=ev.segment_seconds, overlap=ev.overlap,
        mask_mode=ev.mask_mode, segment_batch=ev.segment_batch,
        transfer_dtype=ev.transfer_dtype, device_ola=ev.device_ola,
        ola_bucket_seconds=ev.ola_bucket_seconds, freq_policy=ev.freq_policy,
        device="cuda")


def synthetic_track(np, seconds: float, sr: int):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def phase_main_path(torch, np, gpu: str):
    from tfswa_tpu_torch.ops.fused_block import fused_row_block

    sep = make_separator(torch, "pallas")
    forwards = []
    sep.model.register_forward_pre_hook(lambda m, a: forwards.append(a[0].shape[0]))
    track_s = 120.0
    audio = synthetic_track(np, track_s, sep.sample_rate)

    t0 = time.perf_counter()
    sep.separate(audio)                                  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    fused_row_block.launches = 0
    forwards.clear()
    t0 = time.perf_counter()
    out = sep.separate(audio)                            # the counted run
    runs = [time.perf_counter() - t0]
    launches, n_forwards = fused_row_block.launches, len(forwards)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(2):
        t0 = time.perf_counter()
        out = sep.separate(audio)
        runs.append(time.perf_counter() - t0)

    for name, wav in out.items():
        if wav.shape != (1, audio.size) or not np.isfinite(wav).all():
            fail(f"stem {name}: shape {wav.shape} or non-finite values")
        if not np.abs(wav).max() > 0:
            fail(f"stem {name} is silent")
    log(f"main path: {n_forwards} model forwards of batch {forwards[:n_forwards]}, "
        f"fused_row_block launches {launches}")
    if n_forwards != 2 or launches != 66 * n_forwards:
        fail(f"expected 2 forwards and 132 kernel launches, got {n_forwards} "
             f"and {launches}")
    rate = track_s / min(runs)
    log(f"main path: 120 s track in {[round(r, 4) for r in runs]} s (warm-up "
        f"{warm_s:.3f} s): {rate:.4f} audio-s/s on {gpu}; peak memory "
        f"{peak_gb:.3f} GB")
    return {"launches": launches, "forwards": n_forwards, "runs_s": runs,
            "warmup_s": warm_s, "audio_s_per_s": rate, "peak_mem_gb": peak_gb}, sep


def phase_profile(torch, np, sep):
    """Device time by kernel over one separation of the 120 s track
    (torch.profiler, CUDA activity), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    audio = synthetic_track(np, 120.0, sep.sample_rate)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sep.separate(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    b1 = {n: sum(k[1] for k in kernels if n in k[0])
          for n in ("ln_qkv_kernel", "attn_kernel", "post_kernel")}
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "fused_row_block_ms": b1,
           "top": [{"name": k[0][:120], "ms": k[1], "count": k[2]} for k in kernels[:25]]}
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
        return res
    log(f"profile: one 120 s separation, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {res['idle_share']:.4f}")
    log("profile: fused_row_block launches " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in b1.items()))
    for k in kernels[:12]:
        log(f"  {k[1]:10.3f} ms  x{k[2]:<5d} {k[0][:90]}")
    return res


def phase_routes(torch, np, sep_kernel):
    """One 10 s segment through the kernel route and the plain route."""
    sep_plain = make_separator(torch, "xla")
    sep_plain.model.load_state_dict(sep_kernel.model.state_dict())
    seg = synthetic_track(np, 10.0, sep_kernel.sample_rate)[None]
    with torch.inference_mode():
        x = torch.from_numpy(seg).cuda()
        a = sep_kernel._separate_core(x).double().cpu().numpy()
        b = sep_plain._separate_core(x).double().cpu().numpy()
    snrs = [float(10 * np.log10(np.sum(b[:, s] ** 2) / np.sum((a[:, s] - b[:, s]) ** 2)))
            for s in range(a.shape[1])]
    log(f"kernel route vs plain route, one 10 s segment: SNR per stem "
        f"{[round(s, 3) for s in snrs]} dB (min {SNR_MIN_DB} dB)")
    if not (np.isfinite(a).all() and min(snrs) >= SNR_MIN_DB):
        fail(f"kernel route vs plain route SNR {snrs} below {SNR_MIN_DB} dB")
    return snrs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel checks only")
    args = ap.parse_args()

    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"missing dependency: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "tfswa_tpu_torch")):
        fail("tfswa_tpu_torch not found next to chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from tfswa_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build(["fused_block"])
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s")
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    shapes, max_err, totals = phase_kernels(torch, args.quick)
    results = {"gpu": gpu, "build_s": build_s, "shapes": shapes, "totals": totals}
    main_path = {"launches": None}
    if not args.quick:
        main_path, sep = phase_main_path(torch, np, gpu)
        results["main_path"] = main_path
        results["profile"] = phase_profile(torch, np, sep)
        results["route_snr_db"] = phase_routes(torch, np, sep)
        log("per model forward (66 calls): kernel_ms {ms:.3f} plain_ms {plain_ms:.3f} "
            "library_ms {library_ms:.3f} bound_ms {bound_ms:.4f}".format(**totals))

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    timed = not args.quick
    kernel = {
        "name": "fused_row_block", "route": "cuda",
        "source": "tfswa_tpu_torch/csrc/fused_block.cu",
        "replaces": "tfswa_tpu/ops/pallas/fused_block.py:140",
        "launches": main_path["launches"], "max_abs_err": max_err,
        "ms": totals["ms"] if timed else None,
        "plain_ms": totals["plain_ms"] if timed else None,
        "bound_ms": totals["bound_ms"] if timed else None,
        "bound_by": ("bytes" if totals["bound_bytes_ms"] * 2 >= totals["bound_ms"]
                     else "operations") if timed else None,
        "library_ms": totals["library_ms"] if timed else None,
    }
    log(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
