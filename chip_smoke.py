#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tfswa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # the whole run (a few minutes on an H100)
    python3 chip_smoke.py --quick   # build + kernel-vs-plain checks only

Six kernels: B1 (fused_row_block, the serving forward), B1-train
(fused_row_block_train, the forward that also exports mid, acc, den), B2
(fused_row_block_bwd, the whole-block VJP), B3 (fused_row_block_int8, the
serving forward with int8 scores, route "pallas_int8"), B4
(flash_row_attention, the bilinear row attention, route "pallas_attn") and
L (lab_row_block, the kernel lab's stage and flag forms of B1).
Phases, each of which fails the run (exit code 1) when it fails:
  1. the card's name and power limit; build of the CUDA sources (nvcc, sm_90a,
     one nvcc per source, in parallel); the SASS of every instantiation of
     the launches whose products run on the tensor cores (B1's ln_qkv_kernel,
     attn_kernel and post_kernel, B2's mlp_bwd_kernel, attn_bwd_q_kernel,
     attn_bwd_kv_kernel, ln1_bwd_kernel and atb_kernel, B4's proj_kernel and
     bilinear_attn_kernel) must hold HMMA instructions, and
     B3's int8 forms of attn_kernel IMMA (cuobjdump --dump-sass of the built
     libraries);
  2. the fused row-block kernel against its plain PyTorch version at each
     of the 12 (N, C) of the main path (bf16, a slice of 64 rows, three kinds
     of weights: flat, peaked and clamped softmax), on the block's output
     and on its attention output before the out-projection, with
     kernel / plain / library times and the bound at the full row counts of
     a batch of 8 ten-second segments, and the device time of each of its
     launches (ln_qkv_kernel, attn_kernel, post_kernel) from a profiler
     trace beside its own bound; then the same checks at one shape with an
     MLP of 96 units (C = 32), a ragged last hidden chunk;
 2a. the kernel lab (L), also under --quick: its 5 stage cuts and 3 flag
     forms against their plain versions (fed the kernel's q|k|v) at the 12
     shapes under the 3 kinds of weights (288 checks), and all 9 forms at
     the (N, C) of the CLI's shapes that no serving shape has (27 more);
     the stage ablation (qkv, scores, exp2, av, attn, full) and the flag
     forms timed at the full row counts with bounds and plain times, and
     net of each cut's own output launch (device time from the profiler);
     then its main path, the
     CLI (python -m tfswa_tpu_torch.tools.kernel_lab --ablate, then
     --check) in a subprocess, whose lab launches are counted;
  3. B3 the same way (the plain version gets the kernel's q|k|v; the int8 q
     and k and the row scales must agree exactly; its attention launch timed
     beside its bound), and B4 (on LN1 output;
     the plain version gets the kernel's t and v; its output and its
     attention output before the out-projection within 4 bf16 ULP), B4's
     checks also at the 4 training (N, C) that no serving shape has, since
     the "pallas_attn" train step runs B4 there; B4's launches (its two
     projections, its attention) timed from a profiler trace with bounds;
  4. the main path of each serving route ("pallas": B1, "pallas_int8": B3,
     "pallas_attn": B4): the flagship model (random weights from a seed,
     bf16, in/out 4, depths (2,2,6,2), dims (32,64,128,256)) in a
     SourceSeparator with the EvalConfig.fast_serving() knobs separates a
     120 s synthetic track; the route's kernel must launch 66 times per
     model forward and no other kernel at all; then one more separation
     under torch.profiler for device time by kernel;
  5. the separated audio of one 10 s segment through each kernel route
     against the plain route (same weights, bf16), as an SNR (B3 also
     against B1's route);
  6. B1-train and B2 against their plain versions at the 12 (N, C) of the
     training path (a batch of 4 six-second segments, F = 1025), 64-row
     slices under the same three kinds of weights, B2 also against autograd
     through the plain block in f32, its attention backward's own output
     (dqkv) against the plain attention backward, and two runs of B2 bit
     for bit, and the same checks at one shape with an MLP of 96 units
     (C = 32); kernel / plain / library times and the bound at the full row
     counts, and the device time of B1-train's attention launch and of B2's
     mlp_bwd_kernel, attention backward, ln1_bwd_kernel and atb_kernel
     beside their bounds;
  7. the training main path: the flagship model in train mode through
     make_train_step (TrainConfig defaults) on a fixed batch of 4 x 6 s from
     the port's SyntheticDataset: a warm-up step and 5 timed steps, each
     with 66 B1-train and 66 B2 launches and no serving launch, finite
     non-zero gradients for every row-block parameter, a falling loss; one
     profiled step; make_eval_step with 66 serving launches; then the same
     model through "pallas_attn": a warm-up step and 2 timed steps with 66
     B4 launches each and no other kernel, finite non-zero gradients;
  8. one train step through each kernel route ("pallas", "pallas_attn")
     against the plain route (same weights and batch): loss and gradient
     cosine;
  9. a JSON line of the kernels, then the last line
     {"ok": true, "device": {...}}.
Long results go to chiprun_out/chip_smoke.json.  Without a CUDA device, or
outside a checkout of the repository, the run exits non-zero with no result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet), dense: bf16 tensor-core rate
# and HBM rate.  exp2 runs on the SFU (MUFU): 16 per clock per SM, at the
# SM clock nvidia-smi reports as clocks.max.sm (set in main()).
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
MUFU_PER_CLOCK_PER_SM = 16
MUFU_RATE = None    # exp2 per second, from the card

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
# (N, C, hidden) of the checks at an MLP width off the kernels' hidden
# chunks (64 and 128 units): a ragged last chunk, and a ragged N
RAGGED_MLP = (517, 32, 96)
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


def mufu_rate(torch) -> float:
    """exp2 per second: 16 per clock per SM at the card's top SM clock."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


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


def _bound(nbytes: float, flops: float, exp2: float, int8_ops: float = 0.0):
    """The larger of bytes over the HBM rate, the tensor-core time (bf16
    FLOPs over the bf16 peak plus int8 operations over the int8 peak) and
    exp2 over the MUFU rate, in ms, and which of bytes or operations it
    is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS, exp2 / MUFU_RATE) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(R: int, N: int, C: int, hidden: int, train: bool = False, int8: bool = False):
    """Least time for one B1 (or B1-train, or B3) call: rows in and out
    (B1-train: also mid, acc and den out) plus weights once, in bf16, over
    the HBM rate; the products and scores/AV (bf16 operands) over the bf16
    tensor-core peak, B3's scores (int8 operands) over the int8 peak;
    H*N^2 exp2 per row over the MUFU rate."""
    nbytes = 2 * (2 * R * N * C + 4 * C * C + 2 * C * hidden + 6 * C + hidden)
    if train:
        nbytes += 2 * 2 * R * N * C + 4 * R * HEADS * N
    flops = 2 * R * N * (4 * C * C + 2 * C * hidden) + 2 * R * N * N * C
    scores = 2 * R * N * N * C
    return _bound(nbytes, flops + (0 if int8 else scores), R * HEADS * N * N,
                  scores if int8 else 0)


def bound_attn_ms(R: int, N: int, C: int):
    """Least time for one B4 call: rows in and out (bf16), A (H C^2), Wv and
    Wo (bf16) and the f32 bias once; the products over the bf16 peak (v and
    the out-projection 2 C^2 a token each, t 2 H C^2 a token, the scores
    2 H N^2 C a row, since t is rounded to bf16 and no rank-D shortcut
    computes the same function, and AV 2 N^2 C a row); H*N^2 exp a row
    over the MUFU rate."""
    nbytes = 2 * 2 * R * N * C + 2 * (HEADS + 2) * C * C + 4 * C
    flops = 2 * R * N * (2 * C * C + HEADS * C * C) + 2 * R * N * N * C * (HEADS + 1)
    return _bound(nbytes, flops, R * HEADS * N * N)


def bound_bwd_ms(R: int, N: int, C: int, hidden: int):
    """Least time for one B2 call, the function's floor: rows, mid, acc, g
    in (bf16), den in (f32), weights in, dx out (bf16) and the gradients
    out (f32); the products (q|k|v and fc1 recomputed, which the inputs
    force; the MLP VJP's four, dWo and d_acc, d_normed and dWqkv) and the
    attention's five (scores s and d_p once each, d_q, d_k, d_v); H*N^2
    exp2 per row, once.  The design's second pass over s, d_p and exp2
    (one per attention-backward kernel) is its own cost, not counted."""
    M = R * N
    weights = 4 * C * C + 2 * C * hidden + 6 * C + hidden
    nbytes = 2 * 5 * M * C + 4 * R * HEADS * N + 2 * weights + 4 * weights
    flops = 2 * M * (3 * C * C + C * hidden + 4 * C * hidden + 2 * C * C + 6 * C * C) \
        + 5 * 2 * R * N * N * C
    return _bound(nbytes, flops, R * HEADS * N * N)


def bound_launch_ms(kernel: str, R: int, N: int, C: int, hidden: int, form: str = "B1"):
    """Least time for one launch of a kernel at (R, N, C) in B1, B1-train,
    B2, B3 or B4 (``form``), each of its inputs read once and its outputs
    written once (bf16, f32 where the kernel keeps f32), its products over
    the bf16 tensor-core peak (B3's scores over the int8 peak), exp2 or exp
    over the MUFU rate:
      ln_qkv_kernel:        x in, q|k|v out, LN1 and W_qkv; 2 M C 3C FLOPs;
      k_norm_kernel:        k in, the rows' largest |k_h| (f32) out (B3:
                            and k in int8);
      attn_kernel:          q|k|v in, acc out (B1-train: and den, f32);
                            scores 2 N^2 C and AV 2 N^2 C a row; H N^2 exp2
                            a row;
      post_kernel:          x and acc in, out out, Wo, W1, W2 and vectors;
                            2 M (C^2 + 2 C hidden) FLOPs;
      mlp_bwd_kernel:       mid, g, acc in, den (f32), W1, W1^T, W2^T, Wo^T,
                            LN2 and b1; n2, h1, d_h1pre, d_mid (f32 and
                            bf16), d_oe, d_den (f32) and the five vectors
                            (f32) out; fc1, g W2^T, d_n2 and d_acc, 2 M (3 C
                            hidden + C^2) FLOPs;
      attn_bwd:             B2's attention backward, its launches
                            (attn_bwd_q_kernel, attn_bwd_kv_kernel and the
                            small attn_bwd_norm_kernel before them) together:
                            q|k|v and d_oe in, d_den (f32) in, dqkv out; five
                            products of 2 N^2 C a row (s, d_p, d_q, d_k,
                            d_v); H N^2 exp2 a row, once, so that a
                            two-pass design shows its second pass as a gap;
      ln1_bwd_kernel:       x, dqkv and d_mid (f32) in, dx out (14 C bytes a
                            token), W_qkv^T and ln1_s in, the two vector
                            partials (f32) of each 64-token block out; 6 M
                            C^2 FLOPs;
      atb_kernel:           B2's four weight gradients together: their
                            operands (h1 and g, n2 and d_h1pre, acc and
                            d_mid, normed and d_qkv) in, the gradients (f32)
                            out; 2 M (2 C hidden + 4 C^2) FLOPs;
      proj_kernel:          B4's two projections together (x -> v, acc ->
                            out): 2 M C in and out, Wv, Wo, b; 4 M C^2;
      bilinear_attn_kernel: x and v in, acc out, A; t 2 M H C^2, the scores
                            2 H N^2 C a row, AV 2 N^2 C a row; H N^2 exp."""
    M = R * N
    if kernel == "k_norm_kernel":
        return _bound(2 * M * C + 4 * R * HEADS + (M * C if form == "B3" else 0), 0, 0)
    if kernel == "attn_kernel":
        nbytes = 2 * 4 * M * C + (4 * R * HEADS * N if form == "B1-train" else 0)
        scores, av = 2 * R * N * N * C, 2 * R * N * N * C
        if form == "B3":
            return _bound(nbytes, av, R * HEADS * N * N, scores)
        return _bound(nbytes, scores + av, R * HEADS * N * N)
    if kernel == "mlp_bwd_kernel":
        nbytes = (2 * 3 * M * C + 4 * R * HEADS * N + 2 * (3 * C * hidden + C * C)
                  + 2 * (2 * C + hidden)
                  + 2 * M * (2 * C + 2 * hidden) + 4 * M * C + 2 * 2 * M * C + 4 * M * HEADS
                  + 4 * (4 * C + hidden))
        return _bound(nbytes, 2 * M * (3 * C * hidden + C * C), 0)
    if kernel == "attn_bwd":
        return _bound(2 * 7 * M * C + 4 * M * HEADS, 5 * 2 * R * N * N * C, R * HEADS * N * N)
    if kernel == "ln1_bwd_kernel":
        blocks = min(-(-M // 64), 1024)
        return _bound(14 * M * C + 2 * (3 * C * C + C) + 4 * 2 * C * blocks, 6 * M * C * C, 0)
    if kernel == "atb_kernel":
        return _bound(2 * M * (2 * hidden + 7 * C) + 4 * (2 * C * hidden + 4 * C * C),
                      2 * M * (2 * C * hidden + 4 * C * C), 0)
    if kernel == "ln_qkv_kernel":
        return _bound(2 * (4 * M * C + 3 * C * C + 2 * C), 6 * M * C * C, 0)
    if kernel == "post_kernel":
        return _bound(2 * (3 * M * C + C * C + 2 * C * hidden + 5 * C + hidden),
                      2 * M * (C * C + 2 * C * hidden), 0)
    if kernel == "proj_kernel":
        return _bound(2 * 4 * M * C + 2 * 2 * C * C + 4 * C, 4 * M * C * C, 0)
    if kernel == "bilinear_attn_kernel":
        return _bound(2 * (3 * M * C + HEADS * C * C),
                      2 * M * HEADS * C * C + 2 * R * N * N * C * (HEADS + 1),
                      R * HEADS * N * N)
    raise ValueError(kernel)


# The launches of each kernel timed one by one from a profiler trace, as
# torch.profiler names them, matched as substrings ("attn_bwd": B2's
# attention-backward launches together, LAUNCH_PARTS; B1-train and B3 share
# B1's product launches: only their k_norm_kernel and attention launch are
# timed on their own),
# and the launches that run on the tensor cores, as they appear in the SASS
# of each library.
# Every form of attn_kernel runs its scores and AV on mma (P_F32 too: its
# f32 p goes through two bf16 products, hi and lo); none is SIMT by design.
PRODUCT_LAUNCHES = {"B1": ("ln_qkv_kernel", "k_norm_kernel", "attn_kernel", "post_kernel"),
                    "B1-train": ("k_norm_kernel", "attn_kernel"),
                    "B3": ("k_norm_kernel", "attn_kernel"),
                    "B2": ("mlp_bwd_kernel", "attn_bwd", "ln1_bwd_kernel", "atb_kernel"),
                    "B4": ("proj_kernel", "bilinear_attn_kernel")}
# A launch group of PRODUCT_LAUNCHES timed against one bound, and its
# launches, each timed on its own from the same trace.
LAUNCH_PARTS = {"attn_bwd": ("attn_bwd_norm_kernel", "attn_bwd_q_kernel", "attn_bwd_kv_kernel")}
SASS_HMMA = {"fused_block": ("ln_qkv_kernel", "attn_kernel", "post_kernel"),
             "fused_block_bwd": ("ln_qkv_kernel", "mlp_bwd_kernel", "attn_bwd_q_kernel",
                                 "attn_bwd_kv_kernel", "ln1_bwd_kernel", "atb_kernel"),
             "row_attention": ("proj_kernel", "bilinear_attn_kernel")}


def int8_form(fn: str) -> bool:
    """Whether a mangled attn_kernel<D, WITH_DEN, INT8, ...> name is an INT8
    (B3) instantiation, whose scores must run as IMMA."""
    return re.search(r"attn_kernelILi\d+ELb[01]ELb1E", fn) is not None


def sass_hmma_check():
    """Every instantiation of the kernels of SASS_HMMA in the built
    libraries holds HMMA (tensor-core) instructions, and every INT8 form of
    attn_kernel IMMA ones, by cuobjdump --dump-sass; fails the run if one
    does not, or if a kernel is not found.  Returns {library: {function:
    count of HMMA, IMMA for the INT8 forms}} of those kernels."""
    from pathlib import Path

    from tfswa_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    found, bad = {}, []
    for lib, names in SASS_HMMA.items():
        res = subprocess.run([str(tool), "--dump-sass", str(_build.BUILD_DIR / f"lib{lib}.so")],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"cuobjdump --dump-sass lib{lib}.so failed: {res.stderr[-2000:]}")
        counts, fn = {}, None
        for line in res.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                fn = fn if any(n in fn for n in names) else None
                if fn:
                    counts[fn] = 0
            elif fn and ("IMMA" if int8_form(fn) else "HMMA") in line:
                counts[fn] += 1
        found[lib] = counts
        for n in names:
            fns = [f for f in counts if n in f]
            if not fns:
                bad.append(f"{lib}: no {n} in the SASS")
            bad += [f"{lib}: {f}: no {'IMMA' if int8_form(f) else 'HMMA'}"
                for f in fns if counts[f] == 0]
        def span(n, int8):
            cs = [c for f, c in counts.items() if n in f and int8_form(f) == int8]
            return f"{len(cs)} with {'IMMA' if int8 else 'HMMA'} {min(cs)}-{max(cs)}" if cs else ""

        log(f"  SASS {lib}: " + ", ".join(
            f"{n} " + "; ".join(x for x in (span(n, False), span(n, True)) if x)
            for n in names))
    if bad:
        fail("tensor-core check: " + "; ".join(bad))
    return found


def launch_ms(torch, run, names, reps: int = 2, tries: int = 3):
    """Device ms a call of ``run`` spends in each kernel of ``names`` (all
    its launches of that kernel), from a torch.profiler trace (CUDA
    activity) of ``reps`` calls; a trace that misses one of the kernels is
    taken again, up to ``tries`` traces (the profiler now and then records
    no device events); None where the last trace still holds no such
    kernel (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)[0]
        res = {}
        for n in names:
            hits = [ms for key, ms, _ in kernels if n in key]
            res[n] = sum(hits) / reps if hits else None
        if None not in res.values():
            break
    return res


def log_launches(label: str, launches) -> None:
    def ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    def parts(t):
        if "parts" not in t:
            return ""
        return " (" + ", ".join(f"{m} {ms(v)}" for m, v in t["parts"].items()) + ")"

    log(f"  {label} launches: " + ", ".join(
        f"{n} {ms(t['ms'])}{parts(t)} (bound {t['bound_ms']:.4f}, {t['bound_by']})"
        for n, t in launches.items()))


def runs_at(name: str, N: int, kernel: str) -> bool:
    """Whether launch ``name`` of ``kernel`` runs at rows of N keys:
    k_norm_kernel only for rows longer than one 64-key tile, but in B3
    always (it quantises k; csrc/fused_block.cu launch_attn_form)."""
    return name != "k_norm_kernel" or N > 64 or kernel == "B3"


def time_launches(torch, run, kernel: str, R: int, N: int, C: int):
    """The device time a call of ``run`` spends in each launch of ``kernel``
    in PRODUCT_LAUNCHES, with its bound (bound_launch_ms); 0 for a launch
    that does not run at this N."""
    names = PRODUCT_LAUNCHES[kernel]
    timed = [n for n in names if runs_at(n, N, kernel)]
    got = launch_ms(torch, run, timed + [m for n in timed for m in LAUNCH_PARTS.get(n, ())])
    res = {}
    for n in names:
        if not runs_at(n, N, kernel):
            res[n] = {"ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes"}
            continue
        b_ms, b_by = bound_launch_ms(n, R, N, C, 4 * C, kernel)
        res[n] = {"ms": got[n], "bound_ms": b_ms, "bound_by": b_by}
        if n in LAUNCH_PARTS:
            res[n]["parts"] = {m: got[m] for m in LAUNCH_PARTS[n]}
    return res


# The kernel is checked on three kinds of weights at every shape, so that
# the attention's own share of the result is large enough to see a fault:
#   flat:   qkv std 0.05, scores of std ~0.1-1 (log2 units), near-uniform
#           softmax; a padded key that added exp2(0) = 1 shows here;
#   peaked: qkv std 1.44/sqrt(C), scores of std ~3, a few keys dominate;
#   clamp:  peaked, LN1 scale x6, so that scores pass SCORE_CLAMP and the
#           clamp decides the result (without it, inf/inf).
# score std = log2(e) * C * qkv_std^2 for unit-variance LN output.
REGIMES = {"flat": (None, 1.0), "peaked": (1.44, 1.0), "clamp": (1.44, 6.0)}


def random_params(torch, RowBlockParams, C: int, gen, regime: str = "flat",
                  hidden=None):
    hid = 4 * C if hidden is None else hidden
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


def check_shape(torch, N: int, C: int, gen, hidden=None):
    """The kernel against its plain version on CHECK_ROWS rows, for each
    kind of weights in REGIMES.  The plain version gets the kernel's own
    q|k|v (as in check_train_shape and check_int8_shape): the qkv product
    sums on the tensor cores, in another order than cuBLAS's f32 sums, and
    a bf16 rounding of q or k that flips between the two moves a peaked
    softmax by percents.  How many elements of each side's q|k|v round
    otherwise than the exact (f64) product is recorded.  Three quantities
    are held:
      qkv:  the kernel's q|k|v within 2 bf16 ULP at max|ref| of the plain
            recompute (plain_qkv);
      out:  the block's output, max abs err <= 0.0625 * max(max|ref| / 4, 1)
            (2 bf16 ULP at magnitude 4, scaled with the output);
      attn: the attention output before the out-projection, max abs err
            <= 4 bf16 ULP at max|ref attn|.  Both sides round p to bf16 at
            the same point; an f32 sum in another order flips a rounding
            now and then, which moves a peaked softmax by up to ~2 ULP.
    ``hidden``: the MLP's width (default 4 C).  Returns the per-regime
    results and the flat regime's parameters."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.fused_block import (SCORE_CLAMP, _forward_kernel,
                                                 fused_row_block_reference_parts)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        run = _forward_kernel(x, p, HEADS)
        got, got_attn, qkv = run.out, run.attn, run.qkv
        torch.cuda.synchronize()
        ref, ref_attn = fused_row_block_reference_parts(x, p, HEADS, qkv=qkv)
        r_qkv = plain_qkv(torch, x, p, HEADS)
        qkv_err = _max_abs(qkv, r_qkv)
        qkv_tol = 2 * bf16_ulp(r_qkv.abs().max().item())
        # recorded: how often each side's f32 sums round q|k|v otherwise
        # than the exact product does
        exact = plain_qkv(torch, x, p, HEADS, torch.float64)
        off_exact = (int((qkv.float() != exact).sum()), int((r_qkv != exact).sum()),
                     exact.numel())
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 0.0625 * max(scale / 4.0, 1.0)
        a_err = (got_attn.float() - ref_attn.float()).abs().max().item()
        a_scale = ref_attn.float().abs().max().item()
        a_tol = 4 * bf16_ulp(a_scale)
        s_max = max_score(torch, x, p, HEADS)
        finite = bool(torch.isfinite(got.float()).all() and torch.isfinite(got_attn.float()).all())
        ok = finite and err <= tol and a_err <= a_tol and qkv_err <= qkv_tol
        if regime == "clamp" and s_max <= SCORE_CLAMP:
            ok = False   # the slice would not test the clamp
        res[regime] = {"qkv_err": qkv_err, "qkv_tol": qkv_tol, "qkv_off_exact": off_exact,
                       "max_abs_err": err, "tol": tol, "max_abs_ref": scale,
                       "attn_max_abs_err": a_err, "attn_tol": a_tol,
                       "attn_max_abs_ref": a_scale, "max_score": s_max, "ok": ok}
    return res, flat


def log_b1_checks(label: str, checks, misses) -> float:
    """Log B1's checks of one shape; a miss goes to ``misses``.  Returns the
    largest block-output error."""
    err = 0.0
    for regime, c in checks.items():
        k_off, p_off, n_qkv = c["qkv_off_exact"]
        log(f"kernel check {label} {regime:6s}: qkv "
            f"{c['qkv_err']:.4f}/{c['qkv_tol']:.4f} (rounded off the exact product: "
            f"kernel {k_off}, plain {p_off} of {n_qkv}), "
            f"out err {c['max_abs_err']:.5f} (tol {c['tol']:.4f}), attn err "
            f"{c['attn_max_abs_err']:.5f} (tol {c['attn_tol']:.4f}), max score "
            f"{c['max_score']:.1f} {'ok' if c['ok'] else 'MISS'}")
        if not c["ok"]:
            misses.append(f"{label} {regime}")
        err = max(err, c["max_abs_err"])
    return err


def phase_kernels(torch, quick: bool):
    from tfswa_tpu_torch.ops.fused_block import fused_row_block, fused_row_block_reference

    gen = torch.Generator().manual_seed(1)
    rows_out, misses, max_err = [], [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "bound_bytes_ms": 0.0, "launches": {}}
    for stage, attn, N, C, R in SHAPES:
        checks, p = check_shape(torch, N, C, gen)
        entry = {"stage": stage, "attn": attn, "N": N, "C": C, "R_full": R,
                 "checks": checks}
        max_err = max(max_err, log_b1_checks(f"stage {stage} {attn} N={N} C={C}", checks,
                                             misses))
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
            entry["launches"] = time_launches(torch, lambda: fused_row_block(xf, p, HEADS),
                                              "B1", R, N, C)
            log_launches("B1", entry["launches"])
            add_launches(totals, entry["launches"], calls)
            del xf
            torch.cuda.empty_cache()
        rows_out.append(entry)
    N, C, hid = RAGGED_MLP
    checks, _ = check_shape(torch, N, C, torch.Generator().manual_seed(10), hid)
    max_err = max(max_err, log_b1_checks(f"MLP of {hid} N={N} C={C}", checks, misses))
    rows_out.append({"N": N, "C": C, "hidden": hid, "checks": checks})
    if misses:
        fail("fused_row_block disagrees with its plain version at " + "; ".join(misses))
    if not quick:
        log_launches("per model forward (66 calls), B1", totals["launches"])
    return rows_out, max_err, totals


def add_launches(totals, launches, calls: int) -> None:
    """Sum the per-call launch times and bounds of a shape into
    totals["launches"], weighted by its calls a forward; a launch not
    measured at one shape is not measured in the sum."""
    for n, t in launches.items():
        tot = totals["launches"].setdefault(n, {"ms": 0.0, "bound_ms": 0.0, "bound_bytes_ms": 0.0})
        tot["ms"] = None if tot["ms"] is None or t["ms"] is None else tot["ms"] + calls * t["ms"]
        tot["bound_ms"] += calls * t["bound_ms"]
        if t["bound_by"] == "bytes":
            tot["bound_bytes_ms"] += calls * t["bound_ms"]
        tot["bound_by"] = "bytes" if 2 * tot["bound_bytes_ms"] >= tot["bound_ms"] else "operations"
        for m, ms in t.get("parts", {}).items():
            parts = tot.setdefault("parts", {})
            parts[m] = None if ms is None or parts.get(m, 0.0) is None else (
                parts.get(m, 0.0) + calls * ms)


# The kernel lab's forms (ops/lab_block.py), by name: (stage, flags).  All
# are timed, the stages in the ablation's order; all but "full" (B1 itself,
# phase 2) are checked.
LAB_FORMS = {
    "qkv": ("qkv", {}), "scores": ("scores", {}), "exp2": ("exp2", {}),
    "av": ("av", {}), "attn": ("attn", {}), "full": ("full", {}),
    "score_bf16": ("full", {"score_bf16": True}), "p_f32": ("full", {"p_f32": True}),
    "noclamp": ("full", {"clamp": False}),
}
# the lab's main path: the CLI as a user runs it, once per mode
LAB_ITERS, LAB_SHAPES = 3, "enc0"
LAB_VARIANTS = "prod,xla,hpair,nopair,exp2bf16,sbf16,d16,d4,wofold,ptf32,noclamp"
LAB_CLI = [["--ablate", "--iters", str(LAB_ITERS), "--shapes", LAB_SHAPES],
           ["--check", "--variants", LAB_VARIANTS]]
# the kernel each cut adds to B1's own launches to write its output
# (csrc/fused_block.cu): its device time is the cut's and not B1's, and
# comes off the cut's time in the ablation's net line
LAB_OWN_KERNELS = {"qkv": "qkv_sum_kernel", "scores": "kept_scores_kernel",
                   "av": "av_sum_kernel"}


def lab_limit(name: str, ref) -> float:
    """The limit of a lab form's check, from the plain version's output:
      qkv:           exact (the same f32 adds of the same q|k|v);
      scores:        2 bf16 ULP at max|ref| (sums over heads that cancel);
      exp2:          2 bf16 ULP of each element (checked elementwise);
      av:            1e-3 of max|ref| (f32 sums over N queries in another
                     order, each a sum of N products) plus 1 bf16 ULP at
                     max|ref|: the output is rounded to bf16, and a sum that
                     differs in its last f32 bits flips that rounding (a
                     full ULP, up to 2.3x the 1e-3 term at C = 256);
      attn and the flag forms: B1's block-output limit,
                     0.0625 * max(max|ref| / 4, 1), over finite elements."""
    finite = ref.float()[ref.float().isfinite()]
    scale = finite.abs().max().item() if finite.numel() else 0.0
    if name == "qkv":
        return 0.0
    if name == "scores":
        return 2 * bf16_ulp(scale)
    if name == "av":
        return 1e-3 * scale + bf16_ulp(scale)
    return 0.0625 * max(scale / 4.0, 1.0)


def check_lab_shape(torch, N: int, C: int, gen, with_full: bool = False):
    """The lab forms of LAB_FORMS but "full" (unless ``with_full``: B1's
    own checks do not run at this (N, C)) against their plain versions on
    CHECK_ROWS rows, for each kind of weights in REGIMES.  The plain version gets the
    kernel's own q|k|v (see check_train_shape).  Held: the error within
    lab_limit over the elements both give finite, the same elements
    non-finite in both (noclamp under the clamp regime overflows exp2 past
    a score of 128), and every element finite for the other forms."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.lab_block import lab_row_block_parts, lab_row_block_reference

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        forms = {}
        for name, (stage, kw) in LAB_FORMS.items():
            if name == "full" and not with_full:
                continue
            got, qkv = lab_row_block_parts(x, p, HEADS, stage, **kw)
            torch.cuda.synchronize()
            ref = lab_row_block_reference(x, p, HEADS, stage, qkv=qkv, **kw)
            g, r = got.float(), ref.float()
            fin_g, fin_r = g.isfinite(), r.isfinite()
            both = fin_g & fin_r
            diff = (g - r).abs()[both]
            err = diff.max().item() if diff.numel() else 0.0
            if name == "exp2":     # elementwise: the worst error in ULP of its element
                ulps = torch.exp2(torch.floor(torch.log2(r[both].abs().clamp_min(2.0 ** -100)))
                                  - 7)
                worst = (diff / ulps).max().item() if diff.numel() else 0.0
                ok_err, tol = worst <= 2.0, 2.0
                err_shown = worst
            else:
                tol = lab_limit(name, ref)
                ok_err, err_shown = err <= tol, err
            nonfinite_mismatch = int((fin_g != fin_r).sum())
            all_finite = bool(fin_g.all() and fin_r.all())
            ok = ok_err and nonfinite_mismatch == 0 and (name == "noclamp" or all_finite)
            forms[name] = {"max_abs_err": err, "err": err_shown, "tol": tol,
                           "nonfinite_mismatch": nonfinite_mismatch,
                           "nonfinite": int((~fin_r).sum()), "ok": ok}
            del got, qkv, ref
        res[regime] = {"forms": forms, "max_score": max_score(torch, x, p, HEADS),
                       "ok": all(f["ok"] for f in forms.values())}
        torch.cuda.empty_cache()
    return res, flat


def bound_lab_ms(name: str, R: int, N: int, C: int, hidden: int):
    """Least time for one lab form: B1's bound (bound_ms) cut at the stage.
    Bytes: rows in and out, LN1 and Wqkv (and from stage attn Wo, bo) once;
    the qkv product, then the scores, then AV (each 2 R N^2 C) and from
    stage attn the out-projection at the bf16 tensor-core rate; from stage
    exp2, H N^2 exp2 a row at the MUFU rate.  The flag forms compute the
    full stage's function on the same inputs: B1's bound."""
    stage = LAB_FORMS[name][0]
    if stage == "full":
        return bound_ms(R, N, C, hidden)
    k = ("qkv", "scores", "exp2", "av", "attn").index(stage)
    nbytes = 2 * (2 * R * N * C + 3 * C * C + 2 * C)
    flops = 2 * R * N * 3 * C * C + (2 * R * N * N * C if k >= 1 else 0) \
        + (2 * R * N * N * C if k >= 3 else 0)
    if k >= 4:
        nbytes += 2 * (C * C + C)
        flops += 2 * R * N * C * C
    return _bound(nbytes, flops, R * HEADS * N * N if k >= 2 else 0)


def lab_own_ms(torch, rows, p, reps: int = 2, tries: int = 3):
    """Device ms of one launch of each cut's own kernel (LAB_OWN_KERNELS), and
    of B1's ln_qkv_kernel, from a torch.profiler trace (CUDA activity) of
    ``reps`` calls of each of those cuts, taken again (up to ``tries``
    traces) while one of them is missing; None for a kernel the last trace
    does not hold (the profiler recorded no device time: not measured)."""
    from torch.profiler import ProfilerActivity, profile

    from tfswa_tpu_torch.ops.lab_block import lab_row_block_parts

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for name in LAB_OWN_KERNELS:
                for _ in range(reps):
                    lab_row_block_parts(rows, p, HEADS, name)
            torch.cuda.synchronize()
        kernels = device_kernels(prof)[0]
        per_call = {}
        for kernel, calls in [*((k, reps) for k in LAB_OWN_KERNELS.values()),
                              ("ln_qkv_kernel", reps * len(LAB_OWN_KERNELS))]:
            hits = [ms for key, ms, _ in kernels if kernel in key]
            per_call[kernel] = sum(hits) / calls if hits else None
        if None not in per_call.values():
            break
    return per_call


def run_lab_cli(argv):
    """The lab's CLI in a subprocess from the checkout, as a user runs it:
    its output lines and its launch counts (its last line)."""
    res = subprocess.run([sys.executable, "-m", "tfswa_tpu_torch.tools.kernel_lab", *argv],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    if res.returncode != 0:
        fail(f"kernel_lab {' '.join(argv)} exited {res.returncode}:\n{res.stderr[-3000:]}")
    return lines, json.loads(lines[-1])["launches"]


def log_lab_checks(N: int, C: int, checks, label: str) -> None:
    for regime, c in checks.items():
        log(f"lab check {label} N={N} C={C} {regime:6s}: " + ", ".join(
            f"{n} {f['err']:.3g}/{f['tol']:.3g}"
            + (f" nonfinite {f['nonfinite']} (mismatch {f['nonfinite_mismatch']})"
               if f["nonfinite"] or f["nonfinite_mismatch"] else "")
            + ("" if f["ok"] else " MISS") for n, f in c["forms"].items())
            + f"; max score {c['max_score']:.1f}")


def phase_lab(torch, quick: bool, b1_shapes):
    """The kernel lab (L): the forms of LAB_FORMS checked at the 12 serving
    shapes, and all of them, "full" too, at each (N, C) of the CLI's SHAPES
    that the serving shapes lack (every check reported before any failure);
    unless ``quick``, each form timed at the full row count, with its bound
    and its plain version's time (timed on PLAIN_ROWS rows, scaled), and the
    ablation also net of each cut's own kernel (lab_own_ms); then the
    lab's main path, its CLI run once per mode of LAB_CLI, whose launches
    are the kernel's count.  No PyTorch call computes a stage cut or a flag
    form: the library column is B1's SDPA block, for the full form."""
    from tfswa_tpu_torch.ops.lab_block import STAGES, lab_row_block, lab_row_block_reference
    from tfswa_tpu_torch.tools.kernel_lab import SHAPES as CLI_SHAPES

    gen = torch.Generator().manual_seed(8)
    gen_full = torch.Generator().manual_seed(9)
    rows_out, misses, max_err = [], [], 0.0
    keys = ("ms", "net_ms", "plain_ms", "bound_ms", "bound_bytes_ms")
    net_measured = True
    totals = {name: dict.fromkeys(keys, 0.0) for name in LAB_FORMS}

    def tally(N, C, checks):
        nonlocal max_err
        for regime, c in checks.items():
            for n, f in c["forms"].items():
                if not f["ok"]:
                    misses.append(f"{n} N={N} C={C} {regime}")
                if LAB_FORMS[n][0] in ("attn", "full"):      # the block's output
                    max_err = max(max_err, f["max_abs_err"])

    for (stage, attn, N, C, R), b1 in zip(SHAPES, b1_shapes):
        checks, p = check_lab_shape(torch, N, C, gen)
        entry = {"stage": stage, "attn": attn, "N": N, "C": C, "R_full": R, "checks": checks}
        log_lab_checks(N, C, checks, f"stage {stage} {attn}")
        tally(N, C, checks)
        if not quick:
            xf = torch.randn(R, N, C, generator=gen_full).cuda().to(torch.bfloat16)
            rs = min(R, PLAIN_ROWS)
            calls = BLOCKS_PER_STAGE[stage]
            timed = {}
            for name, (st, kw) in LAB_FORMS.items():
                k_ms = cuda_ms(torch, lambda: lab_row_block(xf, p, HEADS, st, **kw), 3)
                pl_ms = cuda_ms(torch, lambda: lab_row_block_reference(
                    xf[:rs], p, HEADS, st, **kw), 1) * R / rs
                b_ms, b_by = bound_lab_ms(name, R, N, C, 4 * C)
                timed[name] = {"ms": k_ms, "plain_ms": pl_ms, "bound_ms": b_ms,
                               "bound_by": b_by}
                for k, v in (("ms", k_ms), ("plain_ms", pl_ms), ("bound_ms", b_ms)):
                    totals[name][k] += calls * v
                if b_by == "bytes":
                    totals[name]["bound_bytes_ms"] += calls * b_ms
            own = lab_own_ms(torch, xf, p)
            net_measured = net_measured and None not in own.values()
            for name, t in timed.items():
                t["own_ms"] = own[LAB_OWN_KERNELS[name]] if name in LAB_OWN_KERNELS else 0.0
                if net_measured:
                    t["net_ms"] = t["ms"] - t["own_ms"]
                    totals[name]["net_ms"] += calls * t["net_ms"]
            entry.update(timed=timed, calls_per_forward=calls, plain_rows_timed=rs,
                         b1_library_ms=b1["library_ms"], ln_qkv_device_ms=own["ln_qkv_kernel"])
            for key in ("ms", "net_ms") if net_measured else ("ms",):
                prev = None      # each stage against the one before, each flag against full
                line = f"  {'full' if key == 'ms' else 'net'} R={R}:"
                for name, (_, kw) in LAB_FORMS.items():
                    t = timed[name][key]
                    ref_t = timed["full"][key] if kw else prev
                    line += f" {name} {t:.3f}" + ("" if ref_t is None else
                                                  f" ({t - ref_t:+.3f})")
                    prev = t
                log(line)
            log("    device ms of a launch: " + ", ".join(
                f"{k} {'not measured' if v is None else f'{v:.3f}'}" for k, v in own.items()))
            log("    bound " + " ".join(f"{n} {t['bound_ms']:.4f}" for n, t in timed.items())
                + "; plain " + " ".join(f"{n} {t['plain_ms']:.1f}" for n, t in timed.items()))
            del xf
            torch.cuda.empty_cache()
        rows_out.append(entry)
    served = {(N, C) for _, _, N, C, _ in SHAPES}
    for N, C in sorted({(N, C) for _, _, N, C, _ in CLI_SHAPES} - served):
        checks, _ = check_lab_shape(torch, N, C, gen, with_full=True)
        log_lab_checks(N, C, checks, "CLI shape")
        tally(N, C, checks)
        rows_out.append({"N": N, "C": C, "cli_shape": True, "checks": checks})
    n_checks = sum(len(c["forms"]) for e in rows_out for c in e["checks"].values())
    log(f"lab checks: {n_checks - len(misses)} of {n_checks} within limits")
    if misses:
        fail("the kernel lab disagrees with its plain version at " + "; ".join(misses))
    if not quick:
        for name, t in totals.items():
            if not net_measured:
                t["net_ms"] = None
            net = "not measured" if t["net_ms"] is None else f"{t['net_ms']:.3f}"
            log(f"per model forward (66 calls), lab {name}: kernel_ms {t['ms']:.3f} "
                f"net_ms {net} plain_ms {t['plain_ms']:.3f} bound_ms {t['bound_ms']:.4f}")
    # the lab's main path: every counter at 0 just before, read just after
    reset_counts()
    launches, cli = 0, []
    for argv in LAB_CLI:
        lines, counts = run_lab_cli(argv)
        launches += counts["lab_row_block"]
        cli.append({"argv": argv, "lines": lines, "launches": counts})
    ablated = sum(1 for label, *_ in CLI_SHAPES if LAB_SHAPES in label)
    variants = [v for v in LAB_VARIANTS.split(",") if v not in ("prod", "xla")]
    want = ablated * len(STAGES) * (1 + LAB_ITERS) + len(variants)   # a warm-up call each
    log(f"kernel_lab CLI: {launches} lab launches (expected {want}), in-process counts "
        f"{read_counts()}")
    if launches != want:
        fail(f"kernel_lab CLI: {launches} lab launches, expected {want}")
    return rows_out, max_err, totals, {"launches": launches, "runs": cli}


def check_int8_shape(torch, N: int, C: int, gen):
    """B3 against its plain version on CHECK_ROWS rows, for each kind of
    weights in REGIMES.  The plain version gets the kernel's own q|k|v, so
    that a bf16 rounding of q or k that flips between two summation orders
    (PERF.md, Findings) does not move the int8 values.  Held:
      int8: the kernel's int8 q and k and its row scales equal the plain
            version's quantisation of the same q|k|v, exactly (the count
            of mismatches must be 0);
      out:  the block's output within B1's limit, 0.0625 * max(max|ref|/4, 1);
      attn: the attention output before the out-projection within 4 bf16
            ULP at max|ref attn| (B1's limit)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.fused_block import (SCORE_CLAMP, _forward_kernel,
                                                 fused_row_block_int8_reference_parts,
                                                 quantize_rows)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        run = _forward_kernel(x, p, HEADS, int8=True)
        out, attn, qkv, scales, qk = run.out, run.attn, run.qkv, run.scales, run.qk
        torch.cuda.synchronize()
        r_out, r_attn = fused_row_block_int8_reference_parts(x, p, HEADS, qkv=qkv)
        q = qkv.float().view(CHECK_ROWS, N, 3 * C)
        (qi, sq), (ki, sk) = quantize_rows(q[..., :C]), quantize_rows(q[..., C:2 * C])
        r_qk = torch.cat([qi, ki], dim=-1).reshape(-1, 2 * C)
        mism = int((qk.float() != r_qk).sum()) + int(
            (scales != torch.cat([sq.view(-1, 1), sk.view(-1, 1)], dim=1)).sum())
        c = {"int8_mismatches": mism,
             "max_abs_err": _max_abs(out, r_out),
             "tol": 0.0625 * max(r_out.float().abs().max().item() / 4.0, 1.0),
             "max_abs_ref": r_out.float().abs().max().item(),
             "attn_max_abs_err": _max_abs(attn, r_attn),
             "attn_tol": 4 * bf16_ulp(r_attn.float().abs().max().item()),
             "attn_max_abs_ref": r_attn.float().abs().max().item(),
             "max_score": max_score(torch, x, p, HEADS)}
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(attn.float()).all())
        c["ok"] = (finite and mism == 0 and c["max_abs_err"] <= c["tol"]
                   and c["attn_max_abs_err"] <= c["attn_tol"]
                   and (regime != "clamp" or c["max_score"] > SCORE_CLAMP))
        res[regime] = c
    return res, flat


def phase_int8_kernels(torch, quick: bool, b1_shapes):
    """B3 at the 12 serving shapes: checks on 64 rows, then kernel / plain
    times and bounds at the full row count.  No PyTorch call computes
    int8-score attention: the library column is None, and B1's library
    block (from ``b1_shapes``) is recorded beside it for scale."""
    from tfswa_tpu_torch.ops.fused_block import (fused_row_block_int8,
                                                 fused_row_block_int8_reference)

    gen = torch.Generator().manual_seed(4)
    gen_full = torch.Generator().manual_seed(5)
    rows_out, misses, max_err = [], [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
              "b1_library_ms": 0.0, "bound_bytes_ms": 0.0, "launches": {}}
    for (stage, attn, N, C, R), b1 in zip(SHAPES, b1_shapes):
        checks, p = check_int8_shape(torch, N, C, gen)
        entry = {"stage": stage, "attn": attn, "N": N, "C": C, "R_full": R, "checks": checks}
        for regime, c in checks.items():
            log(f"B3 check stage {stage} {attn} N={N} C={C} {regime:6s}: int8 mismatches "
                f"{c['int8_mismatches']}, out err {c['max_abs_err']:.5f} (tol "
                f"{c['tol']:.4f}), attn err {c['attn_max_abs_err']:.5f} (tol "
                f"{c['attn_tol']:.4f}), max score {c['max_score']:.1f} "
                f"{'ok' if c['ok'] else 'MISS'}")
            if not c["ok"]:
                misses.append(f"N={N} C={C} {regime}")
            max_err = max(max_err, c["max_abs_err"])
        if not quick:
            xf = torch.randn(R, N, C, generator=gen_full).cuda().to(torch.bfloat16)
            k_ms = cuda_ms(torch, lambda: fused_row_block_int8(xf, p, HEADS), 3)
            rs = min(R, PLAIN_ROWS)
            pl_ms = cuda_ms(torch, lambda: fused_row_block_int8_reference(
                xf[:rs], p, HEADS), 1) * R / rs
            b_ms, b_by = bound_ms(R, N, C, 4 * C, int8=True)
            calls = BLOCKS_PER_STAGE[stage]
            entry.update(kernel_ms=k_ms, plain_ms=pl_ms, library_ms=None,
                         b1_library_ms=b1["library_ms"], bound_ms=b_ms, bound_by=b_by,
                         calls_per_forward=calls, plain_rows_timed=rs)
            for k, v in (("ms", k_ms), ("plain_ms", pl_ms), ("bound_ms", b_ms),
                         ("b1_library_ms", b1["library_ms"])):
                totals[k] += calls * v
            if b_by == "bytes":
                totals["bound_bytes_ms"] += calls * b_ms
            log(f"  full R={R}: kernel_ms {k_ms:.3f} plain_ms {pl_ms:.3f} (timed on {rs} "
                f"rows) library_ms none (B1's library block {b1['library_ms']:.3f}) "
                f"bound_ms {b_ms:.4f} ({b_by})")
            entry["launches"] = time_launches(torch, lambda: fused_row_block_int8(xf, p, HEADS),
                                              "B3", R, N, C)
            log_launches("B3", entry["launches"])
            add_launches(totals, entry["launches"], calls)
            del xf
            torch.cuda.empty_cache()
        rows_out.append(entry)
    if misses:
        fail("fused_row_block_int8 disagrees with its plain version at " + "; ".join(misses))
    if not quick:
        log_launches("per model forward (66 calls), B3", totals["launches"])
    return rows_out, max_err, totals


def ln1_rows(torch, x, p):
    """bf16(LN1(x)): what the "pallas_attn" route hands B4."""
    import torch.nn.functional as F

    return F.layer_norm(x.float(), (x.shape[-1],), p.norm1_scale, p.norm1_bias,
                        1e-5).to(x.dtype)


def attn_weights(torch, p):
    """The qkv kernel, out-projection and bias cast to bf16, as the
    "pallas_attn" route passes them to B4."""
    return [t.to(torch.bfloat16) for t in (p.qkv_kernel, p.proj_kernel, p.proj_bias)]


def library_attn(torch, rows, wqkv, wp, b, H: int):
    """Yardstick only (the port never calls it): the same attention from
    PyTorch library calls (cuBLAS qkv matmul, F.scaled_dot_product_attention,
    cuBLAS projection), chunked over rows to bound memory."""
    import torch.nn.functional as F

    R, N, C = rows.shape
    D = C // H
    chunk = max(1, (1 << 30) // (H * N * N * 4))
    outs = []
    for r0 in range(0, R, chunk):
        x = rows[r0:r0 + chunk]
        Rc = x.shape[0]
        qkv = (x @ wqkv).view(Rc, N, 3, H, D).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        outs.append(a.transpose(1, 2).reshape(Rc, N, C) @ wp + b)
    return torch.cat(outs)


def check_attn_shape(torch, N: int, C: int, gen):
    """B4 against its plain version on CHECK_ROWS rows of LN1 output, for
    each kind of weights in REGIMES (scores in natural units: no clamp in
    B4, "clamp" is its most peaked softmax).  The plain version gets the
    kernel's own t and v: an f32 sum in another order flips a bf16
    rounding of t now and then, and under a peaked softmax a flip moves
    the result by more than the rest of the arithmetic.  Held:
      t, v: within 2 bf16 ULP at max|ref| of the plain recompute;
      out:  B4's output within 4 bf16 ULP at max|ref out|;
      acc:  its attention output before the out-projection within 4 bf16
            ULP at max|ref acc|."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.row_attention import (_kernel, bilinear_weights,
                                                   flash_row_attention_reference_parts)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime)
        if regime == "flat":
            flat = p
        x = ln1_rows(torch, torch.randn(CHECK_ROWS, N, C, generator=gen).cuda()
                     .to(torch.bfloat16), p)
        w = attn_weights(torch, p)
        out, acc, v, t = _kernel(x, *w, HEADS, export=True)
        torch.cuda.synchronize()
        r_out, r_acc = flash_row_attention_reference_parts(x, *w, HEADS, t=t, v=v)
        a, wv = bilinear_weights(w[0], HEADS)
        xf = x.float()
        r_v = (xf @ wv.float()).to(x.dtype).reshape(-1, C)
        r_t = torch.stack([(xf @ a[h].to(x.dtype).float()).to(x.dtype)
                           for h in range(HEADS)], dim=2).reshape(-1, HEADS * C)
        t4 = t.float().view(CHECK_ROWS, N, HEADS, C)[:4]
        s_max = max((t4[:, :, h] @ xf[:4].transpose(-1, -2)).max().item()
                    for h in range(HEADS))
        c = {"t_err": _max_abs(t, r_t), "t_tol": 2 * bf16_ulp(r_t.float().abs().max().item()),
             "v_err": _max_abs(v, r_v), "v_tol": 2 * bf16_ulp(r_v.float().abs().max().item()),
             "max_abs_err": _max_abs(out, r_out),
             "tol": 4 * bf16_ulp(r_out.float().abs().max().item()),
             "max_abs_ref": r_out.float().abs().max().item(),
             "attn_max_abs_err": _max_abs(acc, r_acc),
             "attn_tol": 4 * bf16_ulp(r_acc.float().abs().max().item()),
             "attn_max_abs_ref": r_acc.float().abs().max().item(), "max_score": s_max}
        finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(acc.float()).all())
        c["ok"] = (finite and c["t_err"] <= c["t_tol"] and c["v_err"] <= c["v_tol"]
                   and c["max_abs_err"] <= c["tol"] and c["attn_max_abs_err"] <= c["attn_tol"])
        res[regime] = c
        del t
        torch.cuda.empty_cache()
    return res, flat


def phase_attn_kernels(torch, quick: bool):
    """B4 at the 12 serving shapes: checks on 64 rows, then kernel / plain /
    library times and bounds at the full row count.  Then the same checks
    at each training shape whose (N, C) no serving shape has, since the
    "pallas_attn" train step runs B4 there too (entries with "path":
    "train").  Every check is reported before any failure."""
    from tfswa_tpu_torch.ops.row_attention import (flash_row_attention,
                                                   flash_row_attention_reference)

    gen = torch.Generator().manual_seed(6)
    gen_full = torch.Generator().manual_seed(7)
    rows_out, misses, max_err = [], [], 0.0
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms")
    totals = dict(dict.fromkeys(keys, 0.0), launches={})
    serving_nc = {(N, C) for _, _, N, C, _ in SHAPES}
    train_only = [s for s in TRAIN_SHAPES if (s[2], s[3]) not in serving_nc]
    for path, shapes in (("serving", SHAPES), ("train", train_only)):
        for stage, attn, N, C, R in shapes:
            checks, p = check_attn_shape(torch, N, C, gen)
            entry = {"path": path, "stage": stage, "attn": attn, "N": N, "C": C,
                     "R_full": R, "checks": checks}
            for regime, c in checks.items():
                log(f"B4 check {path} stage {stage} {attn} N={N} C={C} {regime:6s}: t "
                    f"{c['t_err']:.4f}/{c['t_tol']:.4f} v {c['v_err']:.4f}/{c['v_tol']:.4f}, "
                    f"out err {c['max_abs_err']:.5f} (tol {c['tol']:.4f}), attn err "
                    f"{c['attn_max_abs_err']:.5f} (tol {c['attn_tol']:.4f}), max score "
                    f"{c['max_score']:.1f} {'ok' if c['ok'] else 'MISS'}")
                if not c["ok"]:
                    misses.append(f"{path} N={N} C={C} {regime}")
                max_err = max(max_err, c["max_abs_err"])
            if not quick and path == "serving":
                xf = torch.randn(R, N, C, generator=gen_full).cuda().to(torch.bfloat16)
                w = attn_weights(torch, p)
                with torch.no_grad():
                    k_ms = cuda_ms(torch, lambda: flash_row_attention(xf, *w, HEADS), 1)
                    rs = min(R, PLAIN_ROWS)
                    pl_ms = cuda_ms(torch, lambda: flash_row_attention_reference(
                        xf[:rs], *w, HEADS), 1) * R / rs
                    lib_ms = cuda_ms(torch, lambda: library_attn(torch, xf, *w, HEADS), 3)
                b_ms, b_by = bound_attn_ms(R, N, C)
                calls = BLOCKS_PER_STAGE[stage]
                entry.update(kernel_ms=k_ms, plain_ms=pl_ms, library_ms=lib_ms, bound_ms=b_ms,
                             bound_by=b_by, calls_per_forward=calls, plain_rows_timed=rs)
                for k, v in (("ms", k_ms), ("plain_ms", pl_ms), ("library_ms", lib_ms),
                             ("bound_ms", b_ms)):
                    totals[k] += calls * v
                if b_by == "bytes":
                    totals["bound_bytes_ms"] += calls * b_ms
                log(f"  full R={R}: kernel_ms {k_ms:.3f} plain_ms {pl_ms:.3f} (timed on {rs} "
                    f"rows) library_ms {lib_ms:.3f} bound_ms {b_ms:.4f} ({b_by})")
                with torch.no_grad():
                    entry["launches"] = time_launches(
                        torch, lambda: flash_row_attention(xf, *w, HEADS), "B4", R, N, C)
                log_launches("B4", entry["launches"])
                add_launches(totals, entry["launches"], calls)
                del xf
                torch.cuda.empty_cache()
            rows_out.append(entry)
    log(f"B4 checks: {3 * len(rows_out) - len(misses)} of {3 * len(rows_out)} within limits")
    if misses:
        fail("flash_row_attention disagrees with its plain version at " + "; ".join(misses))
    if not quick:
        log_launches("per model forward (66 calls), B4", totals["launches"])
    return rows_out, max_err, totals


# (stage, attention, N, C, R) of the row block on the training path: a batch
# of 4 six-second segments at 44.1 kHz, n_fft 2048, hop 512, every STFT row
# (freq_policy "full": F = 1025, T = 517), SWA padded to multiples of 8.
TRAIN_SHAPES = [
    (0, "TSA", 1025, 32, 2068), (0, "FSA", 517, 32, 4100), (0, "SWA", 64, 32, 33540),
    (1, "TSA", 512, 64, 1032), (1, "FSA", 258, 64, 2048), (1, "SWA", 64, 64, 8448),
    (2, "TSA", 256, 128, 516), (2, "FSA", 129, 128, 1024), (2, "SWA", 64, 128, 2176),
    (3, "TSA", 128, 256, 256), (3, "FSA", 64, 256, 512), (3, "SWA", 64, 256, 512),
]
TRAIN_BATCH, TRAIN_SECONDS, TRAIN_STEPS = 4, 6.0, 5
# the plain versions are timed on at most this many rows and scaled by R
PLAIN_ROWS = 256


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_max(a, b) -> float:
    """max |a - b| over max |b|."""
    return _max_abs(a, b) / max(b.float().abs().max().item(), 1e-30)


def _rel_l2(a, b) -> float:
    """||a - b|| over ||b||."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def autograd_grads(torch, fn, x, p, g):
    """[dx, 11 parameter gradients] of fn(x, p) at cotangent g, by autograd."""
    x = x.detach().requires_grad_()
    pr = type(p)(*(t.detach().requires_grad_() for t in p))
    fn(x, pr).backward(g)
    return [x.grad] + [t.grad for t in pr]


def library_fwd_bwd(torch, rows, p, H: int, g):
    """Yardstick only: forward and backward of library_block (LN, cuBLAS,
    SDPA), by autograd, one row chunk at a time to bound memory."""
    N = rows.shape[1]
    pr = type(p)(*(t.detach().requires_grad_() for t in p))
    chunk = max(1, (1 << 30) // (H * N * N * 4))
    for r0 in range(0, rows.shape[0], chunk):
        x = rows[r0:r0 + chunk].detach().requires_grad_()
        library_block(torch, x, pr, H).backward(g[r0:r0 + chunk])


# B2 against the f32 truth: at most this many times the distance of its
# plain version (the same rounding points), plus 1e-3, in every regime.
# The JAX package holds its B2 within 1.5x of autograd through the plain
# block in bf16 (tests/test_fused_block.py:183-193), on flat weights;
# under a peaked softmax the TPU kernel's own bf16 d_oe and d_den, which
# the plain route keeps in f32, put B2 and its plain version alike up to
# 1.9x that far from the truth (PERF.md), so that ratio is recorded, not
# held.
AUTOGRAD_FACTOR = 1.1


def plain_qkv(torch, x, p, H: int, dtype=None):
    """The plain q|k|v (R*N, 3C) of B1: bf16(bf16(LN1(x)) @ Wqkv'), f32;
    with ``dtype`` torch.float64, the product summed in f64 (so exactly,
    but for f64's own rounding) before its bf16 rounding."""
    from tfswa_tpu_torch.ops.fused_block import _block_weights, layer_norm_f32

    C = x.shape[-1]
    dt = dtype or torch.float32
    ln_s, ln_b, w_qkv = (w.float() for w in _block_weights(p, C, H, x.dtype)[:3])
    n1 = layer_norm_f32(x.float(), ln_s, ln_b).to(x.dtype).to(dt)
    return (n1 @ w_qkv.to(dt)).to(x.dtype).float().reshape(-1, 3 * C)


def check_train_shape(torch, N: int, C: int, gen, hidden=None):
    """B1-train and B2 against their plain versions on CHECK_ROWS rows, for
    each kind of weights in REGIMES.  The plain versions get the kernel's
    own q|k|v (B1-train's buffer; B2 recomputes it with the same code, so
    bit for bit): a bf16 rounding of q or k that flips between two
    summation orders moves a peaked softmax's denominator by percents and
    carries scores of the clamp regime across SCORE_CLAMP, where the
    gradient jumps.  The product that makes q|k|v is held on its own:
      qkv:      within 2 bf16 ULP at max|ref|;
      B1-train: out and mid within 0.0625 * max(max|ref| / 4, 1) (B1's out
                limit), acc within 4 bf16 ULP at max|ref| (B1's attention
                limit), den within 1e-2 relative, elementwise;
      B2:       fed the same rows, mid, acc, den and g as its plain version:
                dx within 4 bf16 ULP at max|dx_ref|, each parameter gradient
                within 1e-2 * max|ref leaf| (f32 sums over 64 rows of bf16
                products in another order); two runs give the same bits
                (dx, the gradients, dqkv);
      attention backward: the kernel's dqkv against the plain attention
                backward fed the kernel's q|k|v, d_oe and d_den
                (fused_row_block_bwd_reference_parts), q's, k's and v's
                gradients each within 4 bf16 ULP at its max|ref| (both round
                d_s and p at the same points; an f32 sum in another order
                flips a rounding now and then); the kernel's d_oe and d_den
                against the plain version's own are recorded;
      autograd: against autograd through the plain block in f32 (the
                truth), B2's relative error on each of the 12 gradients is
                at most AUTOGRAD_FACTOR times that of its plain version,
                plus 1e-3, with the error as ||a - t|| / ||t|| (a bias
                gradient, a sum over tokens with cancellation, holds bf16
                noise whose maximum moves by chance; the norm averages
                it).  Autograd through the plain block in bf16 is recorded
                beside them, by norm and by max.
    ``hidden``: the MLP's width (default 4 C)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.fused_block import (
        SCORE_CLAMP, _forward_kernel, fused_row_block_bwd_parts,
        fused_row_block_bwd_reference_parts, fused_row_block_reference, fused_row_block_train,
        fused_row_block_train_reference)

    def plain(a, q):
        return fused_row_block_reference(a, q, HEADS)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        g = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        out, mid, acc, den = fused_row_block_train(x, p, HEADS)
        again = _forward_kernel(x, p, HEADS, train=True)     # for its q|k|v buffer
        torch.cuda.synchronize()
        qkv = again.qkv
        r_qkv = plain_qkv(torch, x, p, HEADS)
        r_out, r_mid, r_acc, r_den = fused_row_block_train_reference(x, p, HEADS, qkv=qkv)
        c = {"qkv_err": _max_abs(qkv, r_qkv),
             "qkv_tol": 2 * bf16_ulp(r_qkv.abs().max().item()),
             "repeat_equal": all(bool(torch.equal(a, b)) for a, b in
                                 zip((out, acc, mid, den),
                                     (again.out, again.attn, again.mid, again.den))),
             "out_err": _max_abs(out, r_out),
             "out_tol": 0.0625 * max(r_out.float().abs().max().item() / 4.0, 1.0),
             "mid_err": _max_abs(mid, r_mid),
             "mid_tol": 0.0625 * max(r_mid.float().abs().max().item() / 4.0, 1.0),
             "acc_err": _max_abs(acc, r_acc),
             "acc_tol": 4 * bf16_ulp(r_acc.float().abs().max().item()),
             "den_rel": ((den - r_den).abs() / r_den.abs()).max().item(), "den_tol": 1e-2}
        parts = fused_row_block_bwd_parts(x, mid, acc, den, g, p, HEADS)
        twice = fused_row_block_bwd_parts(x, mid, acc, den, g, p, HEADS)
        torch.cuda.synchronize()
        dx, dp = parts.dx, parts.dp
        ref = fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, HEADS, qkv=qkv)
        r_dx, r_dp = ref.dx, ref.dp
        r_dqkv = fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, HEADS, qkv=qkv,
                                                     d_oe=parts.d_oe, d_den=parts.d_den).dqkv
        C3 = parts.dqkv.shape[-1] // 3
        qkv_parts = [(parts.dqkv[..., i * C3:(i + 1) * C3], r_dqkv[..., i * C3:(i + 1) * C3])
                     for i in range(3)]
        c.update(dx_err=_max_abs(dx, r_dx),
                 dx_tol=4 * bf16_ulp(r_dx.float().abs().max().item()),
                 dp_rel=max(_rel_max(a, b) for a, b in zip(dp, r_dp)), dp_tol=1e-2,
                 dqkv_err=[_max_abs(a, b) for a, b in qkv_parts],
                 dqkv_tol=[4 * bf16_ulp(b.float().abs().max().item()) for _, b in qkv_parts],
                 d_oe_err=_max_abs(parts.d_oe, ref.d_oe),
                 d_oe_max=ref.d_oe.float().abs().max().item(),
                 d_den_err=_max_abs(parts.d_den, ref.d_den),
                 d_den_max=ref.d_den.abs().max().item(),
                 bwd_repeat_equal=all(bool(torch.equal(a, b)) for a, b in zip(
                     (dx, *dp, parts.dqkv), (twice.dx, *twice.dp, twice.dqkv))))
        del twice, ref, r_dqkv, qkv_parts
        truth = autograd_grads(torch, plain, x.float(), p, g.float())
        plain_bf16 = autograd_grads(torch, plain, x, p, g)
        leaves = list(zip([dx, *dp], plain_bf16, truth, [r_dx, *r_dp]))
        c["autograd"] = [(_rel_l2(k, t), _rel_l2(b, t), _rel_l2(r, t))
                         for k, b, t, r in leaves]
        c["autograd_max"] = [(_rel_max(k, t), _rel_max(b, t)) for k, b, t, _ in leaves]
        ag_ok = all(e[0] <= AUTOGRAD_FACTOR * e[2] + 1e-3 for e in c["autograd"])
        c["max_score"] = max_score(torch, x, p, HEADS)
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (out, mid, acc, den, dx, *dp))
        c["ok"] = (finite and ag_ok and c["repeat_equal"] and c["qkv_err"] <= c["qkv_tol"]
                   and c["out_err"] <= c["out_tol"]
                   and c["mid_err"] <= c["mid_tol"] and c["acc_err"] <= c["acc_tol"]
                   and c["den_rel"] <= c["den_tol"] and c["dx_err"] <= c["dx_tol"]
                   and c["dp_rel"] <= c["dp_tol"] and c["bwd_repeat_equal"]
                   and all(e <= t for e, t in zip(c["dqkv_err"], c["dqkv_tol"]))
                   and (regime != "clamp" or c["max_score"] > SCORE_CLAMP))
        c["max_abs_err"] = max(c["out_err"], c["mid_err"], c["acc_err"])
        c["bwd_max_abs_err"] = c["dx_err"]
        res[regime] = c
        del truth, plain_bf16, again, qkv, parts
        torch.cuda.empty_cache()
    return res, flat


def log_train_checks(label: str, checks, misses, err) -> None:
    """Log B1-train's and B2's checks of one shape; a miss goes to
    ``misses``, the largest errors to ``err``."""
    for regime, c in checks.items():
        worst = max(c["autograd"], key=lambda e: e[0] / (AUTOGRAD_FACTOR * e[2] + 1e-3))
        max_ratio = max((k - 1e-3) / max(b, 1e-30) for k, b in c["autograd_max"])
        log(f"train check {label} {regime:6s}: "
            f"qkv {c['qkv_err']:.4f}/{c['qkv_tol']:.4f}; B1-train out "
            f"{c['out_err']:.4f}/{c['out_tol']:.4f} mid "
            f"{c['mid_err']:.4f}/{c['mid_tol']:.4f} acc {c['acc_err']:.5f}/"
            f"{c['acc_tol']:.4f} den {c['den_rel']:.1e}; B2 dx {c['dx_err']:.5f}/"
            f"{c['dx_tol']:.4f} params {c['dp_rel']:.1e}/1e-2 dq|dk|dv "
            + "|".join(f"{e:.2e}/{t:.2e}" for e, t in zip(c["dqkv_err"], c["dqkv_tol"]))
            + f" (d_oe {c['d_oe_err']:.1e} of {c['d_oe_max']:.1e}, d_den "
            f"{c['d_den_err']:.1e} of {c['d_den_max']:.1e}) twice "
            f"{'same' if c['bwd_repeat_equal'] else 'DIFFERENT'}; autograd worst "
            f"{worst[0]:.1e} vs plain B2 {worst[2]:.1e} x{AUTOGRAD_FACTOR} (plain "
            f"bf16 route {worst[1]:.1e}; by max: ratio {max_ratio:.2f}); max score "
            f"{c['max_score']:.1f} "
            f"{'ok' if c['ok'] else 'MISS'}")
        if not c["ok"]:
            misses.append(f"{label} {regime}")
        err["train"] = max(err["train"], c["max_abs_err"])
        err["bwd"] = max(err["bwd"], c["bwd_max_abs_err"])


def phase_train_kernels(torch, quick: bool):
    """B1-train and B2 at the 12 training shapes: checks on 64 rows, then
    kernel / plain / library times and bounds at the full row count, and
    the device time of B1-train's attention launch and of B2's launches
    (PRODUCT_LAUNCHES) beside their bounds; then the checks at RAGGED_MLP."""
    from tfswa_tpu_torch.ops.fused_block import (
        fused_row_block_bwd, fused_row_block_bwd_reference, fused_row_block_train,
        fused_row_block_train_reference)

    gen = torch.Generator().manual_seed(2)
    gen_full = torch.Generator().manual_seed(3)   # the timed tensors: the checks'
    rows_out, misses = [], []                     # inputs do not depend on --quick
    err = {"train": 0.0, "bwd": 0.0}
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms")
    totals = {"train": dict(dict.fromkeys(keys, 0.0), launches={}),
              "bwd": dict(dict.fromkeys(keys, 0.0), launches={})}
    for stage, attn, N, C, R in TRAIN_SHAPES:
        checks, p = check_train_shape(torch, N, C, gen)
        entry = {"stage": stage, "attn": attn, "N": N, "C": C, "R_full": R,
                 "checks": checks}
        log_train_checks(f"stage {stage} {attn} N={N} C={C}", checks, misses, err)
        if not quick:
            xf = torch.randn(R, N, C, generator=gen_full).cuda().to(torch.bfloat16)
            gf = torch.randn(R, N, C, generator=gen_full).cuda().to(torch.bfloat16)
            t_ms = cuda_ms(torch, lambda: fused_row_block_train(xf, p, HEADS), 3)
            _, mid, acc, den = fused_row_block_train(xf, p, HEADS)
            b_ms = cuda_ms(torch, lambda: fused_row_block_bwd(xf, mid, acc, den, gf, p, HEADS), 3)
            rs = min(R, PLAIN_ROWS)
            pt_ms = cuda_ms(torch, lambda: fused_row_block_train_reference(
                xf[:rs], p, HEADS), 1) * R / rs
            pb_ms = cuda_ms(torch, lambda: fused_row_block_bwd_reference(
                xf[:rs], mid[:rs], acc[:rs], den[:rs], gf[:rs], p, HEADS), 1) * R / rs
            lf_ms = cuda_ms(torch, lambda: library_block(torch, xf, p, HEADS), 2)
            lfb_ms = cuda_ms(torch, lambda: library_fwd_bwd(torch, xf, p, HEADS, gf), 1)
            bt = bound_ms(R, N, C, 4 * C, train=True)
            bb = bound_bwd_ms(R, N, C, 4 * C)
            calls = BLOCKS_PER_STAGE[stage]
            entry["train"] = {"ms": t_ms, "plain_ms": pt_ms, "library_ms": lf_ms,
                              "bound_ms": bt[0], "bound_by": bt[1]}
            entry["bwd"] = {"ms": b_ms, "plain_ms": pb_ms,
                            "library_ms": max(lfb_ms - lf_ms, 0.0),
                            "library_fwd_bwd_ms": lfb_ms, "bound_ms": bb[0],
                            "bound_by": bb[1]}
            entry.update(calls_per_step=calls, plain_rows_timed=rs)
            for kind in ("train", "bwd"):
                e = entry[kind]
                for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    totals[kind][k] += calls * e[k]
                if e["bound_by"] == "bytes":
                    totals[kind]["bound_bytes_ms"] += calls * e["bound_ms"]
                log(f"  full R={R} {'B1-train' if kind == 'train' else 'B2'}: kernel_ms "
                    f"{e['ms']:.3f} plain_ms {e['plain_ms']:.3f} (timed on {rs} rows) "
                    f"library_ms {e['library_ms']:.3f} bound_ms {e['bound_ms']:.4f} "
                    f"({e['bound_by']})")
            for kind, label, run in (
                    ("train", "B1-train", lambda: fused_row_block_train(xf, p, HEADS)),
                    ("bwd", "B2", lambda: fused_row_block_bwd(xf, mid, acc, den, gf, p, HEADS))):
                entry[kind]["launches"] = time_launches(torch, run, label, R, N, C)
                log_launches(label, entry[kind]["launches"])
                add_launches(totals[kind], entry[kind]["launches"], calls)
            del xf, gf, mid, acc, den
            torch.cuda.empty_cache()
        rows_out.append(entry)
    N, C, hid = RAGGED_MLP
    checks, _ = check_train_shape(torch, N, C, torch.Generator().manual_seed(11), hid)
    log_train_checks(f"MLP of {hid} N={N} C={C}", checks, misses, err)
    rows_out.append({"N": N, "C": C, "hidden": hid, "checks": checks})
    if misses:
        fail("B1-train / B2 disagree with their plain versions at " + "; ".join(misses))
    if not quick:
        log_launches("per train step (66 calls), B1-train", totals["train"]["launches"])
        log_launches("per train step (66 calls), B2", totals["bwd"]["launches"])
    return rows_out, err, totals


# Faults for --plant: text substitutions in a copy of csrc/fused_block_bwd.cu
# (each text occurs once there), each of which the B2 check must catch.
PLANTS = {
    # d_den = 0: the softmax denominator's share of d_p is lost
    "no_d_den": ("d_den[(size_t)tok * H + h] = round_bf16(-r * s);",
                 "d_den[(size_t)tok * H + h] = 0.f;"),
    # d_s = d_p * p * ln 2 also where the score was clamped (both passes)
    "no_clamp": ("s[j][e] < SCORE_CLAMP ? dp[j][e] * p * LN2F : 0.f", "dp[j][e] * p * LN2F"),
    # the q pass's key tiles read the tokens past N (the next row's) where
    # they are zero-filled: a ragged row's d_q takes keys that are not its own
    "ragged_keys": ("const bool key_in = k0 + j < N;", "const bool key_in = true;"),
    # the last token split of every weight-gradient sum left out
    "drop_last_split": ("for (int k = 0; k < S; ++k)", "for (int k = 0; k < S - 1; ++k)"),
}


def plant_fault(torch, name: str) -> None:
    """Build csrc/fused_block_bwd.cu with fault ``name`` of PLANTS into
    build/planted/ (outside the sources) with the port's nvcc flags, and
    swap the library in for B2."""
    import ctypes

    from tfswa_tpu_torch.ops import _build

    old, new = PLANTS[name]
    src = (_build.CSRC / "fused_block_bwd.cu").read_text()
    if old not in src:
        fail(f"planted fault {name}: its text is not in the source")
    out = _build.BUILD_DIR.parent / "planted"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"fused_block_bwd_{name}.cu"
    cu.write_text(src.replace(old, new))
    lib = out / f"libfused_block_bwd_{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-o", str(lib), str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"planted fault {name}: nvcc failed:\n{res.stdout}{res.stderr}")
    _build._loaded["fused_block_bwd"] = ctypes.CDLL(str(lib))
    log(f"planted fault {name}: {old!r} -> {new!r}")


def train_batch(torch, np):
    """A fixed batch of TRAIN_BATCH x TRAIN_SECONDS stereo segments from the
    port's SyntheticDataset (seed 0), on the card."""
    from tfswa_tpu_torch.data import SyntheticDataset

    ds = SyntheticDataset(num_tracks=TRAIN_BATCH, track_seconds=12.0,
                          segment_seconds=TRAIN_SECONDS, sample_rate=44100, seed=0)
    items = [ds[i] for i in range(TRAIN_BATCH)]
    mix = torch.from_numpy(np.stack([m for m, _ in items])).cuda()
    targets = {k: torch.from_numpy(np.stack([t[k] for _, t in items])).cuda()
               for k in ds.stems}
    return mix, targets


def make_trainer(torch, impl: str):
    """The flagship bf16 model (f32 parameters, weights from seed 0) in a
    TrainState with the TrainConfig defaults, and its train and eval steps."""
    from tfswa_tpu_torch.config import Config, ModelConfig, TrainConfig
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.training import (create_train_state, make_eval_step,
                                          make_train_step)

    cfg = Config(model=ModelConfig(in_channels=4, out_channels=4, attention_impl=impl,
                                   dtype="bfloat16"), train=TrainConfig(seed=0))
    model, state = create_train_state(cfg, device="cuda")
    proc = STFTProcessor(cfg.stft)
    stems = cfg.data.stems
    kw = dict(l1_weight=cfg.train.l1_weight, mask_mode=cfg.train.train_mask_mode,
              freq_policy=cfg.train.freq_policy)
    return (state, make_train_step(model, proc, stems, **kw),
            make_eval_step(model, proc, stems, **kw))


def row_block_grads(model):
    """(name, gradient) of every row-block parameter (66 blocks x 11)."""
    return [(n, p.grad) for n, p in model.named_parameters()
            if any(f".{a}." in n for a in ("tsa", "fsa", "swa"))]


# per train step, the launches of each kernel route (any other kernel: 0),
# the steps timed after the warm-up, and the device kernels to sum by group
TRAIN_ROUTES = {
    "pallas": ({"B1-train": 66, "B2": 66}, TRAIN_STEPS,
               {"B1-train": (*(f"ln_qkv_kernel<{C}, false>" for C in (32, 64, 128, 256)),
                             "k_norm_kernel", "attn_kernel", "post_kernel"),
                "B2": (*(f"ln_qkv_kernel<{C}, true>" for C in (32, 64, 128, 256)),
                       "mlp_bwd_kernel", "attn_bwd_norm_kernel", "attn_bwd_q_kernel",
                       "attn_bwd_kv_kernel", "ln1_bwd_kernel", "atb_kernel",
                       "reduce_kernel")}),
    "pallas_attn": ({"B4": 66}, 2, {"B4": ("proj_kernel", "bilinear_attn_kernel")}),
}


def phase_train(torch, np, gpu: str, impl: str = "pallas"):
    """The training main path through one route: a warm-up step, then
    counted and timed steps on one fixed batch (every launch counter set to
    0 just before and read just after), the checks, one profiled step and,
    for "pallas", an eval step.  The loss must fall over the "pallas"
    route's 5 steps; the "pallas_attn" route's 2 are recorded."""
    per_kernel, steps, groups = TRAIN_ROUTES[impl]
    state, step, eval_step = make_trainer(torch, impl)
    mix, targets = train_batch(torch, np)
    t0 = time.perf_counter()
    state, _ = step(state, mix, targets)                     # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses, per_step = [], [], []
    for _ in range(steps):
        before = read_counts()
        t0 = time.perf_counter()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
        losses.append({k: float(v) for k, v in loss.items()})
        grads = row_block_grads(state.model)
        bad = [n for n, g in grads if g is None or not bool(torch.isfinite(g).all())
               or not bool((g != 0).any())]
        if len(grads) != 66 * 11 or bad:
            fail(f"{impl}: row-block gradients: {len(grads)} found, missing, non-finite "
                 f"or all zero: {bad[:5]}")
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: per_kernel.get(k, 0) for k in launches}
    log(f"train path {impl}: launches per step {per_step}")
    if any(c != want for c in per_step):
        fail(f"{impl}: expected launches {want} per step, got {per_step}")
    for i, l in enumerate(losses):
        log(f"  step {i + 1}: total_loss {l['total_loss']:.6f} grad_norm "
            f"{l['grad_norm']:.6f} ({times[i]:.4f} s)")
    if not all(math.isfinite(v) for l in losses for v in l.values()):
        fail(f"{impl}: non-finite loss or grad_norm")
    if impl == "pallas" and not losses[-1]["total_loss"] < losses[0]["total_loss"]:
        fail(f"the loss did not fall on the fixed batch: {losses[0]['total_loss']} -> "
             f"{losses[-1]['total_loss']}")
    best = min(times)
    rate = TRAIN_BATCH * TRAIN_SECONDS / best
    log(f"train path {impl}: {steps} steps of {TRAIN_BATCH} x {TRAIN_SECONDS} s, "
        f"best {best * 1e3:.3f} ms/step (warm-up {warm_s:.3f} s): {rate:.4f} "
        f"audio-s trained per s on {gpu}; peak memory {peak_gb:.3f} GB")

    prof = profile_step(torch, lambda: step(state, mix, targets), groups)
    res = {"launches": launches, "per_step": per_step, "step_s": times,
           "warmup_s": warm_s, "best_ms_per_step": best * 1e3,
           "audio_s_trained_per_s": rate, "peak_mem_gb": peak_gb, "losses": losses,
           "profile": prof}
    if impl != "pallas":
        return res
    # the same step profiled with CPU activity too, so that idle shares read
    # under either setting can be compared within one run
    res["profile_cpu_cuda"] = profile_step(torch, lambda: step(state, mix, targets), groups,
                                           cpu=True)
    reset_counts()
    ev = eval_step(state, mix, targets)
    torch.cuda.synchronize()
    ev_launches = read_counts()
    log(f"eval step: total_loss {float(ev['total_loss']):.6f}, launches {ev_launches}")
    want = {k: (66 if k == "B1" else 0) for k in ev_launches}
    if ev_launches != want or not math.isfinite(float(ev["total_loss"])):
        fail(f"eval step: expected launches {want} and a finite loss, got {ev_launches}")
    res["eval_loss"] = float(ev["total_loss"])
    return res


def device_kernels(prof):
    """(name, device ms, count) of every device activity in a
    torch.profiler trace, longest first, and the device ms of the user
    annotations (record_function ranges, such as the optimizer's), which
    span kernels already counted and are left out of the busy time."""
    kernels, annotation_ms = [], 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
            if getattr(e, "is_user_annotation", False):
                annotation_ms += us / 1e3
            else:
                kernels.append((e.key, us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return kernels, annotation_ms


def profile_step(torch, run, groups, cpu: bool = False):
    """Device time by kernel over one train step (torch.profiler, CUDA
    activity only: the "pallas_attn" step issues some 150 k launches, and
    the profiler's post-processing of their CPU ops as well takes minutes;
    ``cpu`` records CPU activity too), summed by the
    kernel groups of ``groups``, and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, annotation_ms = device_kernels(prof)
    busy_ms = sum(k[1] for k in kernels)
    by_group = {g: sum(k[1] for k in kernels if any(n in k[0] for n in names))
                for g, names in groups.items()}
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "annotation_ms": annotation_ms, "by_kernel_group_ms": by_group,
           "top": [{"name": k[0][:120], "ms": k[1], "count": k[2]} for k in kernels[:25]]}
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
        return res
    log(f"profile ({'CPU + CUDA' if cpu else 'CUDA'} activity): one train step, wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {res['idle_share']:.4f} (user annotations left out: "
        f"{annotation_ms:.3f} ms); " + ", ".join(
            f"{g} {v:.3f} ms" for g, v in by_group.items()))
    for k in kernels[:14]:
        log(f"  {k[1]:10.3f} ms  x{k[2]:<5d} {k[0][:90]}")
    return res


def phase_train_routes(torch, np):
    """One train step through each kernel route ("pallas", "pallas_attn")
    and through the plain route (attention_impl="xla", autograd through
    plain PyTorch), same weights and batch: for each kernel route the loss
    within 1e-2 relative of the plain route's, the flattened gradients at a
    cosine similarity of at least 0.99."""
    mix, targets = train_batch(torch, np)
    res = {}
    grads = {}
    for impl in ("pallas", "pallas_attn", "xla"):
        state, step = make_trainer(torch, impl)[:2]
        torch.cuda.reset_peak_memory_stats()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        grads[impl] = torch.cat([p.grad.flatten() for p in state.model.parameters()])
        res[impl] = {"total_loss": float(loss["total_loss"]),
                     "grad_norm": float(loss["grad_norm"]),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state, step
        torch.cuda.empty_cache()
    b = grads["xla"].double()
    for impl in ("pallas", "pallas_attn"):
        a = grads[impl].double()
        cos = float((a @ b) / (a.norm() * b.norm()))
        rel = abs(res[impl]["total_loss"] - res["xla"]["total_loss"]) / \
            abs(res["xla"]["total_loss"])
        res[impl].update(grad_cosine=cos, loss_rel=rel)
        log(f"train step, route {impl} vs plain route: loss {res[impl]['total_loss']:.6f} "
            f"vs {res['xla']['total_loss']:.6f} (rel {rel:.2e}, limit 1e-2), grad_norm "
            f"{res[impl]['grad_norm']:.6f} vs {res['xla']['grad_norm']:.6f}, gradient "
            f"cosine {cos:.6f} (min 0.99); peak memory {res[impl]['peak_mem_gb']:.3f} vs "
            f"{res['xla']['peak_mem_gb']:.3f} GB")
        if not (rel <= 1e-2 and cos >= 0.99):
            fail(f"route {impl} vs plain route: loss rel {rel}, gradient cosine {cos}")
    return res


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


def counters():
    """The launch counter of every kernel wrapper, by kernel."""
    from tfswa_tpu_torch.ops.fused_block import (fused_row_block, fused_row_block_bwd,
                                                 fused_row_block_int8, fused_row_block_train)
    from tfswa_tpu_torch.ops.lab_block import lab_row_block
    from tfswa_tpu_torch.ops.row_attention import flash_row_attention

    return {"B1": fused_row_block, "B1-train": fused_row_block_train,
            "B2": fused_row_block_bwd, "B3": fused_row_block_int8, "B4": flash_row_attention,
            "L": lab_row_block}


def reset_counts() -> None:
    for c in counters().values():
        c.launches = 0


def read_counts():
    return {k: c.launches for k, c in counters().items()}


# the kernel each serving route runs, and the device kernels it is made of
# (names as torch.profiler reports them)
ROUTES = {
    "pallas": ("B1", ("ln_qkv_kernel", "k_norm_kernel", "attn_kernel", "post_kernel")),
    "pallas_int8": ("B3", ("ln_qkv_kernel", "qk_scale_kernel", "k_norm_kernel", "attn_kernel",
                           "post_kernel")),
    "pallas_attn": ("B4", ("proj_kernel", "bilinear_attn_kernel")),
}


# separations of the 120 s track timed after the warm-up, per route: B4's
# route takes about 18 s a separation, and its device is busy 99 % of it
SERVING_RUNS = {"pallas": 3, "pallas_int8": 3, "pallas_attn": 1}


def phase_main_path(torch, np, gpu: str, impl: str):
    """The serving main path through one route: a warm-up separation of the
    120 s track, a counted one (every launch counter set to 0 just before
    and read just after: the route's kernel 66 times a model forward, no
    other kernel), and more for the rate (SERVING_RUNS in all)."""
    kernel = ROUTES[impl][0]
    sep = make_separator(torch, impl)
    forwards = []
    sep.model.register_forward_pre_hook(lambda m, a: forwards.append(a[0].shape[0]))
    track_s = 120.0
    audio = synthetic_track(np, track_s, sep.sample_rate)

    t0 = time.perf_counter()
    sep.separate(audio)                                  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    forwards.clear()
    reset_counts()
    t0 = time.perf_counter()
    out = sep.separate(audio)                            # the counted run
    runs = [time.perf_counter() - t0]
    counts, n_forwards = read_counts(), len(forwards)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for _ in range(SERVING_RUNS[impl] - 1):
        t0 = time.perf_counter()
        out = sep.separate(audio)
        runs.append(time.perf_counter() - t0)

    for name, wav in out.items():
        if wav.shape != (1, audio.size) or not np.isfinite(wav).all():
            fail(f"{impl}: stem {name}: shape {wav.shape} or non-finite values")
        if not np.abs(wav).max() > 0:
            fail(f"{impl}: stem {name} is silent")
    log(f"main path {impl}: {n_forwards} model forwards of batch {forwards[:n_forwards]}, "
        f"launches {counts}")
    want = {k: (66 * n_forwards if k == kernel else 0) for k in counts}
    if n_forwards != 2 or counts != want:
        fail(f"{impl}: expected 2 forwards and launches {want}, got {n_forwards} and "
             f"{counts}")
    rate = track_s / min(runs)
    log(f"main path {impl}: 120 s track in {[round(r, 4) for r in runs]} s (warm-up "
        f"{warm_s:.3f} s): {rate:.4f} audio-s/s on {gpu}; peak memory {peak_gb:.3f} GB")
    return {"impl": impl, "launches": counts[kernel], "counts": counts,
            "forwards": n_forwards, "runs_s": runs, "warmup_s": warm_s,
            "audio_s_per_s": rate, "peak_mem_gb": peak_gb}, sep


def phase_profile(torch, np, sep, impl: str):
    """Device time by kernel over one separation of the 120 s track
    (torch.profiler, CUDA activity), and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    audio = synthetic_track(np, 120.0, sep.sample_rate)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sep.separate(audio)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, annotation_ms = device_kernels(prof)
    busy_ms = sum(k[1] for k in kernels)
    kernel, names = ROUTES[impl]
    by_name = {n: sum(k[1] for k in kernels if n in k[0] and not
                      (n == "attn_kernel" and "bilinear" in k[0])) for n in names}
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
           "annotation_ms": annotation_ms, "kernel_ms": by_name,
           "top": [{"name": k[0][:120], "ms": k[1], "count": k[2]} for k in kernels[:25]]}
    if not busy_ms:
        log("profile: the profiler recorded no device time (not measured)")
        return res
    log(f"profile {impl}: one 120 s separation, wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {res['idle_share']:.4f} (user annotations left "
        f"out: {annotation_ms:.3f} ms)")
    log(f"profile {impl}: {kernel} launches " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in by_name.items()))
    for k in kernels[:12]:
        log(f"  {k[1]:10.3f} ms  x{k[2]:<5d} {k[0][:90]}")
    return res


def phase_routes(torch, np, sep_kernel, impl: str, against):
    """One 10 s segment through the kernel route ``impl`` and through each
    route of ``against`` (same weights): the SNR per stem.  The plain route
    ("xla") is held to SNR_MIN_DB; the others are recorded."""
    seg = synthetic_track(np, 10.0, sep_kernel.sample_rate)[None]
    res = {}
    with torch.inference_mode():
        x = torch.from_numpy(seg).cuda()
        a = sep_kernel._separate_core(x).double().cpu().numpy()
        for other in against:
            sep_other = make_separator(torch, other)
            sep_other.model.load_state_dict(sep_kernel.model.state_dict())
            b = sep_other._separate_core(x).double().cpu().numpy()
            snrs = [float(10 * np.log10(np.sum(b[:, s] ** 2) / np.sum((a[:, s] - b[:, s]) ** 2)))
                    for s in range(a.shape[1])]
            log(f"route {impl} vs route {other}, one 10 s segment: SNR per stem "
                f"{[round(v, 3) for v in snrs]} dB"
                + (f" (min {SNR_MIN_DB} dB)" if other == "xla" else " (recorded)"))
            if not np.isfinite(a).all() or (other == "xla" and min(snrs) < SNR_MIN_DB):
                fail(f"route {impl} vs route {other}: SNR {snrs} below {SNR_MIN_DB} dB")
            res[other] = snrs
            del sep_other
    return res


def phase_serving(torch, np, gpu: str, totals):
    """Phases 4 and 5 for every serving route."""
    res = {}
    for impl, against in (("pallas", ("xla",)), ("pallas_int8", ("xla", "pallas")),
                          ("pallas_attn", ("xla",))):
        t0 = time.perf_counter()
        main_path, sep = phase_main_path(torch, np, gpu, impl)
        main_path["profile"] = phase_profile(torch, np, sep, impl)
        main_path["route_snr_db"] = phase_routes(torch, np, sep, impl, against)
        t = totals[ROUTES[impl][0]]
        log(f"per model forward (66 calls), {ROUTES[impl][0]}: kernel_ms {t['ms']:.3f} "
            f"plain_ms {t['plain_ms']:.3f} library_ms "
            + ("none" if t["library_ms"] is None else f"{t['library_ms']:.3f}")
            + f" bound_ms {t['bound_ms']:.4f}")
        main_path["phase_s"] = time.perf_counter() - t0
        log(f"serving route {impl}: {main_path['phase_s']:.1f} s")
        res[impl] = main_path
        del sep
        torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel checks only")
    ap.add_argument("--plant", choices=sorted(PLANTS),
                    help="plant a fault in a copy of B2's source and run only the "
                         "B1-train / B2 checks: exit 0 if they catch it, 1 if not")
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

    global MUFU_RATE
    MUFU_RATE = mufu_rate(torch)
    log(f"exp2 (MUFU) rate {MUFU_RATE:.4e} /s")
    t0 = time.perf_counter()
    _build.build(["fused_block", "fused_block_bwd", "row_attention"])
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s")
    ptxas = [f"{name}: {line.strip()}" for name, report in _build.ptxas_report.items()
             for line in report.splitlines() if "Used" in line or "spill" in line]
    regs = [int(line.split("Used ")[1].split()[0]) for line in ptxas if "Used " in line]
    spills, fn = [], ""
    for name, report in _build.ptxas_report.items():
        for line in report.splitlines():
            if "Function properties for" in line:
                fn = line.split("for ")[-1].strip()
            elif "spill" in line and " 0 bytes spill stores" not in line:
                spills.append(f"{name}: {fn}: {line.strip()}")
    log(f"  ptxas: {len(regs)} kernels, registers {min(regs, default=0)}-"
        f"{max(regs, default=0)}, {len(spills)} with spills (all lines in chip_smoke.json)")
    for line in spills:
        log(f"  {line}")
    hmma = sass_hmma_check()

    if args.plant:
        plant_fault(torch, args.plant)
        try:
            phase_train_kernels(torch, True)
        except SystemExit:
            log(f"planted fault {args.plant}: caught by the B2 check")
            sys.exit(0)
        fail(f"planted fault {args.plant}: the B2 check passed it")

    phase_s = {"build": build_s}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        r = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return r

    shapes, max_err, totals = timed("B1 kernels", phase_kernels, torch, args.quick)
    lab_shapes, lab_err, lab_totals, lab_path = timed("kernel lab", phase_lab, torch,
                                                      args.quick, shapes)
    i8_shapes, i8_err, i8_totals = timed("B3 kernels", phase_int8_kernels, torch, args.quick,
                                         shapes)
    at_shapes, at_err, at_totals = timed("B4 kernels", phase_attn_kernels, torch, args.quick)
    results = {"gpu": gpu, "build_s": build_s, "ptxas": ptxas, "spills": spills,
               "sass_hmma": hmma, "mufu_rate": MUFU_RATE,
               "phase_s": phase_s, "shapes": shapes, "totals": totals,
               "int8_shapes": i8_shapes, "int8_totals": i8_totals,
               "attn_shapes": at_shapes, "attn_totals": at_totals, "lab_shapes": lab_shapes,
               "lab_totals": lab_totals, "lab_path": lab_path}
    serving = {impl: {"launches": None} for impl in ROUTES}
    if not args.quick:
        serving = timed("serving", phase_serving, torch, np, gpu,
                        {"B1": totals, "B3": i8_totals, "B4": at_totals})
        results["serving"] = serving
    t_shapes, t_err, t_totals = timed("B1-train/B2 kernels", phase_train_kernels, torch,
                                      args.quick)
    results.update(train_shapes=t_shapes, train_totals=t_totals)
    train = {"launches": {}}
    if not args.quick:
        train = timed("train pallas", phase_train, torch, np, gpu)
        results["train_path"] = train
        results["train_path_attn"] = timed("train pallas_attn", phase_train, torch, np, gpu,
                                           "pallas_attn")
        results["train_routes"] = timed("train routes", phase_train_routes, torch, np)
        for kind, label in (("train", "B1-train"), ("bwd", "B2")):
            log(f"per train step (66 calls), {label}: kernel_ms {{ms:.3f}} plain_ms "
                f"{{plain_ms:.3f}} library_ms {{library_ms:.3f}} bound_ms "
                f"{{bound_ms:.4f}}".format(**t_totals[kind]))
    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    timed = not args.quick

    def entry(name, source, replaces, launches, err, tot):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err,
            "ms": tot["ms"] if timed else None,
            "plain_ms": tot["plain_ms"] if timed else None,
            "bound_ms": tot["bound_ms"] if timed else None,
            "bound_by": ("bytes" if tot["bound_bytes_ms"] * 2 >= tot["bound_ms"]
                         else "operations") if timed else None,
            "library_ms": tot["library_ms"] if timed else None,
        }

    fwd_src = "tfswa_tpu_torch/csrc/fused_block.cu"
    kernels = [
        entry("fused_row_block", fwd_src, "tfswa_tpu/ops/pallas/fused_block.py:140",
              serving["pallas"]["launches"], max_err, totals),
        entry("fused_row_block_train", fwd_src, "tfswa_tpu/ops/pallas/fused_block.py:140",
              train["launches"].get("B1-train"), t_err["train"], t_totals["train"]),
        entry("fused_row_block_bwd", "tfswa_tpu_torch/csrc/fused_block_bwd.cu",
              "tfswa_tpu/ops/pallas/fused_block.py:526",
              train["launches"].get("B2"), t_err["bwd"], t_totals["bwd"]),
        entry("fused_row_block_int8", fwd_src, "tfswa_tpu/ops/pallas/fused_block.py:253",
              serving["pallas_int8"]["launches"], i8_err, i8_totals),
        entry("flash_row_attention", "tfswa_tpu_torch/csrc/row_attention.cu",
              "tfswa_tpu/ops/pallas/row_attention.py:53",
              serving["pallas_attn"]["launches"], at_err, at_totals),
        # the full form's numbers (B1's function through the lab's entry);
        # the stage and flag forms' are in chip_smoke.json
        entry("kernel_lab", fwd_src, "tools/kernel_lab.py:101", lab_path["launches"], lab_err,
              dict(lab_totals["full"], library_ms=totals["library_ms"])),
    ]
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
