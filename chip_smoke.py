#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tfswa_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # the whole run (a few minutes on an H100)
    python3 chip_smoke.py --quick   # build + kernel-vs-plain checks only

Six kernels: B1 (fused_row_block, the serving forward), B1-train
(fused_row_block_train, the forward that also exports mid, acc, den), B2
(fused_row_block_bwd, the whole-block VJP), B3 (fused_row_block_int8, the
serving forward with int8 scores, route "pallas_int8"), B4
(flash_row_attention, the bilinear row attention, route "pallas_attn") and
L (lab_row_block, the kernel lab's stage and flag forms of B1); and the
f32 forms of B1, B1-train, B2, B3 and B4 (csrc/*_f32*: products in
3xTF32 on the tensor cores, B4's q|k and scores f64 on the FP64 tensor
cores; counted apart as
"<kernel>-f32").  Every kernel takes any width C a multiple of 8
up to 512 and any head count dividing it: phases 2-15 run the flagship's
widths, phase 16 the others (wide384, WIDE384, and an edge grid).
Phases, each of which fails the run (exit code 1) when it fails:
  1. the card's name and power limit; build of the CUDA sources (nvcc, sm_90a,
     one nvcc per source, in parallel); the SASS of every instantiation of
     the launches whose products run on the tensor cores (B1's ln_qkv_kernel,
     attn_kernel, attn_wide_kernel and post_kernel, B2's mlp_bwd_kernel,
     attn_bwd_q_kernel, attn_bwd_kv_kernel, their _wide forms,
     ln1_bwd_kernel and atb_kernel, B4's proj_kernel, bilinear_attn_kernel
     and bilinear_attn_any_kernel) must hold HMMA instructions, and
     B3's int8 forms of attn_kernel and attn_wide_kernel IMMA (cuobjdump
     --dump-sass of the built libraries); in the f32 libraries every
     product kernel (gemm_kernel, atb_kernel) and every tensor-core
     attention kernel HMMA with TF32 operands (3xTF32), B3's f32 scores
     IMMA, the attention's FMA-chain scores and the forms for a head of at
     most 8 channels FFMA, B4's f32 qkv_kernel and attn_kernel DMMA (and
     no t_kernel), each function one of the port's (no library kernel);
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
     CLI (tfswa_tpu_torch.tools.kernel_lab --ablate, then --check)
     through its main in this process, whose lab launches are counted;
 2b. the kernel lab's f32 forms (L f32, csrc/fused_block_f32.cu), also
     under --quick: the 9 forms against their plain f32 versions (fed the
     kernel's q|k|v) on 64 rows under the 3 kinds of weights at the 12
     shapes, at wide384's 12 (D = 12-96) and at LAB_F32_EDGE's (C, H) at N
     = 64 and 129 (D = 3, 4, 8, 16, 32, 64, 128), within 1e-4 x
     max(max|ref| / 4, 1), the full form equal to B1 f32 bit for bit (no
     clamp: the attention outputs non-finite where f64 decides that they
     overflow, and the block output non-finite where the plain one is, but
     in tokens that hold an undecided attention element); each form timed at the full row
     counts with bound and plain times; then the CLI with --dtype float32
     (--ablate --iters 2 --shapes enc0, then --check) through its main in
     this process, whose f32 lab launches are counted.  --plant lab_f32_score_bf16 (the
     kernel ignores score_bf16) runs only those checks of score_bf16 and
     exits 0 when they miss wherever the rounding moves the output past the
     limit;
  3. B3 the same way (the plain version gets the kernel's q|k|v; the int8 q
     and k and the row scales must agree exactly; its attention launch timed
     beside its bound), and B4 (on LN1 output;
     the plain version gets the kernel's t and v; its output and its
     attention output before the out-projection within 4 bf16 ULP), B4's
     checks also at the 4 training (N, C) that no serving shape has, since
     the "pallas_attn" train step runs B4 there; B4's launches (its two
     projections, its attention) timed from a profiler trace with bounds;
 3b. also under --quick, non-finite inputs: B1, B3 and B4 at the stage-0
     and stage-3 serving (N, C), B1-train and B2 at the stage-0 and stage-3
     training (N, C), bf16 and f32, each on 4 rows of which one holds a
     token of the card's NaN (0x7fffffff; bf16 0x7fff), a token of +inf, or
     (the overflow case) k's channels 0 and 1 of head 0 at +inf and -inf in
     every token while q's are finite (each q.k inf - inf; B4: scores past
     f32's range), and (nan_k) a weight of k at that NaN: each output
     non-finite exactly where its plain version's is, the plain B1,
     B1-train and B2 non-finite somewhere in the overflow and nan_k
     cases.  --plant fminf_clamp
     (exp2_line's clamp on fminf, which turns a NaN score into 110) runs
     only this phase and exits 0 when it misses B1's overflow case at every
     serving shape;
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
     beside their bounds; then, also under --quick, the same checks of
     B1-train and B2 at each (N, C) of configs/musdb_repro.yaml's train
     steps (crop_pow2, 5.938 s: F = 1024, T = 512), and phase 2's checks of
     B1 at each (N, C) of its validation and SDR evaluation (F = 1025,
     T = 862), that the training and serving shapes lack;
  7. the training main path: the flagship model in train mode through
     make_train_step (TrainConfig defaults) on a fixed batch of 4 x 6 s from
     the port's SyntheticDataset: a warm-up step and 5 timed steps, each
     with 66 B1-train and 66 B2 launches and no serving launch, finite
     non-zero gradients for every row-block parameter, a falling loss; one
     profiled step; make_eval_step with 66 serving launches; then the same
     model through "pallas_attn" on the first segment: a warm-up step
     and 1 timed step with 66 B4 launches and no other kernel, finite
     non-zero gradients;
  8. one train step through each kernel route ("pallas", "pallas_attn")
     against the plain route (same weights, the first 2 of phase 7's
     segments): loss and gradient cosine;
  9. remat against no remat on phase 7's fixed batch: one step each from
     the same weights (loss within 1e-3 rel., gradient cosine >= 0.999,
     equal num_batches_tracked, running stats within 1e-3 rel.; 132
     B1-train + 66 B2 launches with remat, 66 + 66 without), two more
     timed steps each and the peak memory of each;
 10. the training entry point, python -m tfswa_tpu_torch.cli.train on
     configs/musdb_repro.yaml and the synthetic set, in a subprocess: 2
     epochs of 4 steps, then a third resumed from latest (the restored
     state equal to the saved one, global_step 12); the launches counted
     inside the trainer's steps (B1-train, B2), validation and SDR
     evaluation (B1) against the design, and the (N, C) of every launch
     there, which must be the recipe's and checked in phase 6; a track
     that fails in the SDR evaluation fails the run; finite train / val /
     sdr records, the checkpoint layout; the best checkpoint served through
     "pallas"; peak GB.  It runs beside phase 14's subprocesses (and
     phase 11, which serves its checkpoint, after phase 14), so its step
     and SDR-evaluation times are recorded as taken under their load and
     give no training rate;
 11. the serving and evaluation entry points: separate_stream of three
     synthetic tracks (120, 75 and 8 s; the last through separate()) with
     two in flight, the flagship model through "pallas" at the fast serving
     knobs: each result equal to its own separate() bit for bit, 66 B1
     launches a forward and no other kernel, audio-s/s of the stream
     against the separate() calls one at a time, the idle share and the
     host's waits on the card in one profiled stream; the 120 s track
     through the int8 output codec, within one int8 step of each stem's
     peak of the float32 transfers, with the float16 run, their rates and
     the bytes each sends back; python -m tfswa_tpu_torch.cli.separate on
     phase 10's checkpoint directory (its best/), --preset fast, a 120 s
     WAV at 44.1 kHz and a 30 s one at 48 kHz, with --stream and through
     BatchSeparator: PCM16 stems at 44.1 kHz as long as the resampled
     inputs, the two runs within one PCM16 step, B1's launches as designed
     at checked (N, C); python -m tfswa_tpu_torch.cli.evaluate on 2
     synthetic tracks and on a custom dataset of 2: every track in
     results.json (a track the evaluator skips fails the run), finite
     metrics and aggregate, launches as designed (the four CLIs at once);
     then the MR-STFT train step on the first 2 of phase 7's segments
     (MRSTFT_SEGMENTS) through "pallas" against
     the plain route in
     float32 at phase 8's limits (the plain route in bf16 recorded beside
     it), 66 B1-train + 66 B2 launches a step, ms a step and peak GB;
     phase 10's checkpoints are deleted after it;
 12. the model's options and the deployment path (flagship, conditioned
     weights: seed 0, convs x0.4 and BatchNorm statistics from the seed, so
     that the sigmoid head does not saturate): (a) use_shift_mask=True
     through "pallas" on 4 x 10 s segments, 55 B1 launches and no other
     kernel, ms and peak GB against the unmasked forward (the extra peak
     under a quarter of the 0.91 GB a dense mask would take), the route
     SNR against the plain route (as phase 5) and the output moved by the
     mask; (b) dropout 0.1: eval bit-identical to dropout 0 (66 B1), one
     train step on the first 3 s of the first of phase 7's 4 segments (the plain route is
     host-bound: 21-24 s a step at all 4 on an H100) with no kernel launch,
     finite non-zero row-block gradients, the loss equal bit for bit across
     two runs, remat within 1e-3 rel. and cosine >= 0.999; (c)
     quantize_dynamic(compute="int8"): all 264 torch._int_mm products of a
     forward equal to their plain f32-of-int8 version and the forward equal
     to the plain-product forward bit for bit, compare_models against f32,
     quantize_static on 2 batches (every scale > 0, static vs dynamic
     within 0.05), a 60 s track through "int8" (rate, SNR vs "pallas") and
     tfswa_tpu_torch.tools.bench_int8 --seconds 3 --iters 1 in this process
     (the rate against bf16 "pallas"); (d)
     fold_batch_norms: float32 plain route within 1e-4 rel., bf16 "pallas"
     at SNR >= 30 dB with 66 B1, benchmark_model of both; (e) export at
     (1, 4, 1025, 87) of the float32 plain route at depths (1, 1, 1, 1)
     (full widths): torch.export and TorchScript saved, loaded, within 1e-4,
     ONNX bytes or the reason, the reference .pt served back equal,
     export_model_info's count (the kernel routes' exports: phase 15 (d));
     (f) trace with an
     annotation, detect_chip() == "h100", flops_of a plain forward, MFU;
 13. the multi-GPU path on the one card (tfswa_tpu_torch/parallel): (a) world
     size 1 over NCCL, mesh (1, 1): make_sharded_train_step for 3 steps
     against make_train_step from the same state, loss and parameters bit
     for bit, at configs/musdb_repro.yaml's aligned 4 x 5.938 s (crop_pow2,
     F = 1024, T = 512: no decoder resize, so the plain step is
     reproducible under cudnn.deterministic; at 4 x 6 s the resizes'
     backward sums with atomics, and the plain step's own run-to-run spread
     is recorded beside the sharded one's), its collectives a step from a
     trace (2 x 52 BatchNorms + gradients + losses), ms a step beside phase
     7's, its MFU; the 120 s track through SourceSeparator(mesh=(1, 1))
     against the plain separator bit for bit, audio-s/s beside phase 4's;
     (b) two ranks spawned on the one card over gloo with CUDA tensors
     (each with a timeout), clip + SGD, at crop_pow2 under
     cudnn.deterministic (where one process reproduces itself): at (2, 1)
     2 train steps of a global 4 x 5.938 s and at (1, 2) of a global
     2 x 5.938 s through "pallas" in bf16, and at (2, 1) 2 steps of a
     global 2 x 1.0101 s (T = 88) through the plain route in float32; each
     against one process on the same batch: loss within 1e-3 rel., each
     parameter's update at cosine >= 0.999 (held at (1, 2) and in float32,
     every leaf but the 118 whose gradient is 0 in exact arithmetic, those
     within 1e-2 of the largest update element; at (2, 1) in bf16 recorded:
     each rank rounds its half-batch weight gradients to bf16 before the
     sum, which moves the leaves where the halves cancel), a 30 s track's
     stems at SNR >= 60 dB, and per rank 66 B1-train + 66 B2 launches a
     step on half the rows at (2, 1) and on whole rows at (1, 2), the
     collectives of a step from its trace, ms a step (two ranks share one
     card: no measure of scaling);
 14. the quality tools (tfswa_tpu_torch/tools): (a), also under --quick,
     B1-train and B2 against their plain versions at each (N, C) of the
     quality A/B's train steps (2 s segments at F = 1025: T = 173), and B1
     at each of its validation and SDR evaluation, that no earlier check
     covered ((173, 32), (86, 64), (43, 128), (21, 256)), at phase 6's
     limits; (b) python -m tfswa_tpu_torch.tools.sdr_baseline, untrained,
     in a subprocess beside (c): finite SDR; (c) python -m tfswa_tpu_torch.tools.
     quality_ab --arms direct --epochs 1 in a subprocess (its training CLI
     through phase 10's counters): 60 steps of 132 B1-train + 66 B2, one
     validation and one SDR evaluation of B1 launches as designed, each
     at a checked (N, C), and the step-60 val loss at most 0.55 and sdr/avg
     at least (b)'s + 1.5 dB (guard rails against a port that does not
     learn); (d) that trained checkpoint through overlap_ab's
     overlap_table at overlaps 0.5 and 0.25 (B1's launches as designed,
     finite SDRs), one 10 s segment through "pallas" against the plain
     route at SNR >= 30 dB a stem with the share of unsaturated head
     outputs, and tools/visualize at the flagship, whose total must be the
     model's 15,408,036 parameters; the checkpoints are deleted after it;
 15. the f32 forms and the remaining options (the flagship in float32,
     TF32 off): (a), after phase 14 (a), each f32 kernel against its plain
     f32 version on 64 rows at the 12 serving (N, C) (B1, B3, B4) and the
     12 training (N, C) (B1-train, B2), flat and clamp weights: outputs,
     q|k|v and mid within 1e-4 x max(max|ref| / 4, 1), den 1e-4 rel., B3's
     int8 q, k and scales exact, B2's dx and gradients within 1e-4 of each
     leaf's max and twice bit for bit, B4 against its f64 function (at the
     plain f32 version's distance where that is larger); kernel / plain /
     library (f32) ms at the full row counts with the bound (3xTF32's
     rate, B4's f64 parts the FP64 tensor cores'; FFMA's and DFMA's
     beside), and each f32 form's launches timed apart (a profiler trace
     opened by a warm-up step); then, after phase 14: (b) the 120 s track
     through "pallas" in f32 (132 f32 B1 launches, nothing else), its
     audio-s/s, and one 10 s segment through "pallas", "pallas_int8" and
     "pallas_attn" (66 f32 launches of the route's kernel each) against
     the f32 plain route at SNR >= 70 dB a stem, on conditioned weights;
     (c) one f32 train step through "pallas" on 2 x 6 s without remat (66
     f32 B1-train + 66 f32 B2) against the plain route's: loss within
     1e-5 rel., gradient cosine >= 0.99999, each row-block leaf >= 0.9999
     (but the leaves whose gradient is 0 in exact arithmetic), ms and peak
     GB; (d) the .pt2 and TorchScript exports of the three kernel routes
     at depths (1, 1, 1, 1), each loaded back: 21 launches of its f32
     kernel a forward and equal to the model bit for bit; (e)
     param_dtype="bfloat16" with bf16 compute through "pallas": two steps,
     falling loss, every parameter, gradient and Adam moment bf16; (f) one
     "dots" remat step against the no-remat step (phase 9's limits), 132
     + 66 launches, the peak GB of each;
 15b. the measuring tools (tfswa_tpu_torch/tools: forward_ablation,
     bench_pipeline, bench_train_ablate, bench_train, geom_probe,
     bench_ola_windows, bench_device_rate, bench_block --check,
     bench_attention), each through its CLI's main in this process at the
     flagship's full width and minimal repeats (TOOL_RUNS): exit 0, finite
     positive times and rates, and their kernel launches the model's (66 B1
     a forward, none with the row blocks as identity, 132 B1-train + 66 B2
     a step with remat, one B1 or B4 a timed call);
 15c. python -m tfswa_tpu_torch.bench (the counterpart of the root
     bench.py) through its main in this process at its defaults: exit 0, a
     JSON line whose value, vs_baseline, stream_value and device_only_value
     are finite and positive, runs_s 5 times, health tags "ok" or
     "degraded_sample", 132 B1 launches a separation and no other kernel,
     this card's name and power limit, and value within 10 % of phase 4's
     "pallas" rate;
 16. every width (wide384: the flagship but dims (48, 96, 192, 384) and 4
     heads, D = 12, 24, 48, 96; and EDGE_GRID): (a), also under --quick (in
     the whole run beside phase 14's two subprocesses, which wait on the
     host, with phase 12 (e) and phase 15 (d): beside_quality), each kernel
     against its plain version at the limits of phases 2-15
     (B1, B3, B4, L's full form and 5 cuts and the f32 B1, B3, B4 at the 12
     (N, C) of wide384's serving path; B1-train, B2 and their f32 forms at
     the 12 of its training path; all but L at each (C, H) of EDGE_GRID at
     N = 64 with an MLP of 2 C and N = 129 with 4 C + 8), every check held
     and logged before a miss fails the run, and the registers and spill
     bytes of every new instantiation from ptxas; (b) wide384 in bf16: the
     120 s track through each serving route (66 launches of its kernel a
     forward and none of another; best of SERVING_RUNS after a warm-up,
     as phase 4), one profiled separation ("pallas"),
     and one 10 s segment against the plain route at SNR >= 30 dB a stem
     (B3 also against B1's route); (c) wide384 in f32 (conditioned
     weights): phase 15 (b) (the 120 s track through "pallas", one 10 s
     segment a route at >= 70 dB against the f32 plain route); (d) its
     train step on 2 x 6 s, no remat: bf16 through "pallas" (66 B1-train +
     66 B2, loss 1e-2 rel. and gradient cosine 0.99 against the plain
     route, finite non-zero row-block gradients, ms and peak GB), f32 at
     phase 15 (c)'s limits, and one "pallas_attn" bf16 step on 1 segment;
     (e) each kernel at wide384's full row counts: ms a forward or step,
     bound, library and plain (256 rows a shape, scaled) times;
 17. a JSON line of the kernels (the f32 forms and wide384's rows as their
     own entries), then the last line {"ok": true, "device": {...}}.
Long results go to chiprun_out/chip_smoke.json.  Without a CUDA device, or
outside a checkout of the repository, the run exits non-zero with no result.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    """Device ms a call of ``fn``, over ``reps`` calls after one warm-up
    call."""
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


def card_randn(torch, shape, gen):
    """Standard normal values of ``shape`` made on the card, by a CUDA
    generator seeded from the host generator ``gen``: the rows of a timing
    at the full row counts (226 M values a stage-0 shape), which the host's
    generator takes seconds to draw."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.randn(shape, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed))


def _bound(nbytes: float, flops: float, exp2: float, int8_ops: float = 0.0):
    """The larger of bytes over the HBM rate, the tensor-core time (bf16
    FLOPs over the bf16 peak plus int8 operations over the int8 peak) and
    exp2 over the MUFU rate, in ms, and which of bytes or operations it
    is."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_BF16_FLOPS + int8_ops / PEAK_INT8_OPS, exp2 / MUFU_RATE) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_ms(R: int, N: int, C: int, hidden: int, train: bool = False, int8: bool = False,
             H: int = HEADS):
    """Least time for one B1 (or B1-train, or B3) call: rows in and out
    (B1-train: also mid, acc and den out) plus weights once, in bf16, over
    the HBM rate; the products and scores/AV (bf16 operands) over the bf16
    tensor-core peak, B3's scores (int8 operands) over the int8 peak;
    H*N^2 exp2 per row over the MUFU rate."""
    nbytes = 2 * (2 * R * N * C + 4 * C * C + 2 * C * hidden + 6 * C + hidden)
    if train:
        nbytes += 2 * 2 * R * N * C + 4 * R * H * N
    flops = 2 * R * N * (4 * C * C + 2 * C * hidden) + 2 * R * N * N * C
    scores = 2 * R * N * N * C
    return _bound(nbytes, flops + (0 if int8 else scores), R * H * N * N,
                  scores if int8 else 0)


def bound_attn_ms(R: int, N: int, C: int, H: int = HEADS):
    """Least time for one B4 call: rows in and out (bf16), A (H C^2), Wv and
    Wo (bf16) and the f32 bias once; the products over the bf16 peak (v and
    the out-projection 2 C^2 a token each, t 2 H C^2 a token, the scores
    2 H N^2 C a row, since t is rounded to bf16 and no rank-D shortcut
    computes the same function, and AV 2 N^2 C a row); H*N^2 exp a row
    over the MUFU rate."""
    nbytes = 2 * 2 * R * N * C + 2 * (H + 2) * C * C + 4 * C
    flops = 2 * R * N * (2 * C * C + H * C * C) + 2 * R * N * N * C * (H + 1)
    return _bound(nbytes, flops, R * H * N * N)


def bound_bwd_ms(R: int, N: int, C: int, hidden: int, H: int = HEADS):
    """Least time for one B2 call, the function's floor: rows, mid, acc, g
    in (bf16), den in (f32), weights in, dx out (bf16) and the gradients
    out (f32); the products (q|k|v and fc1 recomputed, which the inputs
    force; the MLP VJP's four, dWo and d_acc, d_normed and dWqkv) and the
    attention's five (scores s and d_p once each, d_q, d_k, d_v); H*N^2
    exp2 per row, once.  The design's second pass over s, d_p and exp2
    (one per attention-backward kernel) is its own cost, not counted."""
    M = R * N
    weights = 4 * C * C + 2 * C * hidden + 6 * C + hidden
    nbytes = 2 * 5 * M * C + 4 * R * H * N + 2 * weights + 4 * weights
    flops = 2 * M * (3 * C * C + C * hidden + 4 * C * hidden + 2 * C * C + 6 * C * C) \
        + 5 * 2 * R * N * N * C
    return _bound(nbytes, flops, R * H * N * N)


def bound_launch_ms(kernel: str, R: int, N: int, C: int, hidden: int, form: str = "B1",
                    H: int = HEADS):
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
        return _bound(2 * M * C + 4 * R * H + (M * C if form == "B3" else 0), 0, 0)
    if kernel == "attn_kernel":
        nbytes = 2 * 4 * M * C + (4 * R * H * N if form == "B1-train" else 0)
        scores, av = 2 * R * N * N * C, 2 * R * N * N * C
        if form == "B3":
            return _bound(nbytes, av, R * H * N * N, scores)
        return _bound(nbytes, scores + av, R * H * N * N)
    if kernel == "mlp_bwd_kernel":
        nbytes = (2 * 3 * M * C + 4 * R * H * N + 2 * (3 * C * hidden + C * C)
                  + 2 * (2 * C + hidden)
                  + 2 * M * (2 * C + 2 * hidden) + 4 * M * C + 2 * 2 * M * C + 4 * M * H
                  + 4 * (4 * C + hidden))
        return _bound(nbytes, 2 * M * (3 * C * hidden + C * C), 0)
    if kernel == "attn_bwd":
        return _bound(2 * 7 * M * C + 4 * M * H, 5 * 2 * R * N * N * C, R * H * N * N)
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
        return _bound(2 * (3 * M * C + H * C * C),
                      2 * M * H * C * C + 2 * R * N * N * C * (H + 1),
                      R * H * N * N)
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
SASS_HMMA = {"fused_block": ("ln_qkv_kernel", "attn_kernel", "attn_wide_kernel", "post_kernel"),
             "fused_block_bwd": ("ln_qkv_kernel", "mlp_bwd_kernel", "attn_bwd_q_kernel",
                                 "attn_bwd_kv_kernel", "attn_bwd_q_wide_kernel",
                                 "attn_bwd_kv_wide_kernel", "ln1_bwd_kernel", "atb_kernel"),
             "row_attention": ("proj_kernel", "bilinear_attn_kernel",
                               "bilinear_attn_any_kernel")}


def lab_cut_form(fn: str) -> bool:
    """Whether a mangled f32 attn_kernel<DC, WIDE, INT8, STAGE, FLAGS> or
    attn_ffma_kernel<DP, STAGE, FLAGS> name is one of the f32 lab's cuts
    (STAGE 1 scores, 2 exp2), which stop before p . v: no tensor-core
    product."""
    return re.search(r"attn_(ffma_)?kernelILi\d+E(?:Lb[01]E)*Li[12]E", fn) is not None


def int8_form(fn: str) -> bool:
    """Whether a mangled attn_kernel<D, WITH_DEN, INT8, ...> (or
    attn_wide_kernel) name is an INT8 (B3) instantiation, whose scores must
    run as IMMA."""
    return re.search(r"attn_(wide_)?kernelILi\d+ELb[01]ELb1E", fn) is not None


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
    activity) of ``reps`` calls.  The trace opens with a warm-up step (one
    call, traced and dropped: the profiler's schedule), so that the device
    tracing is running before the timed calls start; a trace that misses one
    of the kernels is taken again, up to ``tries`` traces; None where the
    last trace still holds no such kernel (not measured; logged with the
    kernels that trace did hold)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                run()
            torch.cuda.synchronize()
            prof.step()
        kernels = device_kernels(prof)[0]
        res = {}
        for n in names:
            hits = [ms for key, ms, _ in kernels if n in key]
            res[n] = sum(hits) / reps if hits else None
        if None not in res.values():
            break
    for n in (n for n, v in res.items() if v is None):
        log(f"  launch_ms: {n} not measured: in none of {tries} traces of {reps} calls; the "
            "last held " + (", ".join(f"{kernel_name_of(k)} x{c}" for k, _, c in kernels)
                            or "no device kernel"))
    return res


def kernel_name_of(key: str) -> str:
    """A profiler key's kernel name without its namespaces and arguments."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1][:80]


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


def check_shape(torch, N: int, C: int, gen, hidden=None, H: int = HEADS):
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
    ``hidden``: the MLP's width (default 4 C); ``H`` the heads.  Returns
    the per-regime results and the flat regime's parameters."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.fused_block import (SCORE_CLAMP, _forward_kernel,
                                                 fused_row_block_reference_parts, unpad_heads)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        run = _forward_kernel(x, p, H)
        got, got_attn, qkv = run.out, run.attn, unpad_heads(run.qkv, C, H)
        torch.cuda.synchronize()
        ref, ref_attn = fused_row_block_reference_parts(x, p, H, qkv=qkv)
        r_qkv = plain_qkv(torch, x, p, H)
        qkv_err = _max_abs(qkv, r_qkv)
        qkv_tol = 2 * bf16_ulp(r_qkv.abs().max().item())
        # recorded: how often each side's f32 sums round q|k|v otherwise
        # than the exact product does
        exact = plain_qkv(torch, x, p, H, torch.float64)
        off_exact = (int((qkv.float() != exact).sum()), int((r_qkv != exact).sum()),
                     exact.numel())
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        tol = 0.0625 * max(scale / 4.0, 1.0)
        a_err = (got_attn.float() - ref_attn.float()).abs().max().item()
        a_scale = ref_attn.float().abs().max().item()
        a_tol = 4 * bf16_ulp(a_scale)
        s_max = max_score(torch, x, p, H)
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
            # drawn on the host from the checks' generator, as the checks'
            # data after it depends on it
            xf = torch.randn(R, N, C, generator=gen).cuda().to(torch.bfloat16)
            # the model's route: the wrapper, through its custom op
            k_ms = cuda_ms(torch, lambda: fused_row_block(xf, p, HEADS), 3)
            # the plain version on PLAIN_ROWS rows, scaled (full rows until PR 14)
            rs = min(R, PLAIN_ROWS)
            pl_ms = cuda_ms(torch, lambda: fused_row_block_reference(xf[:rs], p, HEADS), 1) * R / rs
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
        log(f"per model forward (66 calls), B1 {totals['ms']:.3f} ms")
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
LAB_ITERS, LAB_SHAPES = 2, "enc0"      # 3 iterations until PR 14 (the run's time)
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


def check_lab_shape(torch, N: int, C: int, gen, with_full: bool = False, H: int = HEADS,
                    only=None):
    """The lab forms of LAB_FORMS but "full" (unless ``with_full``: B1's
    own checks do not run at this (N, C)) against their plain versions on
    CHECK_ROWS rows, for each kind of weights in REGIMES.  The plain version gets the
    kernel's own q|k|v (see check_train_shape).  Held: the error within
    lab_limit over the elements both give finite, the same elements
    non-finite in both (noclamp under the clamp regime overflows exp2 past
    a score of 128), and every element finite for the other forms.  The
    exp2 cut, which writes the first D queries' p, runs where N >= D.
    ``only``: the names of LAB_FORMS checked (default all)."""
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
            if ((name == "full" and not with_full) or (stage == "exp2" and N < C // H)
                    or (only is not None and name not in only)):
                continue
            got, qkv, _ = lab_row_block_parts(x, p, H, stage, **kw)
            torch.cuda.synchronize()
            ref = lab_row_block_reference(x, p, H, stage, qkv=qkv, **kw)
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
        res[regime] = {"forms": forms, "max_score": max_score(torch, x, p, H),
                       "ok": all(f["ok"] for f in forms.values())}
        torch.cuda.empty_cache()
    return res, flat


def bound_lab_ms(name: str, R: int, N: int, C: int, hidden: int, H: int = HEADS):
    """Least time for one lab form: B1's bound (bound_ms) cut at the stage.
    Bytes: rows in and out, LN1 and Wqkv (and from stage attn Wo, bo) once;
    the qkv product, then the scores, then AV (each 2 R N^2 C) and from
    stage attn the out-projection at the bf16 tensor-core rate; from stage
    exp2, H N^2 exp2 a row at the MUFU rate.  The flag forms compute the
    full stage's function on the same inputs: B1's bound."""
    stage = LAB_FORMS[name][0]
    if stage == "full":
        return bound_ms(R, N, C, hidden, H=H)
    k = ("qkv", "scores", "exp2", "av", "attn").index(stage)
    nbytes = 2 * (2 * R * N * C + 3 * C * C + 2 * C)
    flops = 2 * R * N * 3 * C * C + (2 * R * N * N * C if k >= 1 else 0) \
        + (2 * R * N * N * C if k >= 3 else 0)
    if k >= 4:
        nbytes += 2 * (C * C + C)
        flops += 2 * R * N * C * C
    return _bound(nbytes, flops, R * H * N * N if k >= 2 else 0)


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
            xf = card_randn(torch, (R, N, C), gen_full).to(torch.bfloat16)
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
    cli = [{"argv": argv, "last_line": run_tool_here("kernel_lab", argv)} for argv in LAB_CLI]
    launches = read_counts()["L"]
    ablated = sum(1 for label, *_ in CLI_SHAPES if LAB_SHAPES in label)
    variants = [v for v in LAB_VARIANTS.split(",") if v not in ("prod", "xla")]
    want = ablated * len(STAGES) * (1 + LAB_ITERS) + len(variants)   # a warm-up call each
    log(f"kernel_lab CLI: {launches} lab launches (expected {want}), counts {read_counts()}")
    if launches != want:
        fail(f"kernel_lab CLI: {launches} lab launches, expected {want}")
    return rows_out, max_err, totals, {"launches": launches, "runs": cli}


# The kernel lab's f32 forms (csrc/fused_block_f32.cu fused_block_lab_forward_f32):
# checked at the serving shapes, at wide384's (N, C) with its 4 heads (D =
# 12-96) and at these (C, H) at EDGE_N (D = 3, 4, 8, 16, 32, 64, 128), each
# (shape, regime) within f32_tol of the plain version; timed at the full
# row counts; the CLI in f32 once a mode (LAB_CLI with --dtype float32).
LAB_F32_EDGE = [(24, 8), (16, 4), (40, 5), (48, 3), (256, 8), (512, 8), (512, 4)]
LAB_F32_CLI = [["--dtype", "float32", *argv] for argv in LAB_CLI]
# a fault for --plant: the f32 lab kernel ignores score_bf16 (p = exp2 of the
# unrounded score), to be caught wherever the rounding moves the plain
# version's output past f32_tol
LAB_F32_PLANTS = {"lab_f32_score_bf16": (
    "    if constexpr ((FLAGS & SCORE_BF16) != 0) "
    "return expf(round_bf16(round_bf16(s) * LN2_BF16));\n", "")}


# how far (log2 units) from 128 a quantity of the no-clamp attention must lie
# for f32 overflow to be decided whatever the summation order
OVERFLOW_BAND = 1e-2


def overflow_decided(torch, qkv, R: int, N: int, C: int, H: int):
    """Which elements of the no-clamp attention output (R, N, C) are
    non-finite, and which finite, in any f32 computation of it, from the
    kernel's q|k|v (R*N, 3C) in float64.  With s the scores (log2 units),
    den = sum_j 2^s_ij and w_d = sum_j 2^s_ij |v_jd| (which bounds every
    partial sum of p . v in magnitude): an element is non-finite when its
    query's largest score is past 128 + OVERFLOW_BAND (an exp2 overflows,
    so den does: inf / inf or inf * v); finite when the largest score and
    log2 w_d lie below 128 - OVERFLOW_BAND and log2 den is not within the
    band (no partial sum of p . v overflows; den finite, or inf, giving 0);
    else undecided (f32 rounding decides)."""
    D = C // H
    t = qkv.view(R, N, 3, H, D).permute(2, 0, 3, 1, 4).double()   # (3, R, H, N, D)
    chunk = max(1, (1 << 30) // (H * N * N * 8))
    nonfinite, finite = [], []
    for r0 in range(0, R, chunk):
        q, k, v = t[0, r0:r0 + chunk], t[1, r0:r0 + chunk], t[2, r0:r0 + chunk]
        sc = q @ k.transpose(-1, -2)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        lden = m + torch.log2(p.sum(dim=-1, keepdim=True))
        lw = m + torch.log2(p @ v.abs())                              # (Rc, H, N, D)
        far = (lden - 128.0).abs() > OVERFLOW_BAND
        nf = (m >= 128.0 + OVERFLOW_BAND).expand_as(lw)
        fi = (m < 128.0 - OVERFLOW_BAND) & (lw < 128.0 - OVERFLOW_BAND) & far
        Rc = q.shape[0]
        nonfinite.append(nf.transpose(1, 2).reshape(Rc, N, C))
        finite.append(fi.transpose(1, 2).reshape(Rc, N, C))
        del sc, p
    return torch.cat(nonfinite), torch.cat(finite)


def check_lab_f32_shape(torch, N: int, C: int, gen, H: int = HEADS, only=None):
    """The f32 lab forms of LAB_FORMS (``only``: these names) against their
    plain f32 versions (fed the kernel's q|k|v) on CHECK_ROWS f32 rows, for
    each kind of weights in REGIMES.  Held: the error within f32_tol of the
    plain version's largest finite magnitude over the elements both give
    finite, every element finite (but noclamp's), and "full" equal to B1
    f32 (fused_row_block's launch) bit for bit.  noclamp overflows exp2 past
    a score of 128 (the clamp weights), and whether an attention output
    element (before the out-projection) overflows is decided by f32
    rounding where a sum lies within rounding of the largest f32: so the
    kernel's and the plain attention outputs are held where
    overflow_decided decides (both as decided), the undecided elements
    counted, and the block outputs must be non-finite at the same elements
    but in the tokens that hold an undecided attention element (the
    out-projection and LN2 spread a non-finite element over its token).
    Each form also records whether its
    flags move the plain output past the limit ("moved": score_bf16's
    against the unrounded score, what --plant lab_f32_score_bf16 computes)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops.lab_block import lab_row_block_parts, lab_row_block_reference

    res = {}
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime)
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda()
        forms = {}
        for name, (stage, kw) in LAB_FORMS.items():
            if (stage == "exp2" and N < C // H) or (only is not None and name not in only):
                continue
            got, qkv, attn = lab_row_block_parts(x, p, H, stage, **kw)
            torch.cuda.synchronize()
            ref = lab_row_block_reference(x, p, H, stage, qkv=qkv, **kw)
            fin_g, fin_r = got.isfinite(), ref.isfinite()
            both = fin_g & fin_r
            scale = ref[fin_r].abs().max().item() if fin_r.any() else 0.0
            tol = f32_tol(scale)
            diff = (got - ref).abs()[both]
            err = diff.max().item() if diff.numel() else 0.0
            f = {"max_abs_err": err, "tol": tol, "nonfinite": int((~fin_r).sum())}
            if name == "noclamp":
                ref_attn = fb._reference_forward(x, p, H, train=False, qkv=qkv, clamp=False)[1]
                nf, fi = overflow_decided(torch, qkv, CHECK_ROWS, N, C, H)
                f["attn_undecided"] = int((~nf & ~fi).sum())
                f["attn_nonfinite_mismatch"] = sum(
                    int(((a.isfinite() & nf) | (~a.isfinite() & fi)).sum())
                    for a in (attn, ref_attn))
                undecided = (~nf & ~fi).any(dim=-1, keepdim=True)
                f["nonfinite_mismatch"] = int(((fin_g != fin_r) & ~undecided).sum())
                f["ok"] = (err <= tol and f["attn_nonfinite_mismatch"] == 0
                           and f["nonfinite_mismatch"] == 0)
            else:
                f["ok"] = err <= tol and bool(fin_g.all() and fin_r.all())
            if name == "full":
                f["b1_f32_equal"] = bool(torch.equal(got, fb._forward_kernel(x, p, H).out))
                f["ok"] = f["ok"] and f["b1_f32_equal"]
            if name == "score_bf16":
                plain = lab_row_block_reference(x, p, H, "full", qkv=qkv)
                f["moved"] = (plain - ref).abs().max().item() > tol
            forms[name] = f
            del got, qkv, attn, ref
        res[regime] = {"forms": forms, "max_score": max_score(torch, x, p, H),
                       "ok": all(f["ok"] for f in forms.values())}
        torch.cuda.empty_cache()
    return res


def log_lab_f32_checks(label: str, checks) -> None:
    for regime, c in checks.items():
        log(f"lab f32 check {label} {regime:6s}: " + ", ".join(
            f"{n} {f['max_abs_err']:.3g}/{f['tol']:.3g}"
            + (f" nonfinite {f['nonfinite']} (mismatch {f['nonfinite_mismatch']}, attn "
               f"{f['attn_nonfinite_mismatch']}, attn undecided {f['attn_undecided']})"
               if "attn_undecided" in f and f["nonfinite"] else "")
            + ("" if f["ok"] else " MISS") for n, f in c["forms"].items())
            + f"; max score {c['max_score']:.1f}")


def lab_f32_shapes():
    """(label, N, C, H) of every f32 lab check: the serving shapes,
    wide384's and LAB_F32_EDGE's."""
    out = [(f"stage {s} {a}", N, C, HEADS) for s, a, N, C, _ in SHAPES]
    H = WIDE384["num_heads"]
    out += [(f"wide384 stage {s} {a}", N, C, H) for s, a, N, C, _ in WIDE_SHAPES]
    out += [(f"edge D={C // h}", N, C, h) for C, h in LAB_F32_EDGE for N in EDGE_N]
    return out


def lab_f32_checks(torch, only=None):
    """check_lab_f32_shape at every shape of lab_f32_shapes: {label:
    checks}, every check logged before the caller holds them."""
    gen = torch.Generator().manual_seed(17)
    out = {}
    for label, N, C, H in lab_f32_shapes():
        checks = check_lab_f32_shape(torch, N, C, gen, H=H, only=only)
        log_lab_f32_checks(f"{label} N={N} C={C} H={H}", checks)
        out[label] = {"N": N, "C": C, "H": H, "checks": checks}
    return out


def bound_lab_f32_ms(name: str, R: int, N: int, C: int, hidden: int, H: int = HEADS):
    """Least time for one f32 lab form: bound_lab_ms's work with f32 bytes
    and the products at 3xTF32's rate (PEAK_F32_FLOPS); the full and flag
    forms B1 f32's bound (bound_f32_ms)."""
    stage = LAB_FORMS[name][0]
    if stage == "full":
        return bound_f32_ms("B1", R, N, C, hidden, H=H)
    k = ("qkv", "scores", "exp2", "av", "attn").index(stage)
    nbytes = 4 * (2 * R * N * C + 3 * C * C + 2 * C)
    flops = 2 * R * N * 3 * C * C + (2 * R * N * N * C if k >= 1 else 0) \
        + (2 * R * N * N * C if k >= 3 else 0)
    if k >= 4:
        nbytes += 4 * (C * C + C)
        flops += 2 * R * N * C * C
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, (R * H * N * N if k >= 2 else 0) / MUFU_RATE) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_lab_f32(torch, quick: bool):
    """The kernel lab's f32 forms (L f32): the checks of lab_f32_checks (every
    one logged before a miss fails the run); unless ``quick``, each form
    timed once at the full row count of each serving shape (one call after
    a warm-up) with its bound and its plain version's time (on PLAIN_ROWS
    rows, scaled), summed over a model forward; then its main path, the CLI
    in f32 once a mode of LAB_F32_CLI, whose f32 lab launches are the
    kernel's count.  The library column is B1 f32's SDPA block for "full";
    no PyTorch call computes a cut or a flag form."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops.lab_block import STAGES, lab_row_block, lab_row_block_reference
    from tfswa_tpu_torch.tools.kernel_lab import SHAPES as CLI_SHAPES

    checks = lab_f32_checks(torch)
    misses = [f"{label} {regime} {n}" for label, e in checks.items()
              for regime, c in e["checks"].items() for n, f in c["forms"].items() if not f["ok"]]
    n_checks = sum(len(c["forms"]) for e in checks.values() for c in e["checks"].values())
    worst = max(f["max_abs_err"] / f["tol"] for e in checks.values()
                for c in e["checks"].values() for f in c["forms"].values())
    max_err = max(c["forms"]["full"]["max_abs_err"] for e in checks.values()
                  for c in e["checks"].values() if "full" in c["forms"])
    log(f"lab f32 checks: {n_checks - len(misses)} of {n_checks} within limits, worst error "
        f"/ limit {worst:.4f}")
    if misses:
        fail("the f32 kernel lab disagrees with its plain version at " + "; ".join(misses))
    totals = {name: dict.fromkeys(("ms", "plain_ms", "bound_ms", "bound_bytes_ms"), 0.0)
              for name in LAB_FORMS}
    timed = []
    if not quick:
        gen = torch.Generator().manual_seed(18)
        for stage, attn, N, C, R in SHAPES:
            p = random_params(torch, RowBlockParams, C, gen)
            xf = card_randn(torch, (R, N, C), gen)
            rs = min(R, PLAIN_ROWS)
            calls = BLOCKS_PER_STAGE[stage]
            row = {"stage": stage, "attn": attn, "N": N, "C": C, "R": R}
            for name, (st, kw) in LAB_FORMS.items():
                k_ms = cuda_ms(torch, lambda: lab_row_block(xf, p, HEADS, st, **kw), 1)
                pl_ms = cuda_ms(torch, lambda: lab_row_block_reference(
                    xf[:rs], p, HEADS, st, **kw), 1) * R / rs
                b_ms, b_by = bound_lab_f32_ms(name, R, N, C, 4 * C)
                row[name] = {"ms": k_ms, "plain_ms": pl_ms, "bound_ms": b_ms, "bound_by": b_by}
                for k, v in (("ms", k_ms), ("plain_ms", pl_ms), ("bound_ms", b_ms)):
                    totals[name][k] += calls * v
                if b_by == "bytes":
                    totals[name]["bound_bytes_ms"] += calls * b_ms
            log(f"  lab f32 stage {stage} {attn} R={R}: " + " ".join(
                f"{n} {row[n]['ms']:.3f}" for n in LAB_FORMS) + "; bound " + " ".join(
                f"{n} {row[n]['bound_ms']:.3f}" for n in LAB_FORMS))
            timed.append(row)
            del xf
            torch.cuda.empty_cache()
        for name, t in totals.items():
            log(f"per model forward (66 calls), lab f32 {name}: kernel_ms {t['ms']:.3f} "
                f"plain_ms {t['plain_ms']:.3f} bound_ms {t['bound_ms']:.4f}")
    # the main path: every counter at 0 just before, read just after
    reset_counts()
    cli = [{"argv": argv, "last_line": run_tool_here("kernel_lab", argv)}
           for argv in LAB_F32_CLI]
    launches = read_counts()["L-f32"]
    ablated = sum(1 for label, *_ in CLI_SHAPES if LAB_SHAPES in label)
    variants = [v for v in LAB_VARIANTS.split(",") if v not in ("prod", "xla")]
    want = ablated * len(STAGES) * (1 + LAB_ITERS) + len(variants)
    log(f"kernel_lab CLI in f32: {launches} f32 lab launches (expected {want})")
    if launches != want:
        fail(f"kernel_lab CLI in f32: {launches} f32 lab launches, expected {want}")
    return {"checks": checks, "worst": worst, "max_err": max_err,
            "timed": timed, "totals": totals, "path": {"launches": launches, "runs": cli}}


def plant_lab_f32(torch) -> None:
    """--plant lab_f32_score_bf16: the f32 lab's score_bf16 checks must miss
    at every (shape, regime) where the rounding moves the plain output past
    the limit, and somewhere at all; exit 0 when they do, 1 when not."""
    plant_fault(torch, "lab_f32_score_bf16")
    checks = lab_f32_checks(torch, only=("score_bf16",))
    must, missed = [], []
    for label, e in checks.items():
        for regime, c in e["checks"].items():
            f = c["forms"]["score_bf16"]
            if f["moved"]:
                must.append(f"{label} {regime}")
            if not f["ok"]:
                missed.append(f"{label} {regime}")
    passed = [m for m in must if m not in missed]
    if passed or not missed:
        fail(f"planted fault lab_f32_score_bf16: the f32 lab checks passed it at "
             f"{passed or 'every shape'}")
    log(f"planted fault lab_f32_score_bf16: caught at {len(missed)} (shape, regime) of "
        f"{sum(len(e['checks']) for e in checks.values())}, {len(must)} where the rounding "
        f"moves the output past the limit: {missed}")


def check_int8_shape(torch, N: int, C: int, gen, hidden=None, H: int = HEADS):
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
                                                 quantize_rows, unpad_heads)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        run = _forward_kernel(x, p, H, int8=True)
        out, attn, scales = run.out, run.attn, run.scales
        qkv, qk = unpad_heads(run.qkv, C, H), unpad_heads(run.qk, C, H)
        torch.cuda.synchronize()
        r_out, r_attn = fused_row_block_int8_reference_parts(x, p, H, qkv=qkv)
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
             "max_score": max_score(torch, x, p, H)}
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
            xf = card_randn(torch, (R, N, C), gen_full).to(torch.bfloat16)
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


def check_attn_shape(torch, N: int, C: int, gen, H: int = HEADS):
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
        out, acc, v, t = _kernel(x, *w, H, export=True)
        torch.cuda.synchronize()
        r_out, r_acc = flash_row_attention_reference_parts(x, *w, H, t=t, v=v)
        a, wv = bilinear_weights(w[0], H)
        xf = x.float()
        r_v = (xf @ wv.float()).to(x.dtype).reshape(-1, C)
        r_t = torch.stack([(xf @ a[h].to(x.dtype).float()).to(x.dtype)
                           for h in range(H)], dim=2).reshape(-1, H * C)
        t4 = t.float().view(CHECK_ROWS, N, H, C)[:4]
        s_max = max((t4[:, :, h] @ xf[:4].transpose(-1, -2)).max().item()
                    for h in range(H))
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
                xf = card_randn(torch, (R, N, C), gen_full).to(torch.bfloat16)
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
# Phase 16's configuration: the flagship in every field but its widths and
# heads, dims (48, 96, 192, 384) by the flagship's doubling rule to the
# paper's 384-channel, 4-head bottleneck (D = 12, 24, 48, 96), and its
# row shapes: SHAPES and TRAIN_SHAPES at its widths.
WIDE384 = dict(in_channels=4, out_channels=4, depths=(2, 2, 6, 2), dims=(48, 96, 192, 384),
               window_size=8, shift_size=4, num_heads=4)
WIDE_SHAPES = [(s, a, N, WIDE384["dims"][s], R) for s, a, N, _, R in SHAPES]
WIDE_TRAIN_SHAPES = [(s, a, N, WIDE384["dims"][s], R) for s, a, N, _, R in TRAIN_SHAPES]
# (C, H) of phase 16's edge grid, each at N = 64 and 129: D = 4, 4, 3, 8,
# 16, 48, 16, 128, 256, 512, 128, 64, 256
EDGE_GRID = [(8, 2), (16, 4), (24, 8), (40, 5), (48, 3), (48, 1), (96, 6), (256, 2),
             (256, 1), (512, 1), (512, 4), (512, 8), (512, 2)]
EDGE_N = (64, 129)


def wide_row_shapes(path: str):
    """(R, N, C) of wide384's row blocks, on its serving or training path."""
    table = WIDE_SHAPES if path == "serving" else WIDE_TRAIN_SHAPES
    return [(R, N, C) for _, _, N, C, R in table]
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


def check_train_shape(torch, N: int, C: int, gen, hidden=None, H: int = HEADS):
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
        fused_row_block_train_reference, unpad_heads)

    def plain(a, q):
        return fused_row_block_reference(a, q, H)

    res, flat = {}, None
    for regime in REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        if regime == "flat":
            flat = p
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        g = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda().to(torch.bfloat16)
        out, mid, acc, den = fused_row_block_train(x, p, H)
        again = _forward_kernel(x, p, H, train=True)     # for its q|k|v buffer
        torch.cuda.synchronize()
        qkv = unpad_heads(again.qkv, C, H)
        r_qkv = plain_qkv(torch, x, p, H)
        r_out, r_mid, r_acc, r_den = fused_row_block_train_reference(x, p, H, qkv=qkv)
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
        parts = fused_row_block_bwd_parts(x, mid, acc, den, g, p, H)
        twice = fused_row_block_bwd_parts(x, mid, acc, den, g, p, H)
        torch.cuda.synchronize()
        dx, dp = parts.dx, parts.dp
        ref = fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, H, qkv=qkv)
        r_dx, r_dp = ref.dx, ref.dp
        d_oe = unpad_heads(parts.d_oe, C, H)
        r_dqkv = fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, H, qkv=qkv,
                                                     d_oe=d_oe, d_den=parts.d_den).dqkv
        C3 = parts.dqkv.shape[-1] // 3
        qkv_parts = [(parts.dqkv[..., i * C3:(i + 1) * C3], r_dqkv[..., i * C3:(i + 1) * C3])
                     for i in range(3)]
        c.update(dx_err=_max_abs(dx, r_dx),
                 dx_tol=4 * bf16_ulp(r_dx.float().abs().max().item()),
                 dp_rel=max(_rel_max(a, b) for a, b in zip(dp, r_dp)), dp_tol=1e-2,
                 dqkv_err=[_max_abs(a, b) for a, b in qkv_parts],
                 dqkv_tol=[4 * bf16_ulp(b.float().abs().max().item()) for _, b in qkv_parts],
                 d_oe_err=_max_abs(d_oe, ref.d_oe),
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
        c["max_score"] = max_score(torch, x, p, H)
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
            xf = card_randn(torch, (R, N, C), gen_full).to(torch.bfloat16)
            gf = card_randn(torch, (R, N, C), gen_full).to(torch.bfloat16)
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


# Phase 3b: non-finite inputs.  Each kernel's output must be non-finite
# exactly where its plain version's is (the NaN rule of jnp.minimum,
# jnp.max and torch.clamp, torch.amax: a NaN score stays NaN where fminf
# would make it 110 and p the finite 2^110, and B3's row scale is NaN where
# q or k holds a NaN), at the flagship's stage-0 and stage-3 serving (B1,
# B3, B4) and training (B1-train, B2) shapes, bf16 and f32, on NF_ROWS rows
# of which row NF_ROW holds the case:
#   nan:      one token of the card's NaN (0x7fffffff, bf16 0x7fff);
#   inf:      one token of +inf;
#   overflow: the fused block's k of head 0 overflows f32 in every token of
#             the row, +inf in channel 0 and -inf in channel 1, while q's
#             channels 0 and 1 are finite and of one sign, so that each
#             q.k is inf - inf (NF_BIG weights from LN1's channel 0, which
#             is exactly 0 in the other rows: their tokens sum to 0);
#             B4's scores overflow f32 instead (channel 0 of the row at
#             NF_B4_BIG), B4 having no clamp;
#   nan_k:    no row but a weight: k's channel 0 from LN1's channel 3 the
#             card's NaN, so that every score of head 0 is NaN while v is
#             finite (what a NaN token cannot give: its v is NaN too).
# B2 takes the residuals (mid, acc, den) of B1-train on the rows and
# parameters without the case, so that the case reaches it through its
# recompute alone.  B4 f32 is held to its plain f32 version here: its f64
# scores stay finite where the plain version's overflow f32, and its tile
# max (within 2^-20 of the max, PR 15) then overflows p as the plain
# version's inf - inf does (its f64 function stays finite there: phase 15
# (a) holds it to that function on finite scores).
NF_ROWS, NF_ROW = 4, 1
NF_CASES = ("nan", "inf", "overflow", "nan_k")
NF_BIG = 2.0 ** 127
NF_Q = 64.0
NF_B4_BIG = 2.0 ** 80
NF_SHAPES = [s for s in SHAPES if s[0] in (0, 3)]
NF_TRAIN_SHAPES = [s for s in TRAIN_SHAPES if s[0] in (0, 3)]
NF_PLANTS = {
    # the clamp of exp2_line (B1, B1-train, B3, L) back on fminf
    "fminf_clamp": ("s[j][e] = clamp_score(s[j][e]);", "s[j][e] = fminf(s[j][e], SCORE_CLAMP);"),
}


def nf_params(torch, C: int, gen, block: bool = True):
    """Seeded flat-regime parameters; for the fused block with the
    overflow case's weights: LN1's channel 0 unscaled and unbiased, q's
    channels 0 and 1 NF_Q from it, k's channel 0 +NF_BIG and 1 -NF_BIG."""
    from tfswa_tpu_torch.models.attention import RowBlockParams

    p = random_params(torch, RowBlockParams, C, gen)
    if block:
        with torch.no_grad():
            p.norm1_scale[0], p.norm1_bias[0] = 1.0, 0.0
            p.qkv_kernel[0, :2] = NF_Q
            p.qkv_kernel[0, C], p.qkv_kernel[0, C + 1] = NF_BIG, -NF_BIG
    return p


def nf_nan_k(torch, p, C: int):
    """``p`` with the nan_k case's weight: qkv_kernel[3, C] the card's NaN."""
    w = p.qkv_kernel.clone()
    w.view(torch.int32)[3, C] = 0x7fffffff
    return p._replace(qkv_kernel=w)


def nf_rows(torch, N: int, C: int, gen):
    """NF_ROWS rows whose every token sums to exactly 0 (channels c and c +
    C/2 opposite bf16 values of magnitude 0.25-4.25), channels 0 and C/2 0:
    LN1's mean is exactly 0, so its channel 0 is exactly 0."""
    h = C // 2
    mag = 0.25 + 4.0 * torch.rand(NF_ROWS, N, h, generator=gen)
    sign = torch.where(torch.rand(NF_ROWS, N, h, generator=gen) < 0.5, -1.0, 1.0)
    half = (mag * sign).to(torch.bfloat16).float()
    x = torch.cat([half, -half], dim=-1)
    x[..., 0] = 0.0
    x[..., h] = 0.0
    return x


def nf_case(torch, x, case: str, dtype, block: bool = True):
    """``x`` with ``case`` in row NF_ROW (nan_k: as it is), on the card in
    ``dtype``."""
    x = x.clone()
    N, h = x.shape[1], x.shape[2] // 2
    if case == "inf":
        x[NF_ROW, N // 3] = math.inf
    elif case == "overflow" and block:
        x[NF_ROW, :, 0], x[NF_ROW, :, h] = 8.0, -8.0
    elif case == "overflow":
        x[NF_ROW, :, 0] = NF_B4_BIG
    x = x.to(dtype).cuda()
    if case == "nan":
        f32 = dtype == torch.float32
        x.view(torch.int32 if f32 else torch.int16)[NF_ROW, N // 3] = (
            0x7fffffff if f32 else 0x7fff)
    return x


def nf_compare(torch, got, ref):
    """(elements where one side is finite and the other not, the kernel's
    non-finite elements, the plain version's, {output index: its elements
    that differ}), over the pairs of outputs."""
    diff = nk = nr = 0
    where = {}
    for i, (a, b) in enumerate(zip(got, ref)):
        fa, fb = torch.isfinite(a.float()), torch.isfinite(b.float())
        if fa.shape != fb.shape:
            raise ValueError(f"shapes {tuple(fa.shape)} and {tuple(fb.shape)}")
        d = int((fa != fb).sum())
        if d:
            where[i] = d
        diff += d
        nk += int((~fa).sum())
        nr += int((~fb).sum())
    return diff, nk, nr, where


def nf_serving(torch, N: int, C: int, dtype, gen):
    """B1, B3 and B4 (``dtype``) at (N, C): {(kernel, case): (outputs, plain
    outputs)}."""
    from tfswa_tpu_torch.ops.fused_block import (_forward_kernel,
                                                 fused_row_block_int8_reference_parts,
                                                 fused_row_block_reference_parts)
    from tfswa_tpu_torch.ops.row_attention import _kernel, flash_row_attention_reference_parts

    p0, pa0 = nf_params(torch, C, gen), nf_params(torch, C, gen, block=False)
    x0 = nf_rows(torch, N, C, gen)
    out = {}
    for case in NF_CASES:
        p, pa = (nf_nan_k(torch, q, C) if case == "nan_k" else q for q in (p0, pa0))
        x = nf_case(torch, x0, case, dtype)
        for kind, int8, plain in (("B1", False, fused_row_block_reference_parts),
                                  ("B3", True, fused_row_block_int8_reference_parts)):
            run = _forward_kernel(x, p, HEADS, int8=int8)
            out[kind, case] = ((run.out, run.attn), plain(x, p, HEADS))
        xa = nf_case(torch, x0, case, dtype, block=False)
        w = [t.to(dtype) for t in (pa.qkv_kernel, pa.proj_kernel, pa.proj_bias)]
        out["B4", case] = (_kernel(xa, *w, HEADS)[:2],
                           flash_row_attention_reference_parts(xa, *w, HEADS))
    return out


def nf_train(torch, N: int, C: int, dtype, gen):
    """B1-train and B2 (``dtype``) at (N, C): {(kernel, case): (outputs,
    plain outputs)}; B2 on B1-train's residuals of the rows without the
    case, the outputs dx, the 11 gradients and dqkv."""
    from tfswa_tpu_torch.ops.fused_block import (fused_row_block_bwd_parts,
                                                 fused_row_block_bwd_reference_parts,
                                                 fused_row_block_train,
                                                 fused_row_block_train_reference)

    p0 = nf_params(torch, C, gen)
    x0 = nf_rows(torch, N, C, gen)
    g = torch.randn(NF_ROWS, N, C, generator=gen).to(dtype).cuda()
    _, mid, acc, den = fused_row_block_train(x0.to(dtype).cuda(), p0, HEADS)
    out = {}
    for case in NF_CASES:
        p = nf_nan_k(torch, p0, C) if case == "nan_k" else p0
        x = nf_case(torch, x0, case, dtype)
        out["B1-train", case] = (fused_row_block_train(x, p, HEADS),
                                 fused_row_block_train_reference(x, p, HEADS))
        got = fused_row_block_bwd_parts(x, mid, acc, den, g, p, HEADS)
        ref = fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, HEADS)
        out["B2", case] = ((got.dx, *got.dp, got.dqkv), (ref.dx, *ref.dp, ref.dqkv))
    return out


def phase_nonfinite(torch):
    """Phase 3b: every kernel and f32 form on NF_CASES at NF_SHAPES
    (serving) and NF_TRAIN_SHAPES (training).  A check misses where an
    output element is finite on one side and not on the other; the overflow
    and nan_k cases of B1, B1-train and B2 must make the plain version
    non-finite somewhere (else they test no clamp).  Every check is logged before a
    miss fails the run; returns the checks and the misses."""
    gen = torch.Generator().manual_seed(11)
    checks, misses = [], []
    for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, " f32")):
        for path, shapes, run in (("serving", NF_SHAPES, nf_serving),
                                  ("train", NF_TRAIN_SHAPES, nf_train)):
            for stage, attn, N, C, _ in shapes:
                with torch.no_grad():
                    res = run(torch, N, C, dtype, gen)
                torch.cuda.synchronize()
                for (kind, case), (got, ref) in res.items():
                    diff, nk, nr, where = nf_compare(torch, got, ref)
                    ok = diff == 0 and (nr > 0 or case in ("nan", "inf")
                                        or (case == "overflow" and kind in ("B3", "B4")))
                    label = f"{kind}{sfx} {path} stage {stage} {attn} N={N} C={C} {case}"
                    checks.append({"kernel": kind + sfx, "path": path, "stage": stage,
                                   "attn": attn, "N": N, "C": C, "case": case,
                                   "mismatched": diff, "mismatched_by_output": where,
                                   "kernel_nonfinite": nk, "plain_nonfinite": nr, "ok": ok})
                    log(f"non-finite {label}: kernel {nk}, plain {nr} non-finite, "
                        f"{diff} mismatched{f' (by output {where})' if where else ''} "
                        f"{'ok' if ok else 'MISS'}")
                    if not ok:
                        misses.append(label)
                del res
                torch.cuda.empty_cache()
    log(f"non-finite checks: {len(checks) - len(misses)} of {len(checks)} held")
    return checks, misses


def plant_nonfinite(torch) -> None:
    """--plant fminf_clamp: phase 3b on the planted library must miss B1's
    overflow case at every serving shape of NF_SHAPES (bf16)."""
    plant_fault(torch, "fminf_clamp")
    _, misses = phase_nonfinite(torch)
    want = [f"B1 serving stage {s} {a} N={N} C={C} overflow" for s, a, N, C, _ in NF_SHAPES]
    passed = [c for c in want if c not in misses]
    if passed:
        fail(f"planted fault fminf_clamp: phase 3b passed it at {passed}")
    log(f"planted fault fminf_clamp: caught by phase 3b at {len(misses)} checks: {misses}")


RECIPE = "configs/musdb_repro.yaml"


def row_shapes(F: int, T: int, dims, window: int):
    """(N, C) of the row blocks of one forward on an F x T spectrogram:
    each stage runs TSA along F, FSA along T and SWA over window x window
    tokens, and the next stage halves F and T (rounding down), as
    SHAPES and TRAIN_SHAPES list them."""
    out = set()
    for C in dims:
        out |= {(F, C), (T, C), (window * window, C)}
        F, T = F // 2, T // 2
    return out


def recipe_row_shapes(cfg):
    """(N, C) of the row blocks of the recipe's CLI run, by phase: its
    train steps (B1-train and B2) and validation (B1) on segments of
    data.segment_seconds under train.freq_policy, and its SDR evaluation
    (B1), whose separator cuts sdr_eval_segment_seconds and keeps every
    STFT row (freq_policy "full")."""
    d, s, m = cfg.data, cfg.stft, cfg.model
    F = s.n_fft // 2 + 1

    def frames(seconds):
        return int(seconds * d.sample_rate) // s.hop_length + 1

    F_train = F - 1 if cfg.train.freq_policy == "crop_pow2" and F % 2 else F
    train = row_shapes(F_train, frames(d.segment_seconds), m.dims, m.window_size)
    return {"train": train, "val": train,
            "sdr": row_shapes(F, frames(cfg.train.sdr_eval_segment_seconds), m.dims,
                              m.window_size)}


def unchecked_shapes(want, covered):
    """The (N, C) of a CLI run's phases (``recipe_row_shapes``) that no
    check has covered yet: {"train": B1-train / B2's, "B1": B1's}, sorted."""
    return {"train": sorted(want["train"] - covered["train"]),
            "B1": sorted((want["val"] | want["sdr"]) - covered["B1"])}


def initial_covered():
    """The (N, C) that phases 2 and 6 check: B1 at SHAPES, B1-train and B2
    at TRAIN_SHAPES."""
    return {"train": {(N, C) for _, _, N, C, _ in TRAIN_SHAPES},
            "B1": {(N, C) for _, _, N, C, _ in SHAPES}}


def recipe_config():
    """configs/musdb_repro.yaml with phase 10's overrides (TRAIN_CLI)."""
    from tfswa_tpu_torch.config import Config

    return Config.from_yaml(os.path.join(HERE, RECIPE)).apply_overrides(
        [a for flag, a in zip(TRAIN_CLI, TRAIN_CLI[1:]) if flag == "--set"])


def check_cli_run_shapes(torch, cfg, covered, label: str, seed: int):
    """B1-train and B2 (check_train_shape) at each (N, C) of ``cfg``'s
    train steps, and B1 (check_shape) at each of its validation and SDR
    evaluation, that ``covered`` lacks, at the same limits; ``covered``
    takes them.  Returns the checks and the largest errors."""
    gen = torch.Generator().manual_seed(seed)
    todo = unchecked_shapes(recipe_row_shapes(cfg), covered)
    rows_out, misses = [], []
    err = {"train": 0.0, "bwd": 0.0, "B1": 0.0}
    for N, C in todo["train"]:
        checks, _ = check_train_shape(torch, N, C, gen)
        log_train_checks(f"{label} N={N} C={C}", checks, misses, err)
        rows_out.append({"kernels": "B1-train/B2", "N": N, "C": C, "checks": checks})
        covered["train"].add((N, C))
    for N, C in todo["B1"]:
        checks, _ = check_shape(torch, N, C, gen)
        err["B1"] = max(err["B1"], log_b1_checks(f"{label} N={N} C={C}", checks, misses))
        rows_out.append({"kernels": "B1", "N": N, "C": C, "checks": checks})
        covered["B1"].add((N, C))
    log(f"{label}: {len(rows_out)} (N, C) checked beyond the shapes checked before: "
        f"{[(r['kernels'], r['N'], r['C']) for r in rows_out]}")
    if misses:
        fail(f"the kernels disagree with their plain versions at the {label}'s shapes: "
             + "; ".join(misses))
    return rows_out, err


def phase_recipe_kernels(torch):
    """B1-train and B2 at each (N, C) of the recipe's train steps, and B1
    at each of its validation and SDR evaluation, that TRAIN_SHAPES and
    SHAPES lack (check_cli_run_shapes).  Returns the checks, the largest
    errors and the (N, C) now covered for each kernel, which
    phase_train_cli holds the CLI run's shapes to."""
    covered = initial_covered()
    rows_out, err = check_cli_run_shapes(torch, recipe_config(), covered, f"recipe {RECIPE}",
                                         12)
    return rows_out, err, covered


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


# Faults for --plant in a copy of an f32 source, each of which phase 15
# (a)'s checks must catch: "b4_tf32_scores" (csrc/row_attention_f32.cu), q
# and k rounded to TF32's 10-bit mantissa before B4's score product (one
# TF32 pass), to be caught at every serving shape's clamp weights;
# "f32_1xtf32" (csrc/block_f32.cuh, the tile every f32 product runs on),
# the two correction products of 3xTF32 dropped, leaving one TF32 pass:
# each (shape, regime) that catches it is logged.
TF32 = "__uint_as_float((__float_as_uint({}) + 0x1000u) & 0xffffe000u)"
F32_PLANTS = {
    "b4_tf32_scores": (
        "dmma(sc[0][nt][0], sc[0][nt][1], sc[1][nt][0], sc[1][nt][1], a[0][kk], a[1][kk], b);",
        "dmma(sc[0][nt][0], sc[0][nt][1], sc[1][nt][0], sc[1][nt][1], (double)"
        + TF32.format("(float)a[0][kk]") + ", (double)" + TF32.format("(float)a[1][kk]")
        + ", (double)" + TF32.format("(float)b") + ");"),
    "f32_1xtf32": ("    mma_tf32(t, a[1], b[0]);\n    mma_tf32(t, a[0], b[1]);\n", ""),
}
# the file each f32 plant patches
F32_PLANT_SOURCES = {"b4_tf32_scores": "row_attention_f32.cu", "f32_1xtf32": "block_f32.cuh",
                     "lab_f32_score_bf16": "fused_block_f32.cu", "fminf_clamp": "fused_block.cu"}


def plant_fault(torch, name: str) -> None:
    """Build csrc/fused_block_bwd.cu with fault ``name`` of PLANTS, or the f32
    sources with one of F32_PLANTS, into build/planted/ (outside the
    sources) with the port's nvcc flags, and swap the libraries in for the
    kernels'.  A patched header goes beside copies of the f32 sources, whose
    #include "block_f32.cuh" finds it there first."""
    import ctypes

    from tfswa_tpu_torch.ops import _build

    src_name = F32_PLANT_SOURCES.get(name, "fused_block_bwd.cu")
    old, new = {**PLANTS, **F32_PLANTS, **LAB_F32_PLANTS, **NF_PLANTS}[name]
    src = (_build.CSRC / src_name).read_text()
    if src.count(old) != 1:
        fail(f"planted fault {name}: its text is not once in {src_name}")
    out = _build.BUILD_DIR.parent / "planted" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / src_name).write_text(src.replace(old, new))
    libs = list(F32_LIBS) if src_name.endswith(".cuh") else [src_name[:-3]]
    procs = {}
    for lib in libs:
        cu = out / f"{lib}.cu"
        if lib + ".cu" != src_name:
            cu.write_text((_build.CSRC / f"{lib}.cu").read_text())
        procs[lib] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib{lib}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for lib, proc in procs.items():
        log_out = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"planted fault {name}: nvcc failed for {lib}:\n{log_out}")
        _build._loaded[lib] = ctypes.CDLL(str(out / f"lib{lib}.so"))
    log(f"planted fault {name} in {src_name} ({', '.join(libs)}): {old!r} -> {new!r}")


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


def make_trainer(torch, impl: str, remat: bool = False, mrstft: bool = False,
                 dtype: str = "bfloat16", dropout: float = 0.0, param_dtype: str = "float32",
                 **model_kw):
    """The flagship model (bf16 compute unless ``dtype`` says otherwise, f32
    parameters unless ``param_dtype`` says otherwise, weights from seed 0;
    ``model_kw``: other ModelConfig fields, as WIDE_MODEL) in a TrainState
    with the TrainConfig
    defaults (``mrstft``: with the MR-STFT loss at its default weight), and
    its train and eval steps."""
    from tfswa_tpu_torch.config import Config, ModelConfig, TrainConfig
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.training import (create_train_state, make_eval_step,
                                          make_train_step)

    cfg = Config(model=ModelConfig(in_channels=4, out_channels=4, attention_impl=impl,
                                   dtype=dtype, remat=remat, dropout=dropout,
                                   param_dtype=param_dtype, **model_kw),
                 train=TrainConfig(seed=0, use_mrstft_loss=mrstft))
    model, state = create_train_state(cfg, device="cuda")
    proc = STFTProcessor(cfg.stft)
    stems = cfg.data.stems
    kw = dict(l1_weight=cfg.train.l1_weight, mask_mode=cfg.train.train_mask_mode,
              freq_policy=cfg.train.freq_policy)
    return (state, make_train_step(model, proc, stems, mrstft_weight=cfg.train.mrstft_weight,
                                   use_mrstft=cfg.train.use_mrstft_loss, **kw),
            make_eval_step(model, proc, stems, **kw))


def row_block_grads(model):
    """(name, gradient) of every row-block parameter (66 blocks x 11)."""
    return [(n, p.grad) for n, p in model.named_parameters()
            if any(f".{a}." in n for a in ("tsa", "fsa", "swa"))]


# per train step, the launches of each kernel route (any other kernel: 0),
# the steps timed after the warm-up, and the device kernels to sum by group
# per route: launches a step, timed steps, the profile's kernel groups, and
# the segments of phase 7's batch it trains on
TRAIN_ROUTES = {
    "pallas": ({"B1-train": 66, "B2": 66}, TRAIN_STEPS,
               {"B1-train": (*(f"ln_qkv_kernel<{C}, true, false>" for C in (32, 64, 128, 256)),
                             "k_norm_kernel", "attn_kernel", "post_kernel"),
                "B2": (*(f"ln_qkv_kernel<{C}, true, true>" for C in (32, 64, 128, 256)),
                       "mlp_bwd_kernel", "attn_bwd_norm_kernel", "attn_bwd_q_kernel",
                       "attn_bwd_kv_kernel", "ln1_bwd_kernel", "atb_kernel",
                       "reduce_kernel")}, TRAIN_BATCH),
    # one timed step on the first segment, and no profile of its some 150 k
    # launches (the run's time): the route's step is host-bound (about 10 s
    # at 2 segments on an H100, 111 s for the phase)
    "pallas_attn": ({"B4": 66}, 1, None, 1),
}


def phase_train(torch, np, gpu: str, impl: str = "pallas"):
    """The training main path through one route: a warm-up step, then
    counted and timed steps on one fixed batch (every launch counter set to
    0 just before and read just after), the checks and, for "pallas", one
    profiled step and an eval step, on the route's segments of phase 7's
    batch.
    The loss must fall over the "pallas" route's 5 steps; the "pallas_attn"
    route's one is recorded."""
    per_kernel, steps, groups, segments = TRAIN_ROUTES[impl]
    state, step, eval_step = make_trainer(torch, impl)
    mix, targets = train_batch(torch, np)
    mix, targets = mix[:segments], {k: v[:segments] for k, v in targets.items()}
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
    rate = segments * TRAIN_SECONDS / best
    log(f"train path {impl}: {steps} steps of {segments} x {TRAIN_SECONDS} s, "
        f"best {best * 1e3:.3f} ms/step (warm-up {warm_s:.3f} s): {rate:.4f} "
        f"audio-s trained per s on {gpu}; peak memory {peak_gb:.3f} GB")

    res = {"launches": launches, "per_step": per_step, "step_s": times,
           "warmup_s": warm_s, "best_ms_per_step": best * 1e3,
           "audio_s_trained_per_s": rate, "peak_mem_gb": peak_gb, "losses": losses}
    if impl != "pallas":
        return res
    res["profile"] = profile_step(torch, lambda: step(state, mix, targets), groups)
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


def profile_step(torch, run, groups):
    """Device time by kernel over one train step (torch.profiler, CUDA
    activity only: the profiler's post-processing of CPU ops as well takes
    seconds more), summed by the kernel groups of ``groups``, and the
    device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    log(f"profile (CUDA activity): one train step, wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, "
        f"idle share {res['idle_share']:.4f} (user annotations left out: "
        f"{annotation_ms:.3f} ms); " + ", ".join(
            f"{g} {v:.3f} ms" for g, v in by_group.items()))
    for k in kernels[:14]:
        log(f"  {k[1]:10.3f} ms  x{k[2]:<5d} {k[0][:90]}")
    return res


ROUTE_SEGMENTS = 2


def phase_train_routes(torch, np):
    """One train step through each kernel route ("pallas", "pallas_attn")
    and through the plain route (attention_impl="xla", autograd through
    plain PyTorch), same weights and batch: for each kernel route the loss
    within 1e-2 relative of the plain route's, the flattened gradients at a
    cosine similarity of at least 0.99.  On the first ROUTE_SEGMENTS of
    phase 7's segments (the plain and "pallas_attn" steps are host-bound)."""
    mix, targets = train_batch(torch, np)
    mix, targets = mix[:ROUTE_SEGMENTS], {k: v[:ROUTE_SEGMENTS] for k, v in targets.items()}
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


def step_launches(depths=(2, 2, 6, 2), remat: bool = False):
    """B1-train and B2 launches of one "pallas" train step: three row blocks
    (TSA, FSA, SWA) a TFSWABlock, 2 (d0 + d1 + d2) + d3 blocks; with remat
    the backward runs each block's forward again, B1-train included."""
    blocks = 3 * (2 * sum(depths[:3]) + depths[3])
    return {"B1-train": blocks * (2 if remat else 1), "B2": blocks}


def phase_remat(torch, np, gpu: str):
    """One train step with remat and one without from the same weights, on
    phase 7's fixed batch: loss within 1e-3 rel., gradient cosine >= 0.999,
    equal num_batches_tracked, running stats within 1e-3 rel., the launch
    counts of ``step_launches``; then two more steps each, timed, and the
    peak memory of each."""
    mix, targets = train_batch(torch, np)
    res, grads, stats = {}, {}, {}
    for remat in (False, True):
        state, step = make_trainer(torch, "pallas", remat)[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        counts = read_counts()
        grads[remat] = torch.cat([p.grad.flatten().double() for p in state.model.parameters()])
        stats[remat] = {k: v.clone() for k, v in state.model.state_dict().items()
                        if "running" in k or "num_batches" in k}
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            step(state, mix, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        want = {k: step_launches(remat=remat).get(k, 0) for k in counts}
        res[remat] = {"total_loss": float(loss["total_loss"]), "launches": counts,
                      "step_s": times, "best_ms_per_step": min(times) * 1e3,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"remat={remat}: first step launches {counts} (expected {want}), loss "
            f"{res[remat]['total_loss']:.6f}; steps {[round(t * 1e3, 3) for t in times]} ms, "
            f"best {min(times) * 1e3:.3f} ms/step, peak memory "
            f"{res[remat]['peak_mem_gb']:.3f} GB on {gpu}")
        if counts != want:
            fail(f"remat={remat}: expected launches {want} in a step, got {counts}")
        del state, step
        torch.cuda.empty_cache()
    a, b = grads[True], grads[False]
    cos = float((a @ b) / (a.norm() * b.norm()))
    rel = abs(res[True]["total_loss"] - res[False]["total_loss"]) / abs(res[False]["total_loss"])
    tracked = all(torch.equal(stats[True][k], v) for k, v in stats[False].items()
                  if "num_batches" in k)
    stat_rel = max(float(((stats[True][k] - v).abs().max() / v.abs().max().clamp_min(1e-12)))
                   for k, v in stats[False].items() if "running" in k)
    res.update(loss_rel=rel, grad_cosine=cos, num_batches_tracked_equal=tracked,
               running_stats_rel=stat_rel)
    log(f"remat vs no remat, one step: loss rel {rel:.2e} (limit 1e-3), gradient cosine "
        f"{cos:.6f} (min 0.999), num_batches_tracked equal {tracked}, running stats rel "
        f"{stat_rel:.2e} (limit 1e-3)")
    if not (rel <= 1e-3 and cos >= 0.999 and tracked and stat_rel <= 1e-3):
        fail(f"remat vs no remat: loss rel {rel}, cosine {cos}, num_batches_tracked equal "
             f"{tracked}, running stats rel {stat_rel}")
    return {str(k): v for k, v in res.items()}


TRAIN_CK = os.path.join(HERE, "chiprun_out", "train_ck")
# the recipe's own CLI run, with one train record an epoch (the recipe logs
# every 50 steps, more than a run of these epochs takes)
TRAIN_CLI = ["--config", RECIPE, "--synthetic",
             "--set", "train.steps_per_epoch=4", "--set", "train.sdr_eval_num_tracks=2",
             "--set", "train.log_every_n_steps=4",
             "--checkpoint_dir", "chiprun_out/train_ck", "--log_dir", "chiprun_out/train_log"]
# Runs the training CLI's module as __main__ with the given arguments and
# prints, as its last line, the launches of each kernel counted inside the
# trainer's train_epoch, validate and evaluate_sdr, the (N, C) each kernel
# was launched at there, and, on a resume, whether the restored state equals
# the checkpoint's.  A track that fails in the SDR evaluation, which the
# trainer warns about and leaves out, is an error here.
CLI_RUNNER = r"""
import json, runpy, sys, warnings, torch
import chip_smoke as cs
from tfswa_tpu_torch.ops import fused_block as fb
from tfswa_tpu_torch.training import trainer as tr
warnings.filterwarnings("error", message="SDR eval failed")
out = {"launches": {}, "shapes": {}}
phase = []

def counted(name, fn):
    def run(self, *a, **k):
        before = cs.read_counts()
        phase.append(name)
        try:
            return fn(self, *a, **k)
        finally:
            phase.pop()
            acc = out["launches"].setdefault(name, {})
            for key, n in cs.read_counts().items():
                acc[key] = acc.get(key, 0) + n - before[key]
    return run

def seen(kind, rows):
    if phase:
        shapes = out["shapes"].setdefault(phase[-1], {}).setdefault(kind, [])
        if list(rows.shape[1:]) not in shapes:
            shapes.append(list(rows.shape[1:]))

forward, backward = fb._forward_kernel, fb.fused_row_block_bwd_parts

def forward_seen(rows, p, num_heads, train=False, int8=False):
    seen("B1-train" if train else "B3" if int8 else "B1", rows)
    return forward(rows, p, num_heads, train, int8)

def backward_seen(rows, *a):
    seen("B2", rows)
    return backward(rows, *a)

fb._forward_kernel, fb.fused_row_block_bwd_parts = forward_seen, backward_seen

for name in ("train_epoch", "validate", "evaluate_sdr"):
    setattr(tr.Trainer, name, counted(name, getattr(tr.Trainer, name)))
load = tr.Trainer.load_checkpoint

def checked_load(self, which="latest"):
    load(self, which)
    tree, meta = self.ckpt.restore(which)
    sd, opt = self.model.state_dict(), self.state.tx.state_dict()
    bad = [k for k, v in tree["model_state_dict"].items() if not torch.equal(sd[k].cpu(), v)]
    saved = tree["optimizer"]["adamw"]["state"]
    bad += [f"adamw/{i}/{k}" for i, s in saved.items() for k, v in s.items()
            if not torch.equal(opt["adamw"]["state"][i][k].cpu(), v)]
    if opt["count"] != tree["optimizer"]["count"] or self.state.step != meta["global_step"]:
        bad.append("count or step")
    out["restored"] = {"mismatches": bad, "params_and_buffers": len(sd),
                       "moments": len(saved), "step": self.state.step, "meta": meta}

tr.Trainer.load_checkpoint = checked_load
sys.argv = ["tfswa_tpu_torch.cli.train"] + json.loads(sys.argv[1])
runpy.run_module("tfswa_tpu_torch.cli.train", run_name="__main__")
print(json.dumps(out))
"""


def run_tool(module: str, argv, runner=None, timeout: int = 900):
    """``python -m tfswa_tpu_torch.tools.<module>`` (or ``runner`` with
    the arguments as JSON) in a subprocess from the checkout: its last
    line as JSON."""
    cmd = ([sys.executable, "-c", runner, json.dumps(argv)] if runner else
           [sys.executable, "-m", f"tfswa_tpu_torch.tools.{module}", *argv])
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=timeout)
    lines = res.stdout.strip().splitlines()
    for line in lines:
        log(f"  | {line[:300]}")
    if res.returncode != 0:
        fail(f"{module} {' '.join(argv)} exited {res.returncode}:\n{res.stderr[-3000:]}")
    return json.loads(lines[-1])


def run_train_cli(argv):
    """The training CLI in a subprocess from the checkout (CLI_RUNNER): its
    last line's launch counts and restore check."""
    return run_tool("cli.train", argv, runner=CLI_RUNNER, timeout=600)


def cli_designed_launches(cfg, steps: int, validations: int, sdr_evals: int):
    """Launches the CLI run should make: B1-train and B2 in its steps
    (``step_launches``), B1 (66 a forward) in its validations (one forward
    a batch of the synthetic validation set) and its SDR evaluations (one
    forward a segment_batch of 8 segments of each 30 s track, host OLA)."""
    from tfswa_tpu_torch.data.synthetic import SyntheticDataset

    d, t = cfg.data, cfg.train
    val = SyntheticDataset(num_tracks=4, track_seconds=30.0, segment_seconds=d.segment_seconds,
                           sample_rate=d.sample_rate, random_segments=False)
    seg = int(t.sdr_eval_segment_seconds * d.sample_rate)
    hop = int(seg * (1 - t.sdr_eval_overlap))
    total = int(30.0 * d.sample_rate)
    segments = (total - seg) // hop + 1 if total > seg else 1
    per_step = step_launches(cfg.model.depths, cfg.model.remat)
    forward = 3 * (2 * sum(cfg.model.depths[:3]) + cfg.model.depths[3])
    return {"train_epoch": {k: v * steps for k, v in per_step.items()},
            "validate": {"B1": forward * -(-len(val) // d.batch_size) * validations},
            "evaluate_sdr": {"B1": forward * -(-segments // 8) * min(
                t.sdr_eval_num_tracks, 4) * sdr_evals}}


def check_cli_launches(got, want, label: str) -> None:
    for phase, kernels in want.items():
        full = {k: kernels.get(k, 0) for k in got.get(phase, kernels)}
        log(f"{label} {phase}: launches {got.get(phase)} (designed {full})")
        if got.get(phase) != full:
            fail(f"{label} {phase}: expected launches {full}, got {got.get(phase)}")


def read_cli_log(np, log_dir: str):
    """The records of metrics.jsonl, every value finite, with train, val
    and sdr records."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    keys = set().union(*recs)
    bad = [(r["step"], k) for r in recs for k, v in r.items() if not math.isfinite(v)]
    for prefix in ("train/", "val/", "sdr/", "si_sdr/", "epoch_train/"):
        if not any(k.startswith(prefix) for k in keys):
            fail(f"metrics.jsonl: no {prefix} record")
    if bad:
        fail(f"metrics.jsonl: non-finite values {bad[:5]}")
    return recs


def check_cli_shapes(got, want, covered, label: str) -> None:
    """The (N, C) each kernel was launched at in each phase of a CLI run
    (CLI_RUNNER) must be the recipe's (recipe_row_shapes), and each must
    have been checked against the plain version (phase_recipe_kernels)."""
    design = {"train_epoch": {"B1-train": want["train"], "B2": want["train"]},
              "validate": {"B1": want["val"]}, "evaluate_sdr": {"B1": want["sdr"]}}
    for phase, kinds in design.items():
        seen = {k: {tuple(s) for s in v} for k, v in got.get(phase, {}).items()}
        log(f"{label} {phase}: (N, C) launched " + "; ".join(
            f"{k} {sorted(v)}" for k, v in sorted(seen.items())))
        if seen != kinds:
            fail(f"{label} {phase}: launched at {seen}, designed {kinds}")
        unchecked = {k: v - covered["train" if k != "B1" else "B1"] for k, v in seen.items()}
        if any(unchecked.values()):
            fail(f"{label} {phase}: launched at (N, C) never checked: {unchecked}")


def cli_numbers(recs, batch: int, seconds: float):
    """Step time, audio-s trained/s, peak memory and the SDR evaluation's
    seconds of one CLI run's records.  The step time is the trainer's own
    epoch_train/step_time_s of the run's last epoch: the mean interval
    between consecutive steps of an epoch, over every epoch of the run
    (StepTimer's window of 50 holds them all), the batch's loading and
    augmentation included and the first step of each epoch left out.  The
    SDR evaluation runs between the val record and the sdr record."""
    step_s = [r for r in recs if "epoch_train/step_time_s" in r][-1]["epoch_train/step_time_s"]
    sdr_s = [b["time"] - a["time"] for a, b in zip(recs, recs[1:])
             if any(k.startswith("val/") for k in a) and "sdr/avg" in b]
    peak = max(r.get("epoch_train/mem/peak_gb", 0.0) for r in recs)
    return {"ms_per_step": step_s * 1e3, "audio_s_trained_per_s": batch * seconds / step_s,
            "peak_mem_gb": peak, "sdr_eval_s": sdr_s}


def phase_train_cli(torch, np, gpu: str, covered):
    """The training entry point (python -m tfswa_tpu_torch.cli.train) on
    configs/musdb_repro.yaml and the synthetic set, in a subprocess: two
    epochs of 4 steps (remat, augment + mixup, direct masks, crop_pow2,
    4 x 5.938 s), validation and SDR evaluation, checkpoints; then a third
    epoch resumed from latest.  Launches counted by phase against the design, the (N, C)
    of each against the recipe's and against ``covered`` (the shapes that
    phase_recipe_kernels and the kernel phases checked), the log's
    records finite, the checkpoint layout, the restored state equal to the
    saved one, global_step 12 at the end (the best checkpoint is served by
    serve_cli_best).  The checkpoints (about 1 GB) stay for
    phase_serve_clis, which serves them and deletes them; the log
    (train_log, beside them) stays."""

    from tfswa_tpu_torch.config import Config

    ck, log_dir = TRAIN_CK, os.path.join(HERE, "chiprun_out", "train_log")
    for d in (ck, log_dir):
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    first = run_train_cli(TRAIN_CLI + ["--num_epochs", "2"])
    first_s = time.perf_counter() - t0
    with open(os.path.join(ck, "config.json")) as fh:
        cfg = Config.from_dict(json.load(fh))
    check_cli_launches(first["launches"], cli_designed_launches(cfg, 8, 2, 1), "CLI run")
    shapes = recipe_row_shapes(cfg)
    check_cli_shapes(first["shapes"], shapes, covered, "CLI run")
    layout = sorted(os.listdir(ck))
    want = ["best", "config.json", "epoch_000000", "epoch_000001", "latest"]
    log(f"CLI run: {first_s:.1f} s; checkpoint directory {layout}")
    if layout != want:
        fail(f"checkpoint layout {layout}, expected {want}")
    recs = read_cli_log(np, log_dir)
    n_first = len(recs)

    t0 = time.perf_counter()
    second = run_train_cli(TRAIN_CLI + ["--num_epochs", "3", "--resume", "latest"])
    second_s = time.perf_counter() - t0
    restored = second.get("restored", {})
    log(f"resume: {second_s:.1f} s; restored {restored}")
    if restored.get("mismatches") != [] or restored.get("step") != 8:
        fail(f"resume: the restored state differs from the saved one: {restored}")
    check_cli_launches(second["launches"], cli_designed_launches(cfg, 4, 1, 1), "resumed run")
    check_cli_shapes(second["shapes"], shapes, covered, "resumed run")
    meta = torch.load(os.path.join(ck, "latest", "checkpoint.pt"), map_location="cpu",
                      weights_only=True)["meta"]
    log(f"resume: latest meta {meta}")
    if meta["global_step"] != 12 or meta["epoch"] != 2:
        fail(f"resume: latest meta {meta}, expected global_step 12 and epoch 2")
    recs = read_cli_log(np, log_dir)

    # beside phase 14's subprocesses: the times are taken under their load,
    # so no rate is derived from them
    nums, nums_resumed = ({k: v for k, v in cli_numbers(
        r, cfg.data.batch_size, cfg.data.segment_seconds).items()
        if k != "audio_s_trained_per_s"} for r in (recs[:n_first], recs[n_first:]))
    log(f"CLI run on {gpu}, under phase 14's load (not a training rate): "
        f"{nums['ms_per_step']:.3f} ms/step (mean of the steps after each epoch's first), "
        f"peak memory {nums['peak_mem_gb']:.3f} GB, SDR evaluation {nums['sdr_eval_s']} s; "
        f"resumed run {nums_resumed['ms_per_step']:.3f} ms/step, SDR evaluation "
        f"{nums_resumed['sdr_eval_s']} s")
    return {"first": dict(first, seconds=first_s, **nums),
            "resumed": dict(second, seconds=second_s, **nums_resumed)}


def serve_cli_best(torch, np):
    """Phase 10's best checkpoint served through its route in this process
    (10 s of audio: 66 launches of B1 and none of another kernel, finite
    stems of the input's length); run where no other thread launches a
    kernel, since the launch counts are the process's."""
    from tfswa_tpu_torch.config import Config
    from tfswa_tpu_torch.evaluation import load_separator_from_checkpoint

    with open(os.path.join(TRAIN_CK, "config.json")) as fh:
        cfg = Config.from_dict(json.load(fh))
    sep = load_separator_from_checkpoint(
        os.path.join(TRAIN_CK, "best", "checkpoint.pt"), model_config=cfg.model,
        stft_config=cfg.stft, eval_config=cfg.eval, stem_names=cfg.data.stems, device="cuda")
    audio = synthetic_track(np, 10.0, sep.sample_rate)
    reset_counts()
    out = sep.separate(audio)
    torch.cuda.synchronize()
    served = read_counts()
    finite = all(np.isfinite(v).all() and v.shape == (1, audio.size) for v in out.values())
    log(f"best checkpoint served through {cfg.model.attention_impl}: 10 s, launches {served}, "
        f"finite {finite}")
    if served != {k: (66 if k == "B1" else 0) for k in served} or not finite:
        fail(f"serving the best checkpoint: launches {served}, finite {finite}")
    return served


def make_separator(torch, impl: str, mesh=None, dtype: str = "bfloat16", **model_kw):
    from tfswa_tpu_torch.config import EvalConfig, ModelConfig, STFTConfig
    from tfswa_tpu_torch.evaluation import SourceSeparator
    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    cfg = ModelConfig(in_channels=4, out_channels=4, attention_impl=impl,
                      dtype=dtype, **model_kw)
    model = TFSWAUNet.from_config(cfg, generator=torch.Generator().manual_seed(0))
    ev = EvalConfig.fast_serving()
    return SourceSeparator(
        model, STFTProcessor(STFTConfig(n_fft=2048, hop_length=512)),
        segment_length=ev.segment_seconds, overlap=ev.overlap,
        mask_mode=ev.mask_mode, segment_batch=ev.segment_batch,
        transfer_dtype=ev.transfer_dtype, device_ola=ev.device_ola,
        ola_bucket_seconds=ev.ola_bucket_seconds, freq_policy=ev.freq_policy,
        device="cuda", mesh=mesh)


def synthetic_track(np, seconds: float, sr: int):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def counters():
    """The launch counter of every kernel, by kernel: (wrapper, attribute),
    from the tools' table of kernels (tools/_common.py KERNELS); the f32
    forms ("-f32") count on the same wrappers apart."""
    from tfswa_tpu_torch.tools._common import KERNELS

    return {**{k: (w, "launches") for k, w in KERNELS.items()},
            **{f"{k}-f32": (w, "launches_f32") for k, w in KERNELS.items()}}


def reset_counts() -> None:
    for wrapper, attr in counters().values():
        setattr(wrapper, attr, 0)


def read_counts():
    from tfswa_tpu_torch.tools._common import counts

    return counts()


# the kernel each serving route runs, and the device kernels it is made of
# (names as torch.profiler reports them)
ROUTES = {
    "pallas": ("B1", ("ln_qkv_kernel", "k_norm_kernel", "attn_kernel", "attn_wide_kernel",
                      "post_kernel")),
    "pallas_int8": ("B3", ("ln_qkv_kernel", "qk_scale_kernel", "k_norm_kernel", "attn_kernel",
                           "attn_wide_kernel", "post_kernel")),
    "pallas_attn": ("B4", ("proj_kernel", "bilinear_attn_kernel", "bilinear_attn_any_kernel")),
}


# separations of the 120 s track timed after the warm-up, per route
SERVING_RUNS = {"pallas": 1, "pallas_int8": 1, "pallas_attn": 1}   # one rate run: the run's time


def phase_main_path(torch, np, gpu: str, impl: str, model_kw=None, runs=None):
    """The serving main path through one route: a warm-up separation of the
    120 s track, a counted one (every launch counter set to 0 just before
    and read just after: the route's kernel 66 times a model forward, no
    other kernel), and more for the rate (``runs``, default SERVING_RUNS,
    in all).  ``model_kw``: ModelConfig fields other than the flagship's."""
    kernel, n_runs = ROUTES[impl][0], runs
    sep = make_separator(torch, impl, **(model_kw or {}))
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
    for _ in range((n_runs or SERVING_RUNS[impl]) - 1):
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


def phase_routes(torch, np, sep_kernel, impl: str, against, **model_kw):
    """One 10 s segment through the kernel route ``impl`` and through each
    route of ``against`` (same weights, the same ``model_kw``): the SNR per
    stem.  The plain route ("xla") is held to SNR_MIN_DB; the others are
    recorded."""
    seg = synthetic_track(np, 10.0, sep_kernel.sample_rate)[None]
    res = {}
    with torch.inference_mode():
        x = torch.from_numpy(seg).cuda()
        a = sep_kernel._separate_core(x).double().cpu().numpy()
        for other in against:
            sep_other = make_separator(torch, other, **model_kw)
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


# ------------------------------------------------ the serving entry points
# the separate_stream phase's tracks, seconds: two through the device OLA,
# the last (one segment or less) through separate()
STREAM_TRACKS = (120.0, 75.0, 8.0)
STREAM_RUNS = 1                  # one rate run: the run's time
SERVE_WORK = os.path.join(HERE, "chiprun_out", "serve_work")
# the serving CLI's inputs: (seconds, sample rate) of two stereo WAVs
CLI_INPUTS = ((120.0, 44100), (30.0, 48000))
# the evaluation CLI's tracks: 2 of the synthetic set (30 s), then a custom
# dataset of 2 tracks of CUSTOM_SECONDS
EVAL_TRACKS, CUSTOM_SECONDS = 2, 20.0


def track_forwards(sep, total: int) -> int:
    """Model forwards of one separate() of ``total`` samples: one batch of
    one for a track of one segment or less; with device OLA, each window's
    K segments in batches of the size the separator picks; on the host
    path ceil(segments / segment_batch)."""
    seg, hop = sep.segment_samples, sep.hop_samples
    if total <= seg:
        return 1
    if not sep.device_ola:
        return -(-((total - seg) // hop + 1) // sep.segment_batch)
    K = sep.ola_window_segments
    bs = min(range(1, sep.segment_batch + 1), key=lambda b: ((-(-K // b)) * b - K, -b))
    n_seg = -(-(total - seg) // hop) + 1
    return -(-n_seg // K) * -(-K // bs)


def d2h_bytes(sep, total: int) -> int:
    """Bytes one device-OLA track sends back to the host: each window's
    (n_stems, W) accumulation in the transfer dtype, or under "int8" its
    int8 codes and the scales, padded to 8 float32."""
    seg, hop, K = sep.segment_samples, sep.hop_samples, sep.ola_window_segments
    W = (K - 1) * hop + seg
    n_seg = -(-(total - seg) // hop) + 1
    n_win = -(-n_seg // K)
    if sep.int8_output:
        return n_win * (sep.n_stems * W + 4 * max(8, sep.n_stems))
    return n_win * sep.n_stems * W * sep.transfer_dtype.itemsize


def resampled_frames(frames: int, sr_in: int, sr_out: int) -> int:
    """Frames of scipy's resample_poly output: ceil(frames * up / down)."""
    g = math.gcd(sr_in, sr_out)
    return -(-frames * (sr_out // g) // (sr_in // g))


def int8_step(scale: float) -> float:
    """One step of the int8 output codec at a scale: the codec rounds each
    window's acc / env to steps of its largest magnitude (the window's
    scale) / 127, and a track's stems are held to one step of their peak."""
    return scale / 127.0


def int8_window_errors(torch, np, sep8, sep32, audio):
    """The int8 codec on each device-OLA window of ``audio``, against the
    same window's float32 accumulation: both separators (int8 and float32
    transfers, one model) get the same float16 window, so only the codec
    differs.  -> (max |decoded - acc / env|, scale) per window and stem;
    the codec's rounding bounds the first by half a step of the second."""
    seg, hop, K = sep8.segment_samples, sep8.hop_samples, sep8.ola_window_segments
    W = (K - 1) * hop + seg
    n_seg = -(-max(audio.size - seg, 0) // hop) + 1
    n_win = -(-n_seg // K)
    from tfswa_tpu_torch.evaluation.inference import _hann

    track = sep8._encode_host(np.pad(audio, (0, ((n_win * K - 1) * hop + seg) - audio.size)))
    hann = _hann(seg)
    out = []
    with torch.inference_mode():
        for w in range(n_win):
            nv = min(K, n_seg - w * K)
            x = sep8._put(track[w * K * hop:w * K * hop + W])
            q, scales = (sep8._host(sep8._fetch(t)) for t in sep8._device_ola_window(x, nv))
            acc = sep32._host(sep32._fetch(sep32._device_ola_window(x, nv)))
            env = np.zeros(W, np.float32)
            for i in range(nv):
                env[i * hop:i * hop + seg] += hann
            y = acc / np.maximum(env, 1e-12)[None]
            scales = scales[: sep8.n_stems].astype(np.float32)
            dec = q.astype(np.float32) * (scales / 127.0)[:, None]
            out.append([(float(np.abs(dec[i] - y[i]).max()), float(scales[i]))
                        for i in range(sep8.n_stems)])
    return out


def served_shapes():
    """The (N, C) the fast serving preset gives B1, which phase 2 checks."""
    return {(N, C) for _, _, N, C, _ in SHAPES}


def sync_counts(prof):
    """Host waits on the device in a torch.profiler trace: the calls that
    read a device value (``aten::_local_scalar_dense``, e.g. ``.item()``)
    and the CUDA runtime's synchronising calls."""
    keys = ("aten::_local_scalar_dense", "cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaDeviceSynchronize", "cudaMemcpy")
    return {e.key: e.count for e in prof.key_averages() if e.key in keys}


def phase_stream(torch, np, gpu: str):
    """separate_stream of three tracks (120, 75 and 8 s) with two in flight,
    the flagship bf16 model through "pallas" with the fast serving knobs:
    each result equal to its own separate() bit for bit; B1 launched 66
    times a forward and no other kernel; audio-s/s of the stream against
    the three separate() calls, best of STREAM_RUNS each; the idle share
    and the host's waits on the device in one profiled stream."""
    from torch.profiler import ProfilerActivity, profile

    sep = make_separator(torch, "pallas")
    tracks = [synthetic_track(np, t, sep.sample_rate) for t in STREAM_TRACKS]
    total_s = sum(STREAM_TRACKS)
    singles = [sep.separate(a) for a in tracks]           # warm-up, and the reference
    torch.cuda.synchronize()
    reset_counts()
    outs = sep.separate_stream(tracks, max_in_flight=2)
    counts = read_counts()
    forwards = sum(track_forwards(sep, a.size) for a in tracks)
    want = {k: (66 * forwards if k == "B1" else 0) for k in counts}
    log(f"stream: {len(tracks)} tracks {STREAM_TRACKS} s, launches {counts} (designed "
        f"{want}: {forwards} forwards)")
    if counts != want:
        fail(f"stream: expected launches {want}, got {counts}")
    for t, out, single in zip(STREAM_TRACKS, outs, singles):
        for name, wav in out.items():
            diff = float(np.abs(wav - single[name]).max())
            if wav.shape != (1, int(t * sep.sample_rate)) or not np.isfinite(wav).all():
                fail(f"stream: {t} s track, stem {name}: shape {wav.shape} or non-finite values")
            if not np.array_equal(wav, single[name]):
                fail(f"stream: {t} s track, stem {name} differs from separate() by up to {diff}")
    log("stream: every stem of every track equals its separate() bit for bit")

    stream_s, seq_s = [], []
    for _ in range(STREAM_RUNS):
        t0 = time.perf_counter()
        sep.separate_stream(tracks, max_in_flight=2)
        stream_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for a in tracks:
            sep.separate(a)
        seq_s.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sep.separate_stream(tracks, max_in_flight=2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = device_kernels(prof)
    busy_ms = sum(k[1] for k in kernels)
    syncs = sync_counts(prof)
    res = {"tracks_s": list(STREAM_TRACKS), "launches": counts, "forwards": forwards,
           "stream_s": stream_s, "sequential_s": seq_s,
           "stream_audio_s_per_s": total_s / min(stream_s),
           "sequential_audio_s_per_s": total_s / min(seq_s),
           "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                       "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
                       "host_waits": syncs}}
    log(f"stream on {gpu}: {res['stream_audio_s_per_s']:.4f} audio-s/s (runs "
        f"{[round(t, 4) for t in stream_s]} s) against separate() one track at a time "
        f"{res['sequential_audio_s_per_s']:.4f} (runs {[round(t, 4) for t in seq_s]} s)")
    log("stream profile: wall {:.3f} ms, device busy {:.3f} ms, idle share {}; host waits "
        "{}".format(wall_ms, busy_ms, "not measured" if not busy_ms else
                    f"{res['profile']['idle_share']:.4f}", syncs))
    return res, sep, tracks[0]


def phase_int8(torch, np, gpu: str, sep, audio):
    """The 120 s track through the int8 output codec, float16 and float32
    transfers (the same model).  The codec on each window against the same
    window's float32 accumulation (int8_window_errors): within half a step
    of the window's scale.  The int8 track against the float16 one (the
    same float16 input) within one step of each stem's peak (int8_step)
    where the Hann envelope is at least 0.5, as the CPU tests hold float16:
    below it, on the first quarter segment, float16 underflows (acc is
    weighted by a Hann near 0 before the transfer).  Against the float32
    transfers, whose input is float32 and so moves the bf16 model's
    roundings, the distance and SNR are recorded.  Audio-s/s of int8 and
    float16, best of STREAM_RUNS, and the bytes a track sends back."""
    from tfswa_tpu_torch.evaluation import SourceSeparator

    seps = {td: SourceSeparator(sep.model, sep.stft_processor, segment_length=sep.segment_length,
                                overlap=sep.overlap, segment_batch=sep.segment_batch,
                                transfer_dtype=td, device_ola=True,
                                ola_bucket_seconds=sep.ola_bucket_samples / sep.sample_rate,
                                freq_policy=sep.freq_policy, device="cuda")
            for td in ("int8", "float16", "float32")}
    outs, runs = {}, {}
    for td, s in seps.items():
        s.separate(audio)                                  # warm-up
        times = []
        for _ in range(STREAM_RUNS if td != "float32" else 1):
            reset_counts()
            t0 = time.perf_counter()
            outs[td] = s.separate(audio)
            times.append(time.perf_counter() - t0)
            got = read_counts()
            if got != {k: (66 * track_forwards(s, audio.size) if k == "B1" else 0)
                       for k in got}:
                fail(f"{td} codec: launches {got}")
        runs[td] = times
    windows = int8_window_errors(torch, np, seps["int8"], seps["float32"], audio)
    worst = max(e / int8_step(sc) for win in windows for e, sc in win)
    log(f"int8 codec, each window against its float32 accumulation (same input): worst "
        f"{worst:.4f} of a step of the window's scale (limit 0.501); (error, scale) "
        f"{[[(round(e, 6), round(sc, 4)) for e, sc in win] for win in windows]}")
    if not worst <= 0.501:
        fail(f"int8 codec: a window's decoded acc / env off by {worst} steps of its scale")
    res = {"runs_s": runs, "stems": {}, "windows": windows, "worst_window_steps": worst}
    tail = slice(sep.hop_samples // 3, None)               # the Hann envelope >= 0.5
    for name, exact in outs["float32"].items():
        peak = float(np.abs(exact).max())
        i8, f16 = outs["int8"][name], outs["float16"][name]
        vs16 = float(np.abs(i8 - f16)[:, tail].max())
        errs = {td: float(np.abs(outs[td][name] - exact).max()) for td in ("int8", "float16")}
        snrs = {td: float(10 * np.log10(np.sum(exact.astype(np.float64) ** 2) / max(
            np.sum((outs[td][name] - exact).astype(np.float64) ** 2), 1e-30)))
            for td in ("int8", "float16")}
        res["stems"][name] = {"peak": peak, "int8_vs_float16": vs16, "step": int8_step(peak),
                              "int8_vs_float16_whole": float(np.abs(i8 - f16).max()),
                              "vs_float32": errs, "snr_db_vs_float32": snrs}
        log(f"int8 codec, stem {name}: max |int8 - f16| {vs16:.6f} where the envelope >= 0.5 "
            f"(limit one step {int8_step(peak):.6f} of peak {peak:.4f}; the whole track "
            f"{res['stems'][name]['int8_vs_float16_whole']:.6f}); against float32 transfers: "
            f"int8 {errs['int8']:.6f} ({errs['int8'] / int8_step(peak):.3f} steps), SNR "
            f"{snrs['int8']:.2f} dB, float16 {errs['float16']:.6f}, SNR {snrs['float16']:.2f} dB")
        if not vs16 <= int8_step(peak):
            fail(f"int8 codec, stem {name}: {vs16} from float16 above one step {int8_step(peak)}")
    for td in ("int8", "float16"):
        res[td] = {"audio_s_per_s": audio.size / sep.sample_rate / min(runs[td]),
                   "d2h_bytes_a_track": d2h_bytes(seps[td], audio.size)}
        log(f"{td} codec on {gpu}: {res[td]['audio_s_per_s']:.4f} audio-s/s (runs "
            f"{[round(t, 4) for t in runs[td]]} s), {res[td]['d2h_bytes_a_track']} bytes "
            f"device to host a {audio.size / sep.sample_rate:.0f} s track")
    return res


# Runs a CLI module as __main__ with the given arguments and prints, as its
# last line, the launches of each kernel in the whole process, the (N, C)
# of each kernel's launches and the seconds of each top-level separate().
SERVE_RUNNER = r"""
import json, runpy, sys, time
import chip_smoke as cs
from tfswa_tpu_torch.evaluation import inference
from tfswa_tpu_torch.ops import fused_block as fb
out = {"shapes": {}, "separate_s": []}
forward = fb._forward_kernel

def forward_seen(rows, p, num_heads, train=False, int8=False):
    seen = out["shapes"].setdefault("B1-train" if train else "B3" if int8 else "B1", [])
    if list(rows.shape[1:]) not in seen:
        seen.append(list(rows.shape[1:]))
    return forward(rows, p, num_heads, train, int8)

fb._forward_kernel = forward_seen
separate = inference.SourceSeparator.separate

def timed(self, *a, **k):
    t0 = time.perf_counter()
    r = separate(self, *a, **k)
    out["separate_s"].append(time.perf_counter() - t0)
    return r

inference.SourceSeparator.separate = timed
cs.reset_counts()
sys.argv = [sys.argv[1]] + json.loads(sys.argv[2])
runpy.run_module(sys.argv[0], run_name="__main__")
out["launches"] = cs.read_counts()
print(json.dumps(out))
"""


def run_serve_cli(module: str, argv):
    """A serving or evaluation CLI in a subprocess from the checkout
    (SERVE_RUNNER): its output lines, its last line's record and its
    seconds."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", SERVE_RUNNER, module, json.dumps(argv)],
                         cwd=HERE, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    for line in lines:
        log(f"  | {line[:300]}")
    if res.returncode != 0:
        fail(f"{module} {' '.join(argv)} exited {res.returncode}:\n{res.stderr[-3000:]}")
    return lines, dict(json.loads(lines[-1]), seconds=seconds)


def check_serve_launches(rec, forwards: int, label: str) -> None:
    """66 B1 launches a forward, no other kernel, at the served (N, C)."""
    want = {k: (66 * forwards if k == "B1" else 0) for k in rec["launches"]}
    shapes = {tuple(s) for s in rec["shapes"].get("B1", [])}
    log(f"{label}: launches {rec['launches']} (designed {want}: {forwards} forwards), B1 at "
        f"(N, C) {sorted(shapes)}; {rec['seconds']:.1f} s")
    if rec["launches"] != want or set(rec["shapes"]) - {"B1"}:
        fail(f"{label}: expected launches {want}, got {rec['launches']} {rec['shapes']}")
    if not shapes <= served_shapes():
        fail(f"{label}: B1 launched at (N, C) never checked: {shapes - served_shapes()}")


def phase_serve_clis(torch, np, gpu: str, design):
    """The serving and evaluation entry points in subprocesses, on phase
    10's checkpoint directory (its best/, with the ModelConfig of its
    config.json: bf16, "pallas").  python -m tfswa_tpu_torch.cli.separate
    --preset fast on a 120 s WAV at 44.1 kHz and a 30 s WAV at 48 kHz, once
    with --stream and once through BatchSeparator: every stem PCM16 at 44.1
    kHz and as long as its resampled input, the two runs within one PCM16
    step, B1's launches as designed.  python -m tfswa_tpu_torch.cli.evaluate
    --preset fast on 2 synthetic tracks, then on a custom dataset of 2
    tracks: results.json with every track, finite metrics and the
    aggregate, B1's launches as designed.  ``design`` is a separator with
    the CLIs' knobs (the fast preset at the default STFT), from which the
    launches are designed (track_forwards)."""
    from tfswa_tpu_torch.data.synthetic import SyntheticDataset
    from tfswa_tpu_torch.data.wav import wav_info, wav_read, write_wav

    work = SERVE_WORK
    os.makedirs(work, exist_ok=True)
    res = {}

    inputs, frames = [], []
    for i, (secs, sr) in enumerate(CLI_INPUTS):
        path = os.path.join(work, f"in{i}_{sr}.wav")
        write_wav(path, np.stack([synthetic_track(np, secs, sr)] * 2) * 0.9, sr)
        inputs.append(path)
        frames.append(resampled_frames(int(secs * sr), sr, 44100))
    forwards = sum(track_forwards(design, n) for n in frames)
    stems = {}
    ds = SyntheticDataset(num_tracks=EVAL_TRACKS, track_seconds=CUSTOM_SECONDS, seed=7)
    mix_dir, ref_dir = os.path.join(work, "mix"), os.path.join(work, "refs")
    os.makedirs(mix_dir, exist_ok=True)
    for i in range(EVAL_TRACKS):
        mix, refs = ds.get_full_track(i)
        os.makedirs(os.path.join(ref_dir, f"t{i}"), exist_ok=True)
        write_wav(os.path.join(mix_dir, f"t{i}.wav"), mix, 44100)
        for stem, ref in refs.items():
            write_wav(os.path.join(ref_dir, f"t{i}", f"{stem}.wav"), ref, 44100)
    evals = (("synthetic", ["--synthetic", "--max_tracks", str(EVAL_TRACKS)], 30.0),
             ("custom", ["--mixtures_dir", mix_dir, "--references_dir", ref_dir],
              CUSTOM_SECONDS))
    # the four CLIs' processes run at once on the card: their host work
    # overlaps; each counts its own launches
    jobs = [("tfswa_tpu_torch.cli.separate", ["--checkpoint", TRAIN_CK, "--preset", "fast",
                                              "-o", os.path.join(work, mode), *extra, *inputs])
            for mode, extra in (("stream", ["--stream"]), ("batch", []))]
    jobs += [("tfswa_tpu_torch.cli.evaluate", ["--checkpoint", TRAIN_CK, "--preset", "fast",
                                               "--no_museval", "--output_dir",
                                               os.path.join(work, f"eval_{mode}"), *extra])
             for mode, extra, _ in evals]
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(lambda job: run_serve_cli(*job), jobs))
    for mode, extra in (("stream", ["--stream"]), ("batch", [])):
        out_dir = os.path.join(work, mode)
        lines, rec = done[0 if mode == "stream" else 1]
        oks = [ln for ln in lines[:-1] if ": ok {" in ln]
        if len(oks) != len(inputs):
            fail(f"cli.separate {mode}: not every file separated: {lines[:-1]}")
        check_serve_launches(rec, forwards, f"cli.separate {mode}")
        for path, n in zip(inputs, frames):
            base = os.path.splitext(os.path.basename(path))[0]
            for stem in ("vocals", "other"):
                f = os.path.join(out_dir, f"{base}_{stem}.wav")
                info = wav_info(f)
                if info != (n, 1, 44100):
                    fail(f"cli.separate {mode}: {f}: (frames, channels, rate) {info}, "
                         f"expected ({n}, 1, 44100)")
                stems.setdefault((base, stem), []).append(wav_read(f, 0, n, 1))
        res[f"separate_{mode}"] = rec
    worst = max(float(np.abs(a - b).max()) for a, b in stems.values()) * 32768
    log(f"cli.separate: stream and BatchSeparator stems differ by at most {worst:.1f} PCM16 "
        f"steps (limit 1)")
    if worst > 1.0:
        fail(f"cli.separate: the two runs' stems differ by {worst} PCM16 steps")
    res["separate_runs_max_pcm_steps"] = worst

    for j, (mode, extra, secs) in enumerate(evals):
        out_dir = os.path.join(work, f"eval_{mode}")
        rec = done[2 + j][1]
        check_serve_launches(rec, EVAL_TRACKS * track_forwards(design, int(secs * 44100)),
                             f"cli.evaluate {mode}")
        with open(os.path.join(out_dir, "results.json")) as fh:
            results = json.load(fh)
        values = [v for t in results["tracks"].values() for m in t.values() for v in m.values()]
        agg = results["aggregated"]
        if (len(results["tracks"]) != EVAL_TRACKS or not values
                or not all(math.isfinite(v) for v in values)
                or not math.isfinite(agg.get("overall", {}).get("sdr_mean", math.nan))):
            fail(f"cli.evaluate {mode}: results.json holds {len(results['tracks'])} tracks "
                 f"(expected {EVAL_TRACKS}), finite {values}, aggregate {agg}")
        rec["results"] = results
        log(f"cli.evaluate {mode} on {gpu}: {len(results['tracks'])} tracks of {secs:.0f} s, "
            f"separate() {[round(t, 3) for t in rec['separate_s']]} s a track, "
            f"{rec['seconds'] / EVAL_TRACKS:.2f} s a track with the process; overall SDR "
            f"{agg['overall']['sdr_mean']:.3f} dB")
        res[f"evaluate_{mode}"] = rec
    return res


MRSTFT_SEGMENTS = 2


def phase_mrstft(torch, np, gpu: str, plain_ms):
    """The MR-STFT train step (TrainConfig's weight 0.5) on phase 7's fixed
    batch through "pallas": 66 B1-train + 66 B2 launches a step and no
    other kernel, best of 3 steps after the first, peak GB; its first step
    against the plain route's at phase 8's limits (loss within 1e-2 rel.,
    gradient cosine >= 0.99), the plain route computing in float32.  The
    loss's log-magnitude term weighs each STFT bin by 1 / (|X| + 1e-5), so
    its gradient follows the phase of near-silent bins, which bf16 compute
    moves: two bf16 routes miss the float32 gradient each by about as much,
    in different directions.  So the plain route in bf16 is run too, and
    its cosines with the other two are recorded.  The steps take the first
    MRSTFT_SEGMENTS of phase 7's segments (the plain routes' steps take
    most of the phase's time)."""
    mix, targets = train_batch(torch, np)
    mix, targets = mix[:MRSTFT_SEGMENTS], {k: v[:MRSTFT_SEGMENTS] for k, v in targets.items()}
    res, grads = {}, {}
    for impl, dtype in (("pallas", "bfloat16"), ("xla", "bfloat16"), ("xla", "float32")):
        key = f"{impl}_{dtype}"
        state, step = make_trainer(torch, impl, mrstft=True, dtype=dtype)[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        grads[key] = torch.cat([p.grad.flatten() for p in state.model.parameters()]).double()
        res[key] = {k: float(v) for k, v in loss.items()}
        if impl == "pallas":
            times, per_step = [], []
            for _ in range(3):
                reset_counts()
                t0 = time.perf_counter()
                step(state, mix, targets)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                per_step.append(read_counts())
            want = {k: step_launches().get(k, 0) for k in per_step[0]}
            res.update(launches=per_step, step_s=times, best_ms_per_step=min(times) * 1e3,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            log(f"MR-STFT step pallas: launches per step {per_step} (designed {want}); "
                f"loss {res[key]['total_loss']:.6f} (mrstft {res[key]['mrstft_loss']:.6f}); "
                f"steps {[round(t * 1e3, 3) for t in times]} ms, best "
                f"{res['best_ms_per_step']:.3f} ms/step on {MRSTFT_SEGMENTS} segments "
                f"({plain_ms:.3f} without it on phase 7's {TRAIN_BATCH}), peak memory "
                f"{res['peak_mem_gb']:.3f} GB on {gpu}")
            if any(c != want for c in per_step):
                fail(f"MR-STFT step: expected launches {want} a step, got {per_step}")
        del state, step
        torch.cuda.empty_cache()

    def cos(a, b):
        return float((grads[a] @ grads[b]) / (grads[a].norm() * grads[b].norm()))

    ref, kern, bf16 = "xla_float32", "pallas_bfloat16", "xla_bfloat16"
    rel = abs(res[kern]["total_loss"] - res[ref]["total_loss"]) / abs(res[ref]["total_loss"])
    finite = all(math.isfinite(v) for k in (kern, bf16, ref) for v in res[k].values())
    res.update(loss_rel=rel, grad_cosine=cos(kern, ref),
               plain_bf16_cosine=cos(bf16, ref), kernel_vs_plain_bf16_cosine=cos(kern, bf16))
    log(f"MR-STFT step, route pallas vs plain route in float32: loss {res[kern]['total_loss']:.6f}"
        f" vs {res[ref]['total_loss']:.6f} (rel {rel:.2e}, limit 1e-2), gradient cosine "
        f"{res['grad_cosine']:.6f} (min 0.99); the plain route in bf16 against float32 "
        f"{res['plain_bf16_cosine']:.6f}, pallas against it {res['kernel_vs_plain_bf16_cosine']:.6f}")
    if not (finite and rel <= 1e-2 and res["grad_cosine"] >= 0.99):
        fail(f"MR-STFT step vs plain route: loss rel {rel}, gradient cosine "
             f"{res['grad_cosine']}, finite {finite}")
    return res


def phase_serving_entry(torch, np, gpu: str, plain_ms):
    """Phase 11: the stream, the int8 codec, the two CLIs on phase 10's
    checkpoints, the MR-STFT step.  The CLIs' WAVs are deleted after them,
    and after a failure too."""
    res, seconds = {}, {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        log(f"  {name}: {seconds[name]:.1f} s")
        return out

    res["stream"], sep, track = part("stream", phase_stream, torch, np, gpu)
    res["int8"] = part("int8", phase_int8, torch, np, gpu, sep, track)
    torch.cuda.empty_cache()
    try:
        res["clis"] = part("clis", phase_serve_clis, torch, np, gpu, sep)
    finally:
        shutil.rmtree(SERVE_WORK, ignore_errors=True)
    del sep
    torch.cuda.empty_cache()
    res["mrstft"] = part("mrstft", phase_mrstft, torch, np, gpu, plain_ms)
    res["seconds"] = seconds
    return res


# ------------------------------------------------ phase 12: the model's options
# and the deployment path
OPT_BATCH = (8, 4, 1024, 862)        # 8 x 10 s segments at the fast-serving knobs
MASKED_BATCH = (4, 4, 1024, 862)     # (a)'s forwards: half of them, for the run's time limit
# 2 s of audio (87 frames) with the flagship's 4 channels: the JAX export
# default's 1025 bins, its 259 frames (6 s) cut for the run's time limit
EXPORT_SHAPE = (1, 4, 1025, 87)
EXPORT_DEPTHS = (1, 1, 1, 1)         # the export round trips' depth (widths full)
DROPOUT = 0.1
# the dropout steps take the first segment of phase 7's batch: the plain
# route is host-bound, 21.4-23.9 s a step at all 4 segments on an H100
DROPOUT_SEGMENTS = 1
# the run's time (PR 14, phase 16): the dropout step on the segment's first
# DROPOUT_SECONDS (its 6 s until then), the int8 separation on a track of
# INT8_TRACK_SECONDS (120 s), the int8 tool at 3 s segments (and 10 s)
DROPOUT_SECONDS = 3.0
INT8_TRACK_SECONDS = 60.0
OPT_WORK = os.path.join(HERE, "chiprun_out", "opt_work")


def shifted_blocks(depths=(2, 2, 6, 2)) -> int:
    """TFSWABlocks whose SWA is shifted: the odd indices of each stage
    (encoder, bottleneck, decoder; JAX tfswa_unet.py:75)."""
    return sum(d // 2 for d in (*depths[:3], depths[3], *depths[:3]))


def forward_launches(depths=(2, 2, 6, 2), masked: bool = False) -> int:
    """B1 launches of one "pallas" forward: three row blocks a TFSWABlock,
    less the shifted SWAs when the shift mask sends them to the plain route."""
    blocks = 2 * sum(depths[:3]) + depths[3]
    return 3 * blocks - (shifted_blocks(depths) if masked else 0)


def dense_mask_gb(batch: int, F: int, T: int, ws: int = 8) -> float:
    """GB of the dense per-window shift mask of a batch at stage 0, f32:
    batch x windows x (ws^2)^2 x 4 bytes (windows of the padded map)."""
    windows = -(-F // ws) * -(-T // ws)
    return batch * windows * (ws * ws) ** 2 * 4 / 1e9


def rel_max(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def condition_weights(torch, np, model, seed: int = 0) -> None:
    """Weights whose sigmoid head does not saturate (at the seed's init every
    flagship output is exactly 0 or 1): convs x0.4, as the CPU tests have
    them, and BatchNorm parameters and statistics drawn from numpy ``seed``
    (mean 0.05 N, var U(0.5, 1.5), gamma 1 + 0.1 N, beta 0.05 N)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.weight.mul_(0.4)
            elif isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.running_mean, 0.05 * rng.standard_normal(c)),
                             (m.running_var, rng.uniform(0.5, 1.5, c)),
                             (m.weight, 1.0 + 0.1 * rng.standard_normal(c)),
                             (m.bias, 0.05 * rng.standard_normal(c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))


def opt_model(torch, np, impl: str = "pallas", dtype: str = "bfloat16", **kw):
    """The flagship with weights from seed 0, conditioned, on the card."""
    from tfswa_tpu_torch.config import ModelConfig
    from tfswa_tpu_torch.models import TFSWAUNet

    cfg = ModelConfig(in_channels=4, out_channels=4, attention_impl=impl, dtype=dtype, **kw)
    model = TFSWAUNet.from_config(cfg, generator=torch.Generator().manual_seed(0))
    condition_weights(torch, np, model)
    return model.cuda().eval()


def opt_input(torch, shape=OPT_BATCH, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).cuda()


def counted_forward(torch, model, x, **kw):
    """One forward under inference_mode with every launch counter set to 0
    just before: (output, launches, seconds, peak GB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(x, **kw)
    torch.cuda.synchronize()
    return (out, read_counts(), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9)


def separator_with(torch, model, impl: str, **model_kw):
    """A fast-serving separator through ``impl`` with ``model``'s weights."""
    sep = make_separator(torch, impl, **model_kw)
    sep.model.load_state_dict(model.state_dict())
    return sep


def opt_masked(torch, np, gpu: str):
    """(a) masked SWA through "pallas": the launches (B1 only, 55), ms a
    forward and peak GB against the unmasked forward, the route SNR against
    every block on the plain route, and the output moved by the mask."""
    res = {}
    x = opt_input(torch, MASKED_BATCH)
    want = forward_launches(masked=True)
    for masked in (False, True):
        model = opt_model(torch, np, use_shift_mask=masked)
        counted_forward(torch, model, x)                         # warm-up
        out, counts, sec, peak = counted_forward(torch, model, x)
        res["masked" if masked else "unmasked"] = {"ms": sec * 1e3, "peak_gb": peak,
                                                   "launches": counts}
        log(f"opt (a): {'masked' if masked else 'unmasked'} forward of {MASKED_BATCH}: "
            f"{sec * 1e3:.3f} ms, peak {peak:.3f} GB, launches {counts} on {gpu}")
        if masked and counts != {k: (want if k == "B1" else 0) for k in counts}:
            fail(f"masked forward: expected {want} B1 launches and no other, got {counts}")
        del model, out
        torch.cuda.empty_cache()
    extra = res["masked"]["peak_gb"] - res["unmasked"]["peak_gb"]
    dense = dense_mask_gb(MASKED_BATCH[0], MASKED_BATCH[2], MASKED_BATCH[3])
    res.update(extra_peak_gb=extra, dense_mask_gb=dense)
    log(f"opt (a): the mask adds {extra:.3f} GB of peak (limit: a quarter of the "
        f"{dense:.3f} GB a dense mask would take)")
    if not extra < dense / 4:
        fail(f"masked forward: {extra} GB over the unmasked peak, limit {dense / 4}")
    masked = separator_with(torch, opt_model(torch, np, use_shift_mask=True), "pallas",
                            use_shift_mask=True)
    res["route_snr_db"] = phase_routes(torch, np, masked, "pallas", ("xla",),
                                       use_shift_mask=True)
    seg = torch.from_numpy(synthetic_track(np, 10.0, masked.sample_rate)[None]).cuda()
    unmasked = separator_with(torch, masked.model, "pallas")
    with torch.inference_mode():
        a = masked._separate_core(seg).double()
        b = unmasked._separate_core(seg).double()
    moved = float((a - b).abs().max())
    res["masked_vs_unmasked_max_abs"] = moved
    log(f"opt (a): masked vs unmasked output, one 10 s segment: max |diff| {moved:.4e}")
    if not moved > 0:
        fail("masked SWA: the output equals the unmasked model's")
    return res


def opt_dropout(torch, np, gpu: str, segments: int = DROPOUT_SEGMENTS):
    """(b) dropout 0.1: eval through "pallas" bit-identical to dropout 0 with
    66 B1 launches; one train step on the first ``segments`` of phase 7's
    batch with no kernel launch (every row block on the plain route),
    finite non-zero row-block gradients, the loss equal bit for bit across
    two runs from the same weights and seed; the same step with remat
    within 1e-3 rel. and a gradient cosine >= 0.999."""
    res = {}
    x = opt_input(torch)
    a = opt_model(torch, np, dropout=DROPOUT)
    b = opt_model(torch, np)
    out_a, counts, _, _ = counted_forward(torch, a, x,
                                          generator=torch.Generator().manual_seed(0))
    out_b = counted_forward(torch, b, x)[0]
    equal = bool(torch.equal(out_a, out_b))
    log(f"opt (b): eval with dropout {DROPOUT} vs 0: bit-identical {equal}, launches {counts}")
    if not equal or counts != {k: (66 if k == "B1" else 0) for k in counts}:
        fail(f"dropout in eval mode: equal {equal}, launches {counts}")
    del a, b, out_a, out_b
    torch.cuda.empty_cache()

    mix, targets = train_batch(torch, np)
    n = int(DROPOUT_SECONDS * 44100)
    mix, targets = mix[:segments, ..., :n], {k: v[:segments, ..., :n] for k, v in targets.items()}
    runs = {}
    for label, remat in (("first", False), ("again", False), ("remat", True)):
        state, step = make_trainer(torch, "pallas", remat=remat, dropout=DROPOUT)[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        grads = row_block_grads(state.model)
        bad = [n for n, g in grads if g is None or not bool(torch.isfinite(g).all())
               or not bool((g != 0).any())]
        runs[label] = {"loss": float(loss["total_loss"]), "ms": sec * 1e3,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": counts,
                       "grad": torch.cat([p.grad.flatten().double()
                                          for p in state.model.parameters()])}
        log(f"opt (b): dropout train step ({label}, remat {remat}, {segments} x "
            f"{DROPOUT_SECONDS} s): loss "
            f"{runs[label]['loss']!r}, {sec * 1e3:.3f} ms (the first step of a fresh "
            f"model), peak {runs[label]['peak_gb']:.3f} GB, launches {counts} on {gpu}")
        if any(counts.values()) or len(grads) != 66 * 11 or bad:
            fail(f"dropout step ({label}): launches {counts}, {len(grads)} row-block "
                 f"gradients, missing / non-finite / zero: {bad[:5]}")
        del state, step
        torch.cuda.empty_cache()
    same = runs["first"]["loss"] == runs["again"]["loss"]
    g0, g1 = runs["first"]["grad"], runs["remat"]["grad"]
    cos = float((g0 @ g1) / (g0.norm() * g1.norm()))
    rel = abs(runs["remat"]["loss"] - runs["first"]["loss"]) / abs(runs["first"]["loss"])
    log(f"opt (b): the loss twice from the same weights and seed: equal {same}; remat vs "
        f"no remat: loss rel {rel:.2e} (limit 1e-3), gradient cosine {cos:.6f} (min 0.999)")
    if not (same and rel <= 1e-3 and cos >= 0.999):
        fail(f"dropout step: loss equal {same}, remat loss rel {rel}, cosine {cos}")
    for r in runs.values():
        del r["grad"]
    res.update(segments=segments, steps=runs, loss_equal=same, remat_loss_rel=rel,
               remat_grad_cosine=cos)
    return res


def check_int8_products(torch, qmodel, x):
    """One forward of ``qmodel`` with every int8 product run both ways
    (``torch._int_mm`` and its plain f32-of-int8 version): the number of
    products and how many differ; the output."""
    from tfswa_tpu_torch.ops import int8 as int8_ops

    real, seen = int8_ops.int8_product, []

    def both(xq, wq):
        got = real(xq, wq)
        seen.append(bool(torch.equal(got, int8_ops.int8_product_reference(xq, wq))))
        return got

    int8_ops.int8_product = both
    try:
        out = qmodel(x)
    finally:
        int8_ops.int8_product = real
    return len(seen), seen.count(False), out


def plain_products_forward(torch, qmodel, x):
    """``qmodel``'s forward with every int8 product on its plain version."""
    from tfswa_tpu_torch.ops import int8 as int8_ops

    real = int8_ops.int8_product
    int8_ops.int8_product = int8_ops.int8_product_reference
    try:
        return qmodel(x)
    finally:
        int8_ops.int8_product = real


def opt_int8(torch, np, gpu: str):
    """(c) quantize_dynamic(compute="int8"): every torch._int_mm product of
    one forward equal to its plain version, the whole forward equal to the
    plain-product forward, compare_models against the f32 model,
    quantize_static on 2 calibration batches, one separation of the 120 s
    track, and the int8 tool in this process (its forward against bf16
    "pallas" is the route's rate)."""
    from tfswa_tpu_torch.optimization import compare_models, quantize_dynamic, quantize_static

    res = {}
    model = opt_model(torch, np)
    qmodel, stats = quantize_dynamic(model, compute="int8")
    x = opt_input(torch)
    n, differ, out = check_int8_products(torch, qmodel, x)
    plain_out = plain_products_forward(torch, qmodel, x)
    same = bool(torch.equal(out, plain_out))
    res.update(products=n, products_differing=differ, forward_equal_plain=same,
               compression_ratio=stats["compression_ratio"])
    log(f"opt (c): {n} int8 products in one forward of {OPT_BATCH} (4 a row block), "
        f"{differ} differ from their plain version; the forward equal to the plain-product "
        f"forward bit for bit: {same} (limit: equal)")
    if n != 4 * 66 or differ or not same:
        fail(f"int8 products: {n} products, {differ} differ, forward equal {same}")
    del out, plain_out
    f32 = opt_model(torch, np, impl="xla", dtype="float32")
    res["vs_f32"] = compare_models(f32, qmodel, input_shape=(1, 4, 257, 65))
    log(f"opt (c): compare_models vs f32 at (1, 4, 257, 65): mae {res['vs_f32']['mae']:.4e}, "
        f"max {res['vs_f32']['max_abs']:.4e} (JAX's CPU test: mae < 0.02 at small width)")
    del f32
    batches = [opt_input(torch, (1, 4, 1024, 862), seed=s).cpu().numpy() for s in (1, 2)]
    static, sstats = quantize_static(model, calibration_batches=batches)
    scales = [float(v) for blk in static.act_scales.values() for v in blk.values()]
    xb = torch.from_numpy(batches[0]).cuda()
    dyn_static = float((static(xb) - qmodel(xb)).abs().max())
    res.update(static_scales=len(scales), static_min_scale=min(scales),
               static_vs_dynamic_max_abs=dyn_static)
    log(f"opt (c): quantize_static on 2 batches: {len(scales)} scales, least "
        f"{min(scales):.4e}; static vs dynamic max |diff| {dyn_static:.4e} (limit 0.05)")
    if len(scales) != 4 * 66 or not min(scales) > 0 or not dyn_static <= 0.05:
        fail(f"quantize_static: {len(scales)} scales, least {min(scales)}, static vs "
             f"dynamic {dyn_static}")
    del static, xb, x
    torch.cuda.empty_cache()

    sep8 = separator_with(torch, qmodel.model, "int8")
    sep16 = separator_with(torch, model, "pallas")
    audio = synthetic_track(np, INT8_TRACK_SECONDS, sep8.sample_rate)
    sep8.separate(audio[: 10 * sep8.sample_rate])                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out8 = sep8.separate(audio)
    sec = time.perf_counter() - t0
    out16 = sep16.separate(audio)
    snrs = [float(10 * np.log10(np.sum(out16[k].astype(np.float64) ** 2)
                                / np.sum((out8[k].astype(np.float64) - out16[k]) ** 2)))
            for k in out16]
    res.update(separation_audio_s_per_s=INT8_TRACK_SECONDS / sec,
               separation_snr_vs_pallas_db=snrs)
    log(f"opt (c): {INT8_TRACK_SECONDS:.0f} s track through \"int8\": "
        f"{INT8_TRACK_SECONDS / sec:.4f} audio-s/s on {gpu}; "
        f"SNR vs \"pallas\" per stem {[round(v, 3) for v in snrs]} dB (recorded)")
    if not all(np.isfinite(v).all() for v in out8.values()):
        fail("int8 separation: non-finite stems")
    del sep8, sep16, qmodel, model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res["tool"] = run_tool_here("bench_int8", ["--seconds", "3", "--iters", "1"])
    res["tool_s"] = time.perf_counter() - t0
    log(f"  bench_int8: {json.dumps(res['tool'])}")
    return res


def opt_fold(torch, np, gpu: str):
    """(d) fold_batch_norms: float32 on the plain route within 1e-4 rel.;
    bf16 through "pallas" at SNR >= 30 dB a stem with 66 B1 launches;
    benchmark_model of both forwards at the serving batch."""
    from tfswa_tpu_torch.optimization import benchmark_model, fold_batch_norms, make_forward_fn

    res = {}
    m32 = opt_model(torch, np, impl="xla", dtype="float32")
    f32 = fold_batch_norms(m32)
    x = opt_input(torch, EXPORT_SHAPE)
    with torch.inference_mode():
        a, b = m32(x), f32(x)
    res["f32_rel"] = rel_max(b, a)
    log(f"opt (d): folded vs unfolded, float32 plain route at {EXPORT_SHAPE}: rel "
        f"{res['f32_rel']:.3e} (limit 1e-4)")
    if not res["f32_rel"] <= 1e-4:
        fail(f"fold_batch_norms: float32 rel {res['f32_rel']}")
    del m32, f32, a, b
    model = opt_model(torch, np)
    folded = fold_batch_norms(model)
    counts = counted_forward(torch, folded, opt_input(torch))[1]
    if counts != {k: (66 if k == "B1" else 0) for k in counts}:
        fail(f"folded forward: launches {counts}")
    sep_f = separator_with(torch, folded, "pallas")
    sep_u = separator_with(torch, model, "pallas")
    seg = torch.from_numpy(synthetic_track(np, 10.0, sep_f.sample_rate)[None]).cuda()
    with torch.inference_mode():
        a = sep_u._separate_core(seg).double().cpu().numpy()
        b = sep_f._separate_core(seg).double().cpu().numpy()
    snrs = [float(10 * np.log10(np.sum(a[:, s] ** 2) / max(np.sum((a[:, s] - b[:, s]) ** 2),
                                                           1e-300)))
            for s in range(a.shape[1])]
    res.update(launches=counts, bf16_snr_db=snrs)
    log(f"opt (d): folded vs unfolded through \"pallas\" (bf16), one 10 s segment: SNR per "
        f"stem {[round(v, 3) for v in snrs]} dB (min {SNR_MIN_DB}); launches {counts}")
    if min(snrs) < SNR_MIN_DB:
        fail(f"folded bf16 route: SNR {snrs}")
    for label, m in (("unfolded", model), ("folded", folded)):
        res[label] = benchmark_model(make_forward_fn(m), input_shape=OPT_BATCH,
                                     num_warmup=1, num_iters=3)
        log(f"opt (d): benchmark_model {label} at {OPT_BATCH}: "
            f"{res[label]['ms_per_iter']:.3f} ms/iter, "
            f"{res[label]['audio_sec_per_sec']:.4f} audio-s/s, RTF {res[label]['rtf']:.5f} "
            f"on {gpu}")
    return res


def opt_export(torch, np, gpu: str):
    """(e) the float32 plain route at EXPORT_SHAPE (depth EXPORT_DEPTHS):
    torch.export and the TorchScript trace saved, loaded and run within 1e-4
    of eager; ONNX bytes or the reason it was refused; the reference .pt
    served back equal; export_model_info of the flagship.  The kernel
    routes' exports are phase 15 (d)'s."""
    from tfswa_tpu_torch.evaluation import load_separator_from_checkpoint
    from tfswa_tpu_torch.optimization import (export_model_info, export_savedmodel,
                                              export_stablehlo, export_to_onnx,
                                              export_torch_checkpoint)

    res, seconds = {}, {}
    os.makedirs(OPT_WORK, exist_ok=True)
    model = opt_model(torch, np, impl="xla", dtype="float32", depths=EXPORT_DEPTHS)

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    res["torch_export"] = step("torch_export", lambda: export_stablehlo(
        model, os.path.join(OPT_WORK, "model.pt2"), EXPORT_SHAPE))
    res["torchscript"] = step("torchscript", lambda: export_savedmodel(
        model, os.path.join(OPT_WORK, "ts"), EXPORT_SHAPE))
    try:
        # the TorchScript round trip above already ran the traced graph
        res["onnx"] = step("onnx", lambda: export_to_onnx(
            model, os.path.join(OPT_WORK, "model.onnx"), EXPORT_SHAPE, verify=False))
    except ImportError as exc:
        res["onnx"] = {"refused": str(exc)}
    ck = os.path.join(OPT_WORK, "model.pt")
    res["checkpoint"] = export_torch_checkpoint(model, ck)
    sep = load_separator_from_checkpoint(ck, device="cuda")
    served = all(torch.equal(v, model.state_dict()[k].to(v.device))
                 for k, v in sep.model.state_dict().items())
    flagship = opt_model(torch, np)
    res["model_info"] = export_model_info(flagship)
    res.update(checkpoint_served_equal=served, seconds=seconds)
    log(f"opt (e): at {EXPORT_SHAPE}, depths {EXPORT_DEPTHS}: torch.export "
        f"{res['torch_export']['bytes']} bytes, max |diff| {res['torch_export']['max_abs_diff']:.3e}; "
        f"TorchScript {res['torchscript']['bytes']} bytes, max |diff| "
        f"{res['torchscript']['max_abs_diff']:.3e} (limit 1e-4); ONNX "
        + (f"{res['onnx']['bytes']} bytes" if "bytes" in res["onnx"]
           else f"refused: {res['onnx']['refused']}")
        + f"; the .pt served back equal {served}; seconds {seconds}")
    log(f"opt (e): export_model_info of the flagship: {res['model_info']['num_parameters']} "
        f"parameters")
    if not served:
        fail(f"export: checkpoint served equal {served}")
    if res["model_info"]["num_parameters"] != FLAGSHIP_PARAMETERS:
        fail(f"export_model_info: {res['model_info']['num_parameters']} parameters, "
             f"expected {FLAGSHIP_PARAMETERS}")
    return res


# the flagship's parameters at in/out 4 (15,404,834 at in/out 2, as the
# reference counts; the CPU tests hold the port's count to JAX's)
FLAGSHIP_PARAMETERS = 15408036


def opt_profiling(torch, np, gpu: str):
    """(f) trace around one forward writes a trace with the annotation in
    it; detect_chip() is "h100"; flops_of one plain-route forward at the
    training batch; StepTimer's MFU over two "pallas" train steps."""
    from tfswa_tpu_torch.utils.profiling import (StepTimer, annotate, detect_chip, flops_of,
                                                 trace)

    res = {}
    chip = detect_chip()
    model = opt_model(torch, np)
    x = opt_input(torch, (1, 4, 1024, 862))
    log_dir = os.path.join(OPT_WORK, "trace")
    with trace(log_dir) as prof:
        with annotate("chip_smoke/forward"), torch.inference_mode():
            model(x)
    names = {e.name for e in prof.events()}
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    res.update(chip=chip, trace_files=files, annotated="chip_smoke/forward" in names)
    del model, x
    plain = opt_model(torch, np, impl="xla")
    spec = opt_input(torch, (1, 4, 1025, 517))
    with torch.inference_mode():        # FLOPs scale with the batch: one segment, x4
        fwd = TRAIN_BATCH * flops_of(plain, spec)
    del plain, spec
    torch.cuda.empty_cache()
    state, step = make_trainer(torch, "pallas")[:2]
    mix, targets = train_batch(torch, np)
    timer = StepTimer(flops_per_step=3 * fwd, items_per_step=TRAIN_BATCH)
    step(state, mix, targets)
    torch.cuda.synchronize()
    timer.tick()
    for _ in range(2):
        step(state, mix, targets)
        torch.cuda.synchronize()
        timer.tick()
    m = timer.metrics()
    res.update(forward_flops=fwd, step_metrics=m)
    log(f"opt (f): detect_chip {chip!r}; trace files {files}, annotation seen "
        f"{res['annotated']}; flops_of one plain forward at the training batch {fwd:.4e}; "
        f"StepTimer over 2 \"pallas\" steps: {m['step_time_s'] * 1e3:.3f} ms a step, MFU "
        f"{m['mfu']:.4f} (3 x the forward's FLOPs over 989e12) on {gpu}")
    if chip != "h100" or not files or not res["annotated"] or not fwd or not fwd > 0:
        fail(f"profiling: chip {chip}, trace files {files}, annotated {res['annotated']}, "
             f"flops {fwd}")
    del state, step
    torch.cuda.empty_cache()
    return res


def phase_options(torch, np, gpu: str, skip=()):
    """Phase 12: the model's options (masked SWA, dropout) and the deployment
    path (int8, BN folding, export, profiling; those named in ``skip`` run
    elsewhere: beside_quality).  The export and trace files under
    chiprun_out/opt_work are deleted after it, on a failure too."""
    res, seconds = {}, {}
    try:
        for name, fn in (("masked", opt_masked), ("dropout", opt_dropout),
                         ("int8", opt_int8), ("fold", opt_fold), ("export", opt_export),
                         ("profiling", opt_profiling)):
            if name in skip:
                continue
            t0 = time.perf_counter()
            res[name] = fn(torch, np, gpu)
            seconds[name] = time.perf_counter() - t0
            log(f"  {name}: {seconds[name]:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(OPT_WORK, ignore_errors=True)
    res["seconds"] = seconds
    return res


# ------------------------------------------------------------------ phase 13
PARALLEL_WORK = os.path.join(HERE, "chiprun_out", "parallel_work")
PARALLEL_TIMEOUT_S = 300
# configs/musdb_repro.yaml's train segment: at crop_pow2 (F = 1024, T = 512)
# no decoder stage resizes, so the plain step is bit-reproducible with
# cudnn.deterministic; at 6 s (T = 517) the bilinear resizes' backward
# (atomics) is not
ALIGNED_SECONDS = 5.938
PARALLEL_STEPS = 3
# (b): two ranks against one process: loss within PAR_LOSS_REL, stems SNR,
# and each parameter's update at cosine >= PAR_COSINE, held where the
# direction means something: every leaf but the 118 whose gradient is 0 in
# exact arithmetic (conv biases just before a train-mode BatchNorm, row
# blocks' fc2 biases), whose update is held to NOISE_LIMIT of the largest
# update element instead.  NOISE_LIMIT lies between the sound runs'
# largest reading, 5.7e-5 (bf16 at (2, 1)), and that of a data-parallel
# fault planted in those leaves, 5.3e-2 (`--plant unsummed_zero_leaves`),
# both on an H100.
#
# In bf16 at (2, 1) the ranks' rows change the rounding (each rank's
# half-batch gradients, cuDNN's algorithms at half the batch), and where a
# leaf's gradient is a small sum of large terms that cancel, that rounding
# alone moves its update's direction.  The witness "2,1 xla" runs the same
# mesh, batch and dtype on the plain route, which carries that rounding and
# none of the kernels; the kernel run holds each leaf at PAR_COSINE or at
# 1 - cosine within WITNESS_FACTOR times the witness's on that leaf.  The
# plain route takes 20-30 s a step there on an H100 (a profiled step 95 s),
# more than the whole run's time allows, so the witness runs alone
# (`--witness`, which writes chiprun_out/chip_smoke_witness.json) and its
# cosines are read from WITNESS_FILE, that file as committed.
PAR_LOSS_REL, PAR_COSINE, PAR_SNR_DB, NOISE_LIMIT = 1e-3, 0.999, 60.0, 1e-3
WITNESS_FACTOR = 4.0
PAR_LR = 1e-2
# the float32 run's segment: 87 hops, T = 88, a multiple of 8, so that no
# decoder stage resizes (the half sample keeps int() from rounding down)
F32_SECONDS = (87 * 512 + 0.5) / 44100
# (tag, mesh, global batch, seconds a segment, route, dtype, how the
# cosines are held: None at PAR_COSINE, a witness's tag against that
# witness, "witness" recorded as one); all at crop_pow2 with
# cudnn.deterministic, where one process reproduces itself, so that what
# differs is the ranks' doing
RANK_RUNS = (("2,1", (2, 1), 4, ALIGNED_SECONDS, "pallas", "bfloat16", "2,1 xla"),
             ("1,2", (1, 2), 2, ALIGNED_SECONDS, "pallas", "bfloat16", None),
             ("2,1 f32", (2, 1), 2, F32_SECONDS, "xla", "float32", None))
WITNESS_RUN = ("2,1 xla", (2, 1), 4, ALIGNED_SECONDS, "xla", "bfloat16", "witness")
WITNESS_FILE = os.path.join(HERE, "chip_smoke_witness.json")
# faults planted in phase 13 (b)'s ranks alone (`--plant NAME`): exit 0 when
# (b) catches them
DP_PLANTS = {
    # the zero-gradient leaves left out of the gradients' sum over "data":
    # each rank steps with its own half-batch gradient of them, over d;
    # planted in the bf16 (2, 1) run
    "unsummed_zero_leaves": "2,1",
}
BN_LAYERS = 52        # flagship BatchNorms: stem, 2 in each of 22 blocks, 3 down, 3 up, head


def parallel_state(torch, mesh, freq_policy="full", sgd=False, impl="pallas",
                   dtype="bfloat16"):
    """The flagship (seed 0, ``impl``, ``dtype``) on ``mesh`` (None: this
    process alone) and its train step; ``sgd``: clip + SGD at PAR_LR in place of
    clip + AdamW (Adam's first update is about lr * sign(g), so the sum
    order's noise in near-zero gradients would flip signs)."""
    from tfswa_tpu_torch.config import Config, ModelConfig, TrainConfig
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.training.train_state import (ClippedAdamW, create_train_state,
                                                      make_sharded_train_step,
                                                      make_train_step)

    cfg = Config(model=ModelConfig(in_channels=4, out_channels=4, attention_impl=impl,
                                   dtype=dtype),
                 train=TrainConfig(seed=0, freq_policy=freq_policy))
    model, state = create_train_state(cfg, device="cuda", mesh=mesh)
    if sgd:
        tx = state.tx
        state.tx = ClippedAdamW(tx.params, lambda count: PAR_LR, 1.0, 0.0, tx.model_axis,
                                tx.sharded)
        state.tx.adamw = torch.optim.SGD(state.tx.params, lr=PAR_LR)
    proc, stems = STFTProcessor(cfg.stft), cfg.data.stems
    kw = dict(freq_policy=freq_policy)
    step = make_train_step(model, proc, stems, **kw) if mesh is None else \
        make_sharded_train_step(model, proc, stems, mesh, **kw)
    return state, step


def segments_batch(torch, np, n: int, seconds: float):
    """The first ``n`` of phase 7's segments at ``seconds`` each, on the card."""
    from tfswa_tpu_torch.data import SyntheticDataset

    ds = SyntheticDataset(num_tracks=TRAIN_BATCH, track_seconds=12.0, segment_seconds=seconds,
                          sample_rate=44100, seed=0)
    items = [ds[i] for i in range(n)]
    mix = torch.from_numpy(np.stack([m for m, _ in items])).cuda()
    return mix, {k: torch.from_numpy(np.stack([t[k] for _, t in items])).cuda()
                 for k in ds.stems}


def run_steps(torch, state, step, mix, targets, steps: int):
    """(losses, ms a step, the parameters after) of ``steps`` steps."""
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in loss.items()})
    return losses, ms, [p.detach().clone() for p in state.model.parameters()]


def step_collectives(torch, run):
    """Per-op counts and bytes of the collectives of one call, from a
    profiler trace of its CPU activity (where c10d records them)."""
    from torch.profiler import ProfilerActivity, profile

    from tfswa_tpu_torch.parallel.analysis import collective_stats

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    stats = collective_stats(prof)
    return {"counts": stats.counts, "bytes": stats.bytes}


def par_world_one(torch, np, gpu: str, phase7_ms, serve_rate):
    """(a) World size 1 over NCCL, mesh (1, 1): make_sharded_train_step
    against make_train_step from the same state, bit for bit, at the
    recipe's aligned 4 x 5.938 s (and, recorded, the plain step's own
    run-to-run spread at 4 x 6 s); the 120 s track through
    SourceSeparator(mesh=) against the plain separator, bit for bit."""
    import torch.distributed as dist

    from tfswa_tpu_torch.config import STFTConfig
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.parallel import create_mesh, initialize_distributed
    from tfswa_tpu_torch.training.train_state import _spectrograms
    from tfswa_tpu_torch.utils.profiling import flops_of

    store = os.path.join(PARALLEL_WORK, "store_a")
    initialize_distributed(f"file://{store}", 1, 0, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    res = {"backend": dist.get_backend()}
    try:
        if res["backend"] != "nccl":
            fail(f"parallel (a): backend {res['backend']}, not nccl")
        mesh = create_mesh((1, 1))
        runs = {}
        mix, targets = segments_batch(torch, np, TRAIN_BATCH, ALIGNED_SECONDS)
        for name, m in (("plain", None), ("sharded", mesh)):
            state, step = parallel_state(torch, m, "crop_pow2")
            runs[name] = run_steps(torch, state, step, mix, targets, PARALLEL_STEPS)
            if name == "sharded":
                res["collectives"] = step_collectives(torch, lambda: step(state, mix, targets))
                # the MFU's FLOPs: 3 x one plain-route forward of the rows
                x = _spectrograms(STFTProcessor(STFTConfig()), mix[:1], {}, "crop_pow2")[0]
                plain = state.model.clone(attention_impl="xla").eval()
                with torch.no_grad():
                    flops = 3 * TRAIN_BATCH * flops_of(plain, x)
                del plain
            del state, step
            torch.cuda.empty_cache()
        (pl, pms, pp), (sl, sms, sp) = runs["plain"], runs["sharded"]
        same = pl == sl and all(torch.equal(a, b) for a, b in zip(pp, sp))
        want = {"all_reduce": 2 * BN_LAYERS + 2}
        log(f"parallel (a): world size 1 over {res['backend']}, mesh (1, 1), "
            f"{PARALLEL_STEPS} steps at {TRAIN_BATCH} x {ALIGNED_SECONDS} s (crop_pow2): losses "
            f"{[l['total_loss'] for l in sl]}, bit-identical to make_train_step: {same}; "
            f"collectives a step {res['collectives']['counts']} (want {want}); ms a step "
            f"sharded {[round(v, 3) for v in sms]} plain {[round(v, 3) for v in pms]} "
            f"(phase 7's best at 4 x 6 s: {phase7_ms:.3f}) on {gpu}")
        res.update(aligned_losses=sl, bit_identical=same, sharded_ms=sms, plain_ms=pms,
                   phase7_ms=phase7_ms)
        if not same or res["collectives"]["counts"] != want:
            fail("parallel (a): the sharded step at world size 1 is not the plain step bit "
                 f"for bit ({same}) or its collectives are {res['collectives']['counts']}")
        res["mfu"] = flops / (min(sms) / 1e3) / 989e12
        log(f"parallel (a): MFU of the sharded step {res['mfu']:.4f} (3 x one plain forward, "
            f"{flops:.4e} FLOPs a step, over 989e12; the unsharded recipe step read "
            f"0.027-0.028 before)")

        # the plain step's own spread at 4 x 6 s, where the resizes' backward
        # sums with atomics: recorded, with the sharded step beside it
        mix6, targets6 = segments_batch(torch, np, TRAIN_BATCH, TRAIN_SECONDS)
        six = {}
        for name, m in (("plain", None), ("plain_again", None), ("sharded", mesh)):
            state, step = parallel_state(torch, m)
            six[name] = run_steps(torch, state, step, mix6, targets6, 2)
            del state, step
            torch.cuda.empty_cache()

        def spread(a, b):
            d = [float((x - y).abs().max()) for x, y in zip(six[a][2], six[b][2])]
            return sum(v > 0 for v in d), max(d)

        res["six_s"] = {"plain_vs_plain": spread("plain", "plain_again"),
                        "sharded_vs_plain": spread("sharded", "plain"),
                        "first_losses": [six[k][0][0]["total_loss"] for k in six]}
        log(f"parallel (a): at 4 x 6 s (T = 517, resizes) two plain runs differ in "
            f"{res['six_s']['plain_vs_plain'][0]} of 936 leaves (max "
            f"{res['six_s']['plain_vs_plain'][1]:.3e}) after 2 steps, the sharded run from a "
            f"plain one in {res['six_s']['sharded_vs_plain'][0]} (max "
            f"{res['six_s']['sharded_vs_plain'][1]:.3e}); first losses "
            f"{res['six_s']['first_losses']}")
        if len(set(res["six_s"]["first_losses"])) != 1:
            fail("parallel (a): the first step's loss differs at 4 x 6 s")

        # serving: the 120 s track through SourceSeparator(mesh=(1, 1))
        audio = synthetic_track(np, 120.0, 44100)
        outs, rates = {}, {}
        for name, m in (("plain", None), ("mesh", mesh)):
            sep = make_separator(torch, "pallas", mesh=m)
            sep.separate(audio)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[name] = sep.separate(audio)
            rates[name] = 120.0 / (time.perf_counter() - t0)
            del sep
            torch.cuda.empty_cache()
        same = all(np.array_equal(outs["plain"][k], outs["mesh"][k]) for k in outs["plain"])
        res.update(serving_bit_identical=same, serving_rate=rates, phase4_rate=serve_rate)
        log(f"parallel (a): the 120 s track through SourceSeparator(mesh=(1, 1)): stems "
            f"bit-identical {same}; {rates['mesh']:.4f} audio-s/s against {rates['plain']:.4f} "
            f"without a mesh (phase 4's best: {serve_rate:.4f}) on {gpu}")
        if not same:
            fail("parallel (a): SourceSeparator(mesh=(1, 1)) stems differ")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    return res


def rows_of(forward_kernel, rows):
    """``fused_block._forward_kernel`` that also appends the rows of each
    B1-train launch to ``rows`` (the launch counters stay the wrappers')."""
    def run(r, p, num_heads, train=False, int8=False):
        if train:
            rows.append(int(r.shape[0]))
        return forward_kernel(r, p, num_heads, train=train, int8=int8)

    return run


def zero_gradient_leaves(depths=(2, 2, 6, 2)):
    """The parameters whose gradient is 0 in exact arithmetic: every conv
    bias just before a train-mode BatchNorm (its mean removes the bias),
    and every row block's fc2 bias (the block's output reaches the loss
    only through the fusion conv and its BatchNorm, which removes a
    per-channel constant)."""
    from tfswa_tpu_torch.weights import conv_bn_pairs, row_blocks

    return ({f"{conv}.bias" for conv, _ in conv_bn_pairs(depths)}
            | {f"{name}.mlp.3.bias" for name, _ in row_blocks(depths)})


def update_cosines(torch, names, before, after, ref_after):
    """{name: (cosine of the update after - before against the one-process
    update, the one-process update's norm over the largest leaf's)}, and
    the largest update element."""
    ups = {n: (a.double() - b.double(), r.double() - b.double())
           for n, b, a, r in zip(names, before, after, ref_after)}
    top = max(float(r.norm()) for _, r in ups.values())
    big = max(float(r.abs().max()) for _, r in ups.values())
    def cosine(u, r):
        den = float(u.norm() * r.norm())
        return float((u * r).sum()) / den if den else float(torch.equal(u, r))

    return {n: (cosine(u, r), float(r.norm()) / top, float((u - r).abs().max()) / big)
            for n, (u, r) in ups.items()}


def plant_unsummed_zero_leaves(train_state, zero_ids) -> None:
    """DP_PLANTS' "unsummed_zero_leaves": the gradients of the parameters
    in ``zero_ids`` (ids) keep this rank's own value over d after the sum
    over "data"."""
    average = train_state._average_gradients

    def faulty(params, axis):
        params = list(params)
        own = {id(p): p.grad.clone() for p in params
               if id(p) in zero_ids and p.grad is not None}
        average(params, axis)
        for p in params:
            if id(p) in own:
                p.grad.copy_(own[id(p)] / axis.size)

    train_state._average_gradients = faulty


def rank_main(rank: int, world: int, store: str, out: str, tags, plant=None) -> None:
    """One of phase 13 (b)'s ranks: gloo on CUDA tensors, both ranks on
    cuda:0.  For each run of RANK_RUNS named in ``tags``: 2 train steps of
    the global batch's rows of this rank, launches and rows a step, the
    collectives of one profiled step, ms a step; on "pallas" a 30 s track
    separated.  Rank 0 writes the losses, the whole parameters and the
    stems.  ``plant``: a fault of DP_PLANTS, planted in every run."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from tfswa_tpu_torch.ops import fused_block
    from tfswa_tpu_torch.parallel import (create_mesh, gather_state_dict, initialize_distributed,
                                          shard_batch)

    torch.backends.cudnn.deterministic = True
    train_state = importlib.import_module("tfswa_tpu_torch.training.train_state")
    initialize_distributed(f"file://{store}", world, rank, device="cuda", backend="gloo")
    rows = []
    fused_block._forward_kernel = rows_of(fused_block._forward_kernel, rows)
    zero_ids = set()
    if plant == "unsummed_zero_leaves":
        plant_unsummed_zero_leaves(train_state, zero_ids)
    res = {}
    zero = zero_gradient_leaves()
    for tag, shape, n, seconds, impl, dtype, held_by in RANK_RUNS + (WITNESS_RUN,):
        if tag not in tags:
            continue
        mesh = create_mesh(shape)
        state, step = parallel_state(torch, mesh, "crop_pow2", True, impl, dtype)
        zero_ids.clear()
        zero_ids.update(id(p) for k, p in state.model.named_parameters() if k in zero)
        mix, targets = shard_batch(segments_batch(torch, np, n, seconds), mesh)
        reset_counts()
        rows.clear()
        losses, ms, _ = run_steps(torch, state, step, mix, targets, 1)
        launches, step_rows = read_counts(), sum(rows)
        second = []              # the second step, profiled but for the witness
        t0 = time.perf_counter()
        if held_by == "witness":
            second.append(step(state, mix, targets)[1])
            torch.cuda.synchronize()
            coll = {"counts": None}
        else:
            coll = step_collectives(torch, lambda: second.append(step(state, mix, targets)[1]))
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: float(v) for k, v in second[0].items()})
        whole = {k: v.detach().cpu() for k, v in gather_state_dict(state.model).items()}
        del state, step
        torch.cuda.empty_cache()
        stems = None
        if impl == "pallas":
            sep = make_separator(torch, "pallas", mesh=mesh)
            stems = sep.separate(synthetic_track(np, 30.0, 44100))
            del sep
            torch.cuda.empty_cache()
        res[tag] = {"losses": losses, "ms": ms, "launches_step1": launches,
                    "rows_step1": step_rows, "collectives": coll,
                    "params": whole if rank == 0 else None,
                    "stems": stems if rank == 0 else None}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def witness_cosines(tag: str) -> dict:
    """{leaf: update cosine} of witness run ``tag`` from WITNESS_FILE."""
    if not os.path.exists(WITNESS_FILE):
        fail(f"parallel (b): {WITNESS_FILE} is missing (python3 chip_smoke.py --witness "
             "writes it under chiprun_out)")
    rec = json.load(open(WITNESS_FILE))
    if rec["run"][0] != tag:
        fail(f"parallel (b): {WITNESS_FILE} holds run {rec['run'][0]!r}, not {tag!r}")
    return {k: (v,) for k, v in rec["cosines"].items()}


def par_two_ranks(torch, np, gpu: str, tags=None, plant=None):
    """(b) Two ranks on the one card over gloo with CUDA tensors, the runs
    of RANK_RUNS and WITNESS_RUN named in ``tags`` (default: RANK_RUNS), each against one
    process on the same batch (losses, every parameter's update, the 30 s
    track's stems), the launches, rows and collectives a step per rank.
    ``plant``: a fault of DP_PLANTS, planted in the ranks alone; the
    result's "bad" then lists what the checks caught, where it fails the
    run without one."""
    from tfswa_tpu_torch.ops import fused_block

    runs = [r for r in RANK_RUNS + (WITNESS_RUN,)
            if r[0] in (tags or [r_[0] for r_ in RANK_RUNS])]
    tags = [r[0] for r in runs]
    refs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for tag, shape, n, seconds, impl, dtype, _ in runs:
        state, step = parallel_state(torch, None, "crop_pow2", True, impl, dtype)
        before = [p.detach().clone() for p in state.model.parameters()]
        mix, targets = segments_batch(torch, np, n, seconds)
        rows = []
        orig = fused_block._forward_kernel
        fused_block._forward_kernel = rows_of(orig, rows)
        try:
            losses, ms, after = run_steps(torch, state, step, mix, targets, 2)
        finally:
            fused_block._forward_kernel = orig
        names = [k for k, _ in state.model.named_parameters()]
        del state, step
        torch.cuda.empty_cache()
        state, step = parallel_state(torch, None, "crop_pow2", True, impl, dtype)   # again
        again = run_steps(torch, state, step, mix, targets, 2)[2]
        refs[tag] = dict(losses=losses, ms=ms, before=before, after=after, again=again,
                         names=names, rows_step1=sum(rows) // 2)
        del state, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    sep = make_separator(torch, "pallas")
    ref_stems = sep.separate(synthetic_track(np, 30.0, 44100))
    del sep
    torch.cuda.empty_cache()

    work = os.path.join(PARALLEL_WORK, "ranks")
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, "store")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in range(2):
        logs.append(open(os.path.join(work, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank", str(r),
             "--world", "2", "--store", store, "--out", work, "--tags", ";".join(tags)]
            + (["--plant", plant] if plant else []),
            stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PARALLEL_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, fh in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            fh.close()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        for r in range(2):
            log(f"rank {r} (rc {procs[r].returncode}):\n" +
                open(os.path.join(work, f"rank{r}.log")).read()[-4000:])
        fail("parallel (b): a rank failed or hung")
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    res = {"wall_s": wall}
    bad = []
    zero = zero_gradient_leaves()
    cosines = {}
    for tag, *_ in runs:
        ref = refs[tag]
        after = [ranks[0][tag]["params"][k].cuda() for k in ref["names"]]
        cosines[tag] = update_cosines(torch, ref["names"], ref["before"], after, ref["after"])
    for tag, shape, n, seconds, impl, dtype, held_by in runs:
        ref, got = refs[tag], ranks[0][tag]
        rel = max(abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
                  for a, b in zip(got["losses"], ref["losses"]))
        ranks_cos = cosines[tag]
        self_cos = update_cosines(torch, ref["names"], ref["before"], ref["again"],
                                  ref["after"])
        held = {n_: v for n_, v in ranks_cos.items() if n_ not in zero}
        worst = min(held, key=lambda n_: held[n_][0])
        cos = held[worst][0]
        floor_cos = min(v[0] for v in held.values() if v[1] >= 1e-3)
        noise = max(v[2] for n_, v in ranks_cos.items() if n_ in zero)
        short = [n_ for n_, v in held.items() if v[0] < PAR_COSINE]
        if held_by is None:
            failing, rule = short, f"limit {PAR_COSINE}"
        elif held_by == "witness":
            failing, rule = [], "recorded: the witness"
        else:
            wit = cosines[held_by] if held_by in cosines else witness_cosines(held_by)
            ratio = {n_: (1.0 - held[n_][0]) / max(1.0 - wit[n_][0], 1e-300) for n_ in short}
            failing = [n_ for n_ in short if ratio[n_] > WITNESS_FACTOR]
            rule = (f"limit {PAR_COSINE}, or 1 - cosine within {WITNESS_FACTOR} x the "
                    f"witness {held_by!r}'s on the leaf; "
                    f"{len(short)} leaves short of {PAR_COSINE}, "
                    f"{sum(wit[n_][0] < PAR_COSINE for n_ in held)} in the witness, largest "
                    f"ratio {max(ratio.values(), default=0.0):.3f}")
        snr = None if got["stems"] is None else [
            float(10 * np.log10(np.sum(ref_stems[k].astype(np.float64) ** 2)
                                / max(np.sum((got["stems"][k].astype(np.float64)
                                              - ref_stems[k]) ** 2), 1e-30)))
            for k in ref_stems]
        per_rank = [{"launches": rk[tag]["launches_step1"], "rows": rk[tag]["rows_step1"],
                     "collectives": rk[tag]["collectives"]["counts"], "ms": rk[tag]["ms"]}
                    for rk in ranks]
        want_rows = ref["rows_step1"] // shape[0]          # half the rows at (2, 1)
        res[tag] = dict(loss_rel=rel, update_cosine_min=cos, worst_leaf=worst,
                        update_cosine_min_over_1e3=floor_cos, zero_leaves_max=noise,
                        stems_snr_db=snr, per_rank=per_rank, one_process_ms=ref["ms"],
                        one_process_rows=ref["rows_step1"], held_by=held_by,
                        leaves_short=len(short), leaves_failing=failing,
                        cosines={n_: v[0] for n_, v in held.items()})
        order = sorted(held, key=lambda n_: held[n_][0])[:3]
        log(f"parallel (b) {tag} on {n} x {seconds:.4f} s, {impl} {dtype}, two ranks sharing "
            f"one card (gloo, CUDA tensors){', planted ' + plant if plant else ''}: loss rel "
            f"{rel:.3e} (limit {PAR_LOSS_REL}); update cosine min {cos:.6f} over the "
            f"{len(held)} leaves of nonzero gradient ({rule}; {floor_cos:.6f} over those of "
            f"update norm >= 1e-3 of the largest), the 118 of zero gradient within "
            f"{noise:.3e} of the largest update element (limit {NOISE_LIMIT}); lowest (ranks, "
            f"one process run twice, norm over the largest): " + "; ".join(
                f"{n_} {held[n_][0]:.6f}, {self_cos[n_][0]:.6f}, {held[n_][1]:.2e}"
                for n_ in order) + ("" if snr is None else
                                    f"; stems SNR {[round(v, 2) for v in snr]} dB "
                                    f"(limit {PAR_SNR_DB})"))
        for r, pr in enumerate(per_rank):
            log(f"  rank {r}: launches a step {pr['launches']}, B1-train rows a step "
                f"{pr['rows']} (one process on the global batch: {ref['rows_step1']}), "
                f"collectives a step {pr['collectives']}, ms a step "
                f"{[round(v, 1) for v in pr['ms']]} ("
                f"{'the second profiled; ' if pr['collectives'] is not None else ''}two ranks "
                f"share one card: no measure of scaling)")
            kernels = ("B1-train", "B2") if impl == "pallas" else ()
            want = {k: (66 if k in kernels else 0) for k in pr["launches"]}
            if pr["launches"] != want or pr["rows"] != want_rows:
                bad.append(f"{tag} rank {r}: launches {pr['launches']}, rows {pr['rows']} "
                           f"(want {want}, {want_rows})")
        if not (rel <= PAR_LOSS_REL and noise <= NOISE_LIMIT and not failing
                and (snr is None or min(snr) >= PAR_SNR_DB)):
            bad.append(f"{tag}: loss rel {rel}, cosine {cos} ({worst}), leaves failing "
                       f"{failing[:5]}, noise {noise}, SNR {snr}")
    log("parallel (b): one-process steps, ms: " + "; ".join(
        f"{tag}: {[round(v, 1) for v in refs[tag]['ms']]}" for tag in refs)
        + f"; the ranks' run {wall:.1f} s on {gpu}")
    res["bad"] = bad
    if bad and not plant:
        fail("parallel (b): " + "; ".join(bad))
    return res


def phase_parallel(torch, np, gpu: str, phase7_ms, serve_rate):
    """Phase 13: the multi-GPU path on the one card.  Its work directory
    under chiprun_out is deleted after it, on a failure too."""
    res = {}
    try:
        os.makedirs(PARALLEL_WORK, exist_ok=True)
        for name, fn, args in (("world_one", par_world_one, (phase7_ms, serve_rate)),
                               ("two_ranks", par_two_ranks, ())):
            t0 = time.perf_counter()
            res[name] = fn(torch, np, gpu, *args)
            log(f"  {name}: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
    return res


QUALITY_WORK = os.path.join(HERE, "chiprun_out", "quality_work")
QUALITY_ARM, QUALITY_STEPS = "direct", 60       # one epoch of the quality A/B's recipe
QUALITY_OVERLAPS = (0.5, 0.25)
# guard rails of the 60-step direct run, fixed before its first run on the
# card (the JAX package's TPU run at step 60: val loss 0.410, sdr/avg 5.39):
# a port that learns passes them, one that does not fails them
QUALITY_VAL_LOSS_MAX = 0.55
QUALITY_SDR_GAIN_DB = 1.5                       # over the untrained baseline
# Runs tfswa_tpu_torch.tools.quality_ab's main with the given arguments, its
# arm's training CLI through CLI_RUNNER (its launch counters and shapes), and
# prints as its last line the tool's exit code and each CLI run's counts.
QUALITY_RUNNER = r"""
import json, subprocess, sys
import chip_smoke as cs
from tfswa_tpu_torch.tools import quality_ab
run, runs = subprocess.run, []

def counted_run(cmd, check, cwd):
    i = cmd.index("tfswa_tpu_torch.cli.train")
    res = run([sys.executable, "-c", cs.CLI_RUNNER, json.dumps(cmd[i + 1:])], cwd=cwd,
              capture_output=True, text=True)
    print(res.stdout, end="", flush=True)
    if res.returncode:
        print(res.stderr[-3000:], file=sys.stderr)
        if check:
            raise subprocess.CalledProcessError(res.returncode, cmd)
    runs.append(json.loads(res.stdout.strip().splitlines()[-1]))

quality_ab.subprocess.run = counted_run
rc = quality_ab.main(json.loads(sys.argv[1]))
print(json.dumps({"rc": rc, "runs": runs}))
"""


def quality_config(out: str = QUALITY_WORK, arm: str = QUALITY_ARM):
    """The Config that tools/quality_ab.py's command for ``arm`` gives the
    training CLI."""
    from tfswa_tpu_torch.cli import train as cli
    from tfswa_tpu_torch.tools import quality_ab

    cmd = quality_ab.arm_command(arm, 1, out)
    return cli.config_from_args(cli.build_parser().parse_args(
        cmd[cmd.index("tfswa_tpu_torch.cli.train") + 1:]))


def phase_quality_kernels(torch, covered):
    """Phase 14 (a): B1-train and B2 at each (N, C) of the quality A/B's
    train steps (2 s segments, F = 1025: T = 173), and B1 at each of its
    validation and SDR evaluation, that the earlier phases did not check
    (check_cli_run_shapes, their limits)."""
    return check_cli_run_shapes(torch, quality_config(), covered, "quality A/B", 14)


def overlap_launches(cfg, overlaps, tracks: int = 4, seconds: float = 30.0,
                     segment_seconds: float = 10.0, batch: int = 8) -> int:
    """B1 launches of overlap_ab.overlap_table on the 4 synthetic
    validation tracks: 66 a forward, ceil(segments / 8) forwards a track
    and overlap (host OLA)."""
    sr = cfg.stft.sample_rate
    seg, total = int(segment_seconds * sr), int(seconds * sr)
    forward = 3 * (2 * sum(cfg.model.depths[:3]) + cfg.model.depths[3])
    return sum(forward * tracks * -(-((total - seg) // int(seg * (1 - ov)) + 1) // batch)
               for ov in overlaps)


def quality_route_check(torch, np, model, cfg):
    """One 10 s segment of the first validation track through the trained
    model on "pallas" and on the plain route (a clone, same weights, bf16):
    the SNR per stem, and the share of the sigmoid head's outputs that are
    not saturated (inside (1e-3, 1 - 1e-3))."""
    from tfswa_tpu_torch.data.synthetic import SyntheticDataset
    from tfswa_tpu_torch.evaluation import SourceSeparator
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    d = cfg.data
    mix, _ = SyntheticDataset(num_tracks=4, track_seconds=30.0, segment_seconds=d.segment_seconds,
                              sample_rate=d.sample_rate, stems=d.stems, random_segments=False,
                              seed=999).get_full_track(0)
    proc = STFTProcessor(cfg.stft)
    x = torch.from_numpy(mix.mean(axis=0)[None, :10 * proc.sample_rate]).cuda()
    outs = []
    with torch.inference_mode():
        for m in (model, model.clone("xla")):
            sep = SourceSeparator(m, proc, segment_length=10.0, mask_mode="mag_direct",
                                  stem_names=d.stems, device="cuda")
            outs.append(sep._separate_core(x).double().cpu().numpy())
        spec = proc.stft(x.float()[:, None].expand(-1, model.in_channels // 2, -1))
        head = model(proc.to_model_input(spec)).float()
        live = float(((head > 1e-3) & (head < 1 - 1e-3)).float().mean())
    a, b = outs
    snrs = [float(10 * np.log10(np.sum(b[:, s] ** 2) / np.sum((a[:, s] - b[:, s]) ** 2)))
            for s in range(a.shape[1])]
    log(f"trained direct checkpoint, one 10 s segment: route pallas vs xla SNR per stem "
        f"{[round(v, 3) for v in snrs]} dB (min {SNR_MIN_DB} dB); head outputs not "
        f"saturated: {live:.4f}")
    if not np.isfinite(a).all() or min(snrs) < SNR_MIN_DB:
        fail(f"trained checkpoint: route pallas vs xla SNR {snrs} below {SNR_MIN_DB} dB")
    return {"snr_db": snrs, "head_live_share": live}


def quality_visualize(torch, model):
    """tools/visualize at the flagship (in/out 4) on the card: its TOTAL
    must be the model's parameter count, FLAGSHIP_PARAMETERS."""
    import contextlib
    import io

    from tfswa_tpu_torch.tools import visualize

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = visualize.main(["--in_channels", "4", "--out_channels", "4", "--device", "cuda"])
    total = next(int(line.split()[1].replace(",", "")) for line in buf.getvalue().splitlines()
                 if line.startswith("TOTAL"))
    count = model.count_parameters()
    log(f"visualize at the flagship: exit {rc}, TOTAL {total:,d}, the trained model's "
        f"{count:,d}, FLAGSHIP_PARAMETERS {FLAGSHIP_PARAMETERS:,d}")
    if rc != 0 or not total == count == FLAGSHIP_PARAMETERS:
        fail(f"visualize: exit {rc}, TOTAL {total} against {count} / {FLAGSHIP_PARAMETERS}")
    return total


def phase_quality(torch, np, gpu: str, covered, beside=None):
    """Phase 14 (b)-(d): the untrained sdr_baseline in a subprocess, beside
    the quality A/B's direct arm for one epoch (QUALITY_STEPS steps, one
    validation, one SDR evaluation) through tools/quality_ab.py in a
    subprocess (QUALITY_RUNNER), its launches against the design and the
    (N, C) of each against ``covered``, its step-60 val loss and sdr/avg
    held to the guard rails; then that checkpoint through
    overlap_ab.overlap_table at QUALITY_OVERLAPS (B1's launches as
    designed, finite SDRs), "pallas" against the plain route on one 10 s
    segment, and visualize at the flagship.  The checkpoints are deleted
    after it, on a failure too; the arm's metrics.jsonl is kept in
    chiprun_out/quality_direct_metrics.jsonl.  ``beside``, if given, runs in
    this process while the two subprocesses run (they wait mostly on the
    host); its failure fails the phase once they have ended."""
    from tfswa_tpu_torch.tools import overlap_ab

    shutil.rmtree(QUALITY_WORK, ignore_errors=True)
    os.makedirs(QUALITY_WORK)
    res = {}
    try:
        # the baseline beside the run: both processes wait mostly on the host
        def quality_run():
            t0 = time.perf_counter()
            out = run_tool("quality_ab", ["--arms", QUALITY_ARM, "--epochs", "1",
                                          "--out", QUALITY_WORK], runner=QUALITY_RUNNER)
            return out, time.perf_counter() - t0

        with ThreadPoolExecutor(2) as pool:
            baseline = pool.submit(run_tool, "sdr_baseline", [])
            quality = pool.submit(quality_run)
            if beside is not None:
                beside()
            out, res["run_s"] = quality.result()
            base = baseline.result()["untrained"]
        log(f"sdr_baseline, untrained: sdr/avg {base.get('sdr/avg')} (JAX TPU record 2.32)")
        if not all(math.isfinite(v) for v in base.values()) or "sdr/avg" not in base:
            fail(f"sdr_baseline: {base}")
        res["baseline"] = base
        arm_dir = os.path.join(QUALITY_WORK, QUALITY_ARM)
        shutil.copy(os.path.join(arm_dir, "metrics.jsonl"),
                    os.path.join(HERE, "chiprun_out", "quality_direct_metrics.jsonl"))
        if out["rc"] != 0 or len(out["runs"]) != 1:
            fail(f"quality_ab: exit {out['rc']}, {len(out['runs'])} runs")
        from tfswa_tpu_torch.config import Config

        with open(os.path.join(arm_dir, "ck", "config.json")) as fh:
            cfg = Config.from_dict(json.load(fh))
        cli_run = out["runs"][0]
        check_cli_launches(cli_run["launches"], cli_designed_launches(cfg, QUALITY_STEPS, 1, 1),
                           "quality run")
        check_cli_shapes(cli_run["shapes"], recipe_row_shapes(cfg), covered, "quality run")
        recs = read_cli_log(np, arm_dir)
        with open(os.path.join(QUALITY_WORK, "summary.json")) as fh:
            summary = json.load(fh)[QUALITY_ARM]
        (val,), (sdr,) = summary["val_curve"], summary["sdr_curve"]
        nums = cli_numbers(recs, cfg.data.batch_size, cfg.data.segment_seconds)
        res.update(launches=cli_run["launches"], shapes=cli_run["shapes"], summary=summary,
                   **nums)
        floor = base["sdr/avg"] + QUALITY_SDR_GAIN_DB
        log(f"quality A/B {QUALITY_ARM}, {QUALITY_STEPS} steps on {gpu}: {res['run_s']:.1f} s, "
            f"{nums['ms_per_step']:.3f} ms/step, peak {nums['peak_mem_gb']:.3f} GB; step "
            f"{val['step']} val loss {val['val_loss']:.4f} (at most {QUALITY_VAL_LOSS_MAX}; "
            f"JAX TPU 0.410), sdr/avg {sdr['sdr/avg']:.4f} (at least {floor:.4f}: the "
            f"baseline + {QUALITY_SDR_GAIN_DB} dB; JAX TPU 5.39)")
        if (val["step"], sdr["step"]) != (QUALITY_STEPS, QUALITY_STEPS):
            fail(f"quality run: records at steps {val['step']}, {sdr['step']}")
        if not val["val_loss"] <= QUALITY_VAL_LOSS_MAX or not sdr["sdr/avg"] >= floor:
            fail(f"quality run: val loss {val['val_loss']}, sdr/avg {sdr['sdr/avg']} "
                 f"outside the guard rails ({QUALITY_VAL_LOSS_MAX}, {floor})")

        model, cfg = overlap_ab.load_model(os.path.join(arm_dir, "ck"), "latest")
        t0 = time.perf_counter()
        reset_counts()
        table = overlap_ab.overlap_table(model, cfg, QUALITY_OVERLAPS, device="cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: overlap_launches(cfg, QUALITY_OVERLAPS) if k == "B1" else 0 for k in counts}
        res["overlap"] = dict(table=table, launches=counts, seconds=time.perf_counter() - t0)
        log(f"overlap_ab at {QUALITY_OVERLAPS}: {table}; launches {counts} (designed {want}), "
            f"{res['overlap']['seconds']:.1f} s")
        if counts != want or not all(math.isfinite(v) for e in table.values()
                                     for v in e.values()):
            fail(f"overlap_ab: launches {counts} (designed {want}), table {table}")
        res["route"] = quality_route_check(torch, np, model, cfg)
        res["visualize_total"] = quality_visualize(torch, model)
        del model
    finally:
        shutil.rmtree(QUALITY_WORK, ignore_errors=True)      # about 0.2 GB of checkpoints
        torch.cuda.empty_cache()
    return res


# ------------------------------------------------ phase 15: f32 and the remaining options
# The f32 forms of B1, B1-train, B2, B3 and B4 (csrc/*_f32*) against their
# plain versions in f32, on both sides with TF32 off (main() sets it):
F32_REGIMES = ("flat", "clamp")
# block and attention outputs (and q|k|v, mid): within F32_LIMIT x
# max(max|ref| / 4, 1); den within F32_LIMIT relative, elementwise
F32_LIMIT = 1e-4
# B2's dx and each gradient leaf within F32_LIMIT x the leaf's max|ref|
# the whole f32 model through a kernel route against the f32 plain route,
# one 10 s segment on conditioned weights, per stem (a TF32-class product
# lands near 60 dB; bf16's limit is SNR_MIN_DB)
F32_SNR_MIN_DB = 70.0
# one f32 train step against the plain route: loss, gradient cosine over
# all parameters and over each row-block leaf (but the ones whose gradient
# is 0 in exact arithmetic, zero_gradient_leaves, which hold noise)
F32_STEP_LOSS_REL = 1e-5
F32_STEP_COSINE = 0.99999
F32_STEP_LEAF_COSINE = 0.9999
# the f32 step's segments of phase 7's batch (no remat: 2 x 6 s fits the
# card with room to spare), and those of (e) and (f)
F32_TRAIN_SEGMENTS = 2
OPTION_SEGMENTS = 2
# the f32 bound: products at 3xTF32's rate, the fastest f32-accurate route
# on the card (the kernels use FFMA, 67 TFLOP/s, recorded beside it); B4's
# f64 parts (q|k and the scores) at the FP64 tensor cores' rate (DFMA's
# beside it)
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_FFMA_FLOPS = 67e12
PEAK_F64_TC_FLOPS = 67e12
PEAK_DFMA_FLOPS = 34e12
F32_TIMING_ROWS = PLAIN_ROWS
# the f32 libraries, by cuobjdump's SASS: every product of B1, B1-train, B2
# and B3 in 3xTF32 on the tensor cores (HMMA with TF32 operands), and B4's
# out-projection, the same tile; B3's scores IMMA (the int8 forms of
# attn_kernel); the scores of the other attention kernels FFMA (one f32 FMA
# chain a score) and B4's p . v too, and the forms for a head of at most 8
# channels (_ffma: the whole attention on the CUDA cores, where the tensor
# cores do not pay); B4's f64 parts (q|k and the scores)
# DMMA, the FP64 tensor cores; no kernel of SASS_ABSENT (B4's old bilinear
# t = x A_h); every function one of ours
SASS_TF32 = {"fused_block_f32": ("gemm_kernel", "attn_kernel"),
             "fused_block_bwd_f32": ("gemm_kernel", "atb_kernel", "attn_bwd_q_kernel",
                                     "attn_bwd_kv_kernel"),
             "row_attention_f32": ("gemm_kernel",)}
SASS_CHAIN = {"fused_block_f32": ("attn_kernel", "attn_ffma_kernel"),
              "fused_block_bwd_f32": ("attn_bwd_q_kernel", "attn_bwd_kv_kernel",
                                      "attn_bwd_q_ffma_kernel", "attn_bwd_kv_ffma_kernel"),
              "row_attention_f32": ("attn_kernel",)}
SASS_DMMA = {"row_attention_f32": ("qkv_kernel", "attn_kernel")}
SASS_ABSENT = {"row_attention_f32": ("8t_kernel",)}
# the f32 forms' launches, timed apart in phase 15 (a) (a profiler trace a
# shape): B4's, the forward's (B1, B1-train, B3: B3 alone runs the two
# quantisation launches; a head of at most 8 channels runs the _ffma
# attention) and B2's
B4_F32_LAUNCHES = ("qkv_kernel", "attn_kernel", "gemm_kernel")
F32_FWD_LAUNCHES = ("ln_stats_kernel", "gemm_kernel", "qk_scale_kernel", "quantize_kernel",
                    "attn_kernel", "attn_ffma_kernel")
B2_F32_LAUNCHES = ("ln_stats_kernel", "gemm_kernel", "ln_bwd_kernel", "attn_prep_kernel",
                   "attn_bwd_q_kernel", "attn_bwd_kv_kernel", "attn_bwd_q_ffma_kernel",
                   "attn_bwd_kv_ffma_kernel", "atb_kernel", "colsum_kernel", "sum_parts_kernel")
# the largest head (channels) whose attention runs the _ffma forms
F32_FFMA_MAX_D = 8
F32_LIBS = tuple(SASS_TF32)
F32_ROUTES = {"pallas": "B1-f32", "pallas_int8": "B3-f32", "pallas_attn": "B4-f32"}


def f32_launches_at(kind: str, C: int, H: int = HEADS):
    """The launches of f32 form ``kind`` that run at width C with H heads."""
    if kind == "B4":
        return B4_F32_LAUNCHES
    ffma = C // H <= F32_FFMA_MAX_D
    names = B2_F32_LAUNCHES if kind == "B2" else F32_FWD_LAUNCHES
    return tuple(n for n in names
                 if (kind in ("B3", "B2") or n not in ("qk_scale_kernel", "quantize_kernel"))
                 and (not n.startswith("attn_") or n == "attn_prep_kernel"
                      or ("ffma" in n) == ffma))


def f32_tol(ref_max: float) -> float:
    """The f32 kernels' limit at a result whose largest magnitude is ref_max."""
    return F32_LIMIT * max(ref_max / 4.0, 1.0)


def f32_forward_launches(depths=(2, 2, 6, 2), seconds: float = 120.0) -> int:
    """f32 B1 launches of a fast-serving separation of ``seconds`` of audio:
    one forward a batch of 8 ten-second segments (2 for 120 s), 3 row blocks
    a TFSWABlock."""
    batches = 2 if seconds == 120.0 else 1
    return batches * forward_launches(depths)


def sass_f32_check():
    """The f32 libraries' SASS (cuobjdump --dump-sass) against SASS_TF32,
    SASS_CHAIN, SASS_DMMA and SASS_ABSENT: every instantiation of a kernel
    of SASS_TF32 but the f32 lab's cuts (lab_cut_form) holds HMMA with TF32
    operands, every int8 form of
    attn_kernel (int8_form) IMMA, every other instantiation of a kernel of
    SASS_CHAIN FFMA, every one of SASS_DMMA DMMA; none of SASS_ABSENT is
    there, and every function is one of the port's (namespace f32): no
    library kernel.  Fails the run otherwise; returns {library: {function:
    {"tf32": HMMA.TF32, "imma": IMMA, "ffma": FFMA, "dmma": DMMA counts}}}."""
    from pathlib import Path

    from tfswa_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    found, bad = {}, []
    for lib in F32_LIBS:
        res = subprocess.run([str(tool), "--dump-sass", str(_build.BUILD_DIR / f"lib{lib}.so")],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            fail(f"cuobjdump --dump-sass lib{lib}.so failed: {res.stderr[-2000:]}")
        counts, fn = {}, None
        for line in res.stdout.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = dict.fromkeys(("tf32", "imma", "ffma", "dmma"), 0)
                if not fn.startswith("_ZN3f32"):
                    bad.append(f"{lib}: {fn} is not one of the port's kernels")
            elif fn:
                c = counts[fn]
                c["tf32"] += "HMMA" in line and "TF32" in line
                c["imma"] += "IMMA" in line
                c["ffma"] += "FFMA" in line
                c["dmma"] += "DMMA" in line
        found[lib] = counts

        def held(names, key, pick=lambda f: True):
            for n in names:
                fns = [f for f in counts if n in f and pick(f)]
                if not fns:
                    bad.append(f"{lib}: no {n} in the SASS")
                bad.extend(f"{lib}: {f}: no {key.upper()}" for f in fns if counts[f][key] == 0)

        held(SASS_TF32.get(lib, ()), "tf32", lambda f: not lab_cut_form(f))
        held(["attn_kernel"] if lib == "fused_block_f32" else [], "imma", int8_form)
        held(SASS_CHAIN.get(lib, ()), "ffma", lambda f: not int8_form(f))
        held(SASS_DMMA.get(lib, ()), "dmma")
        bad += [f"{lib}: {f} is there" for n in SASS_ABSENT.get(lib, ()) for f in counts
                if n in f]

        def span(n, key):
            cs = [c[key] for f, c in counts.items() if n in f]
            return f"{n} {min(cs)}-{max(cs)}" if cs else f"{n} none"

        log(f"  SASS {lib}: {len(counts)} kernels; HMMA.TF32 "
            + ", ".join(span(n, "tf32") for n in SASS_TF32.get(lib, ()))
            + "; FFMA " + ", ".join(span(n, "ffma") for n in SASS_CHAIN.get(lib, ()))
            + "".join(f"; IMMA {span(n, 'imma')}" for n in ("attn_kernel",)
                      if lib == "fused_block_f32")
            + "".join(f"; DMMA {span(n, 'dmma')}" for n in SASS_DMMA.get(lib, ())))
    if bad:
        fail("f32 SASS check: " + "; ".join(bad))
    return found


def bound_f32_ms(kind: str, R: int, N: int, C: int, hidden: int, peak: float = PEAK_F32_FLOPS,
                 H: int = HEADS):
    """Least time for one call of an f32 form (``kind`` B1, B1-train, B3,
    B2 or B4): its inputs read once and outputs written once in f32 (B1,
    B3, B1-train: rows, out and the weights; B1-train also mid, acc, den;
    B2 as bound_bwd_ms with f32 tensors, weights in and f32 gradients out;
    B4: rows in and out, the qkv kernel, Wo and b) over the HBM rate, the
    products over ``peak`` (3xTF32's third of the TF32 rate unless told
    otherwise), B3's scores over the int8 peak, and exp2 over the MUFU
    rate.  B4 counts its function's work once: q|k (4 M C^2) and the
    scores (2 R N^2 C) in f64 over the FP64 tensor cores' rate (DFMA's
    where ``peak`` is FFMA's), v and the out-projection (4 M C^2) and p . v
    (2 R N^2 C) over ``peak``, H N^2 exp a row over the MUFU rate."""
    M = R * N
    weights = 4 * C * C + 2 * C * hidden + 6 * C + hidden
    scores = 2 * R * N * N * C
    exp2 = R * H * N * N
    if kind == "B2":
        nbytes = 4 * 5 * M * C + 4 * R * H * N + 4 * weights + 4 * weights
        flops = 2 * M * (3 * C * C + C * hidden + 4 * C * hidden + 2 * C * C + 6 * C * C) \
            + 5 * scores
        int8 = 0
    elif kind == "B4":
        nbytes = 4 * 2 * M * C + 4 * 4 * C * C + 4 * C
        f64 = 4 * M * C * C + scores
        flops = 4 * M * C * C + scores
        f64_peak = PEAK_DFMA_FLOPS if peak == PEAK_FFMA_FLOPS else PEAK_F64_TC_FLOPS
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = max(f64 / f64_peak + flops / peak, exp2 / MUFU_RATE) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    else:
        nbytes = 4 * (2 * M * C + weights)
        if kind == "B1-train":
            nbytes += 4 * 2 * M * C + 4 * R * H * N
        flops = 2 * M * (4 * C * C + 2 * C * hidden) + scores + (0 if kind == "B3" else scores)
        int8 = scores if kind == "B3" else 0
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = max(flops / peak + int8 / PEAK_INT8_OPS, exp2 / MUFU_RATE) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def b4_truth(torch, x, qkv_kernel, proj_kernel, proj_bias, H: int):
    """B4's function in float64 on ``x`` (R, N, C): (out, acc).  B4's scores
    t . x run to hundreds in the clamp regime, where the plain version's
    own f32 rounding of them moves its result by more than the f32 limit
    (recorded beside the kernel's); the f64 function is the truth the
    kernel is held to."""
    from tfswa_tpu_torch.ops.row_attention import bilinear_weights

    C = x.shape[-1]
    D = C // H
    a, wv = bilinear_weights(qkv_kernel, H, torch.float64)
    a, wv, wp, b = a.double(), wv.double(), proj_kernel.double(), proj_bias.double()
    outs, accs = [], []
    for r0 in range(0, x.shape[0], 8):
        xd = x[r0:r0 + 8].double()
        v = xd @ wv
        acc = torch.empty_like(xd)
        for h in range(H):
            s = (xd @ a[h]) @ xd.transpose(-1, -2)
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            heads = slice(h * D, (h + 1) * D)
            acc[..., heads] = (e / e.sum(dim=-1, keepdim=True)) @ v[..., heads]
        outs.append(acc @ wp + b)
        accs.append(acc)
    return torch.cat(outs), torch.cat(accs)


def _f32_block_checks(torch, N: int, C: int, gen, train: bool, H: int = HEADS, hidden=None):
    """B1, B3, B4 (serving) or B1-train, B2 (``train``) in f32 against their
    plain versions on CHECK_ROWS rows, for each regime of F32_REGIMES.  The
    plain versions get the kernel's own q|k|v (B3's int8 values and B2's
    clamp edge are discontinuous in q and k); q|k|v itself is held against
    the plain recompute.  B4 runs on LN1 output and is held against its
    function in float64 (b4_truth) at the f32 limit; the plain f32
    version's distance from that function is recorded beside it (it is
    over the limit where scores reach the hundreds)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops import row_attention as ra

    def held(name, got, ref, limit=None):
        m = ref.float().abs().max().item()
        tol = f32_tol(m) if limit is None else limit * max(m, 1e-30)
        err = _max_abs(got, ref)
        finite = bool(torch.isfinite(got.float()).all())
        return {"err": err, "tol": tol, "ok": finite and err <= tol, "name": name}

    res = {}
    for regime in F32_REGIMES:
        p = random_params(torch, RowBlockParams, C, gen, regime, hidden)
        x = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda()
        c = []
        if not train:
            run = fb._forward_kernel(x, p, H)
            c.append(held("qkv", run.qkv, plain_qkv(torch, x, p, H)))
            ref, ref_attn = fb.fused_row_block_reference_parts(x, p, H, qkv=run.qkv)
            c += [held("B1 out", run.out, ref), held("B1 attn", run.attn, ref_attn)]
            run8 = fb._forward_kernel(x, p, H, int8=True)
            ref8, ref8_attn = fb.fused_row_block_int8_reference_parts(x, p, H, qkv=run8.qkv)
            q3 = run8.qkv.view(CHECK_ROWS, N, 3 * C)
            (qi, sq), (ki, sk) = fb.quantize_rows(q3[..., :C]), fb.quantize_rows(q3[..., C:2 * C])
            qk = run8.qk.view(CHECK_ROWS, N, 2 * C).float()
            wrong = int((qk[..., :C] != qi).sum() + (qk[..., C:] != ki).sum()
                        + (run8.scales[:, 0] != sq.flatten()).sum()
                        + (run8.scales[:, 1] != sk.flatten()).sum())
            c += [held("B3 out", run8.out, ref8), held("B3 attn", run8.attn, ref8_attn),
                  {"name": "B3 int8 mismatches", "err": wrong, "tol": 0, "ok": wrong == 0}]
            xn = ln1_rows(torch, x, p)
            w = [p.qkv_kernel, p.proj_kernel, p.proj_bias]
            out4, acc4, _, _ = ra._kernel(xn, *w, H)
            truth = b4_truth(torch, xn, *w, H)
            plain = ra.flash_row_attention_reference_parts(xn, *w, H)
            for name, got, ref, pl in zip(("out", "acc"), (out4, acc4), truth, plain):
                e = held(f"B4 {name}", got, ref)
                c += [e, {"name": f"B4 plain {name} (recorded)", "err": _max_abs(pl, ref),
                          "tol": e["tol"], "ok": True}]
        else:
            g = torch.randn(CHECK_ROWS, N, C, generator=gen).cuda()
            out, mid, acc, den = fb.fused_row_block_train(x, p, H)
            again = fb._forward_kernel(x, p, H, train=True)
            r_out, r_mid, r_acc, r_den = fb.fused_row_block_train_reference(x, p, H,
                                                                            qkv=again.qkv)
            c += [held("qkv", again.qkv, plain_qkv(torch, x, p, H)),
                  held("B1-train out", out, r_out), held("B1-train mid", mid, r_mid),
                  held("B1-train acc", acc, r_acc)]
            den_rel = ((den - r_den).abs() / r_den.abs()).max().item()
            c.append({"name": "B1-train den (rel)", "err": den_rel, "tol": F32_LIMIT,
                      "ok": den_rel <= F32_LIMIT})
            parts = fb.fused_row_block_bwd_parts(x, mid, acc, den, g, p, H)
            twice = fb.fused_row_block_bwd_parts(x, mid, acc, den, g, p, H)
            ref = fb.fused_row_block_bwd_reference_parts(x, mid, acc, den, g, p, H,
                                                         qkv=again.qkv)
            c.append(held("B2 dx", parts.dx, ref.dx, F32_LIMIT))
            c += [held(f"B2 d{n}", a, b, F32_LIMIT)
                  for n, a, b in zip(RowBlockParams._fields, parts.dp, ref.dp)]
            same = all(bool(torch.equal(a, b)) for a, b in zip(
                (parts.dx, *parts.dp, parts.dqkv), (twice.dx, *twice.dp, twice.dqkv)))
            c.append({"name": "B2 twice bit for bit", "err": 0 if same else 1, "tol": 0,
                      "ok": same})
            del parts, twice, ref, again
        s_max = max_score(torch, x, p, H)
        clamp_ok = regime != "clamp" or s_max > fb.SCORE_CLAMP
        res[regime] = {"checks": c, "max_score": s_max,
                       "ok": clamp_ok and all(e["ok"] for e in c)}
        torch.cuda.empty_cache()
    return res, p


def _f32_time(torch, kind: str, R: int, N: int, C: int, p, gen, H: int = HEADS, lib=None):
    """kernel / plain / library ms and the bounds of one f32 call at the
    full row count R (the plain version on F32_TIMING_ROWS rows, scaled by
    R; the library yardstick in f32 with TF32 off; those two over one call
    after a warm-up call; each launch of the form, f32_launches_at, from
    a profiler trace of one call).  ``lib``:
    a dict shared by the kinds timed at one shape, so that the library
    block is timed once there (B1's for B3, B1-train's for B2)."""
    lib = {} if lib is None else lib

    def block_ms(x_):
        if "block" not in lib:
            lib["block"] = cuda_ms(torch, lambda: library_block(torch, x_, p, H), 1)
        return lib["block"]

    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops import row_attention as ra

    rs = min(R, F32_TIMING_ROWS)
    x = card_randn(torch, (R, N, C), gen)
    if kind == "B4":
        x = ln1_rows(torch, x, p)
        w = [p.qkv_kernel, p.proj_kernel, p.proj_bias]
        k_ms = cuda_ms(torch, lambda: ra.flash_row_attention(x, *w, H), 2)
        parts = launch_ms(torch, lambda: ra.flash_row_attention(x, *w, H), B4_F32_LAUNCHES, 1)
        pl_ms = cuda_ms(torch, lambda: ra.flash_row_attention_reference(x[:rs], *w, H), 1)
        lib_ms = cuda_ms(torch, lambda: library_attn(torch, x, *w, H), 1)
    elif kind in ("B1", "B3"):
        run = fb.fused_row_block if kind == "B1" else fb.fused_row_block_int8
        plain = fb.fused_row_block_reference if kind == "B1" else fb.fused_row_block_int8_reference
        k_ms = cuda_ms(torch, lambda: run(x, p, H), 2)
        parts = launch_ms(torch, lambda: run(x, p, H), f32_launches_at(kind, C, H), 1)
        pl_ms = cuda_ms(torch, lambda: plain(x[:rs], p, H), 1)
        lib_ms = block_ms(x)
    else:
        g = card_randn(torch, (R, N, C), gen)
        _, mid, acc, den = fb.fused_row_block_train(x, p, H)
        if kind == "B1-train":
            k_ms = cuda_ms(torch, lambda: fb.fused_row_block_train(x, p, H), 2)
            parts = launch_ms(torch, lambda: fb.fused_row_block_train(x, p, H),
                              f32_launches_at(kind, C, H), 1)
            pl_ms = cuda_ms(torch, lambda: fb.fused_row_block_train_reference(
                x[:rs], p, H), 1)
            lib_ms = block_ms(x)
        else:
            k_ms = cuda_ms(torch, lambda: fb.fused_row_block_bwd(x, mid, acc, den, g, p,
                                                                 H), 2)
            parts = launch_ms(torch, lambda: fb.fused_row_block_bwd(x, mid, acc, den, g, p, H),
                              f32_launches_at(kind, C, H), 1)
            pl_ms = cuda_ms(torch, lambda: fb.fused_row_block_bwd_reference(
                x[:rs], mid[:rs], acc[:rs], den[:rs], g[:rs], p, H), 1)
            lfb = cuda_ms(torch, lambda: library_fwd_bwd(torch, x, p, H, g), 1)
            lib_ms = max(lfb - block_ms(x), 0.0)
        del mid, acc, den, g
    b_ms, b_by = bound_f32_ms(kind, R, N, C, 4 * C, H=H)
    ffma_ms, _ = bound_f32_ms(kind, R, N, C, 4 * C, PEAK_FFMA_FLOPS, H)
    del x
    torch.cuda.empty_cache()
    res = {"ms": k_ms, "plain_ms": pl_ms * R / rs, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_ffma_ms": ffma_ms, "plain_rows_timed": rs,
           "launch_ms": parts}
    return res


def f32_kernels(torch, quick: bool = False, misses=None):
    """(a) each f32 form against its plain version (checks on 64 rows, at
    the 12 serving (N, C) for B1, B3, B4 and the 12 training (N, C) for
    B1-train and B2, flat and clamp weights), then its kernel / plain /
    library time at the full row counts with its bounds, summed a forward
    (66 calls) or a train step.  ``misses``: a list that receives the
    label of each (shape, regime) that missed, before the run fails."""
    gen = torch.Generator().manual_seed(15)
    gen_full = torch.Generator().manual_seed(16)
    shapes, misses = [], ([] if misses is None else misses)
    err = dict.fromkeys(("B1", "B3", "B4", "B1-train", "B2"), 0.0)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms", "bound_ffma_ms")
    totals = {k: dict.fromkeys(keys, 0.0) for k in err}
    launches = {k: {} for k in err}
    for train, table in ((False, SHAPES), (True, TRAIN_SHAPES)):
        for stage, attn, N, C, R in table:
            checks, p = _f32_block_checks(torch, N, C, gen, train)
            label = f"{'train' if train else 'serving'} stage {stage} {attn} N={N} C={C}"
            for regime, r in checks.items():
                for e in r["checks"]:
                    kind = e["name"].split()[0]
                    if kind in err and not any(w in e["name"] for w in (
                            "mismatch", "twice", "recorded")):
                        err[kind] = max(err[kind], e["err"])
                log(f"f32 check {label} {regime:5s}: " + ", ".join(
                    f"{e['name']} {e['err']:.2e}/{e['tol']:.2e}" for e in r["checks"])
                    + f"; max score {r['max_score']:.1f} {'ok' if r['ok'] else 'MISS'}")
                if not r["ok"]:
                    misses.append(f"{label} {regime}")
            entry = {"path": "train" if train else "serving", "stage": stage, "attn": attn,
                     "N": N, "C": C, "R_full": R, "checks": checks}
            calls = BLOCKS_PER_STAGE[stage]
            timed = () if quick else ("B1-train", "B2") if train else ("B1", "B3", "B4")
            lib = {}
            for kind in timed:
                t = _f32_time(torch, kind, R, N, C, p, gen_full, lib=lib)
                entry[kind] = t
                for k in keys:
                    if k == "bound_bytes_ms":
                        totals[kind][k] += calls * t["bound_ms"] if t["bound_by"] == "bytes" else 0
                    else:
                        totals[kind][k] += calls * t[k]
                for n, ms in t["launch_ms"].items():
                    was = launches[kind].get(n, 0.0)
                    launches[kind][n] = None if ms is None or was is None else was + calls * ms
                log(f"  full R={R} {kind} f32 launches (device ms): " + ", ".join(
                    f"{n} {'not measured' if ms is None else f'{ms:.3f}'}"
                    for n, ms in t["launch_ms"].items()))
                log(f"  full R={R} {kind} f32: kernel_ms {t['ms']:.3f} plain_ms "
                    f"{t['plain_ms']:.3f} (timed on {t['plain_rows_timed']} rows) library_ms "
                    f"{t['library_ms']:.3f} bound_ms {t['bound_ms']:.4f} ({t['bound_by']}; "
                    f"at the FFMA rate {t['bound_ffma_ms']:.4f})")
            shapes.append(entry)
    if misses:
        fail("the f32 kernels disagree with their plain versions at " + "; ".join(misses))
    for kind, t in () if quick else totals.items():
        log(f"per {'train step' if kind in ('B1-train', 'B2') else 'model forward'} (66 "
            f"calls), {kind} f32: kernel_ms {t['ms']:.3f} plain_ms {t['plain_ms']:.3f} "
            f"library_ms {t['library_ms']:.3f} bound_ms {t['bound_ms']:.4f} (FFMA "
            f"{t['bound_ffma_ms']:.4f})")
    for kind, t in () if quick else totals.items():
        t["launch_ms"] = launches[kind]
        log(f"per {'train step' if kind in ('B1-train', 'B2') else 'model forward'} (66 "
            f"calls), {kind} f32 launches (device ms): " + ", ".join(
                f"{n} {'not measured' if ms is None else f'{ms:.3f}'}"
                for n, ms in launches[kind].items()))
    return shapes, err, totals


def _segment_snr(np, a, b):
    return [float(10 * np.log10(np.sum(b[:, s] ** 2) / np.sum((a[:, s] - b[:, s]) ** 2)))
            for s in range(a.shape[1])]


def f32_serving(torch, np, gpu: str, model_kw=None, label: str = "f32 (b)"):
    """(b) the f32 flagship on conditioned weights: the 120 s track through
    "pallas" (132 f32 B1 launches, no other kernel: counts set to 0 just
    before the separation and read just after), its audio-s/s; then one
    10 s segment through each kernel route ("pallas_int8": 66 f32 B3,
    "pallas_attn": 66 f32 B4, each alone) against the f32 plain route at
    F32_SNR_MIN_DB a stem.  ``model_kw``: ModelConfig fields other than
    the flagship's (phase 16 (c))."""
    res = {}
    model_kw = model_kw or {}
    sep = make_separator(torch, "pallas", dtype="float32", **model_kw)
    condition_weights(torch, np, sep.model)
    forwards = []
    sep.model.register_forward_pre_hook(lambda m, a: forwards.append(a[0].shape[0]))
    audio = synthetic_track(np, 120.0, sep.sample_rate)
    t0 = time.perf_counter()
    sep.separate(audio)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    forwards.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = sep.separate(audio)
    runs = [time.perf_counter() - t0]           # one timed run (two until PR 14)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {k: (f32_forward_launches() if k == "B1-f32" else 0) for k in counts}
    bad = [n for n, w in out.items() if w.shape != (1, audio.size) or not np.isfinite(w).all()]
    rate = 120.0 / min(runs)
    log(f"{label} pallas: 120 s track, {len(forwards)} forwards, launches {counts}; runs "
        f"{[round(r, 4) for r in runs]} s (warm-up {warm_s:.3f} s): {rate:.4f} audio-s/s on "
        f"{gpu}; peak {peak:.3f} GB")
    if counts != want or bad:
        fail(f"f32 serving: expected launches {want}, got {counts}; bad stems {bad}")
    res["pallas"] = {"launches": counts["B1-f32"], "runs_s": runs, "warmup_s": warm_s,
                     "audio_s_per_s": rate, "peak_mem_gb": peak}
    seg = torch.from_numpy(synthetic_track(np, 10.0, sep.sample_rate)[None]).cuda()
    plain = separator_with(torch, sep.model, "xla", dtype="float32", **model_kw)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = plain._separate_core(seg).double().cpu().numpy()
        plain_s = time.perf_counter() - t0
    del plain
    for impl, kernel in F32_ROUTES.items():
        s = sep if impl == "pallas" else separator_with(torch, sep.model, impl, dtype="float32",
                                                        **model_kw)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got = s._separate_core(seg).double().cpu().numpy()
        seg_s = time.perf_counter() - t0
        counts = read_counts()
        snr = _segment_snr(np, got, ref)
        want = {k: (66 if k == kernel else 0) for k in counts}
        log(f"{label} {impl}: one 10 s segment in {seg_s:.3f} s (plain route {plain_s:.3f} s), "
            f"launches {counts}; SNR against the f32 plain route {[round(v, 3) for v in snr]} "
            f"dB (min {F32_SNR_MIN_DB})")
        if counts != want or not np.isfinite(got).all() or min(snr) < F32_SNR_MIN_DB:
            fail(f"f32 route {impl}: launches {counts} (expected {want}), SNR {snr}")
        res.setdefault(impl, {}).update(segment_launches=counts[kernel], segment_s=seg_s,
                                        snr_db=snr, plain_segment_s=plain_s)
        if impl != "pallas":
            del s
        torch.cuda.empty_cache()
    del sep
    torch.cuda.empty_cache()
    return res


def _grad_vector(torch, model):
    return torch.cat([p.grad.flatten().double() for p in model.parameters()])


def f32_train(torch, np, gpu: str, model_kw=None, label: str = "f32 (c)"):
    """(c) one f32 train step through "pallas" (66 f32 B1-train + 66 f32 B2,
    nothing else: counts set to 0 just before, read just after) on
    F32_TRAIN_SEGMENTS x 6 s of phase 7's batch, no remat, against the
    plain route's first step from the same weights: loss, gradient cosine
    overall and per row-block leaf; then a second step timed and the
    peak memory."""
    mix, targets = train_batch(torch, np)
    mix = mix[:F32_TRAIN_SEGMENTS]
    targets = {k: v[:F32_TRAIN_SEGMENTS] for k, v in targets.items()}
    model_kw = model_kw or {}
    zero = zero_gradient_leaves()
    out, grads, leaves = {}, {}, {}
    for impl in ("pallas", "xla"):
        state, step = make_trainer(torch, impl, dtype="float32", **model_kw)[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = read_counts()
        grads[impl] = _grad_vector(torch, state.model)
        leaves[impl] = {n: p.grad.double().flatten() for n, p in state.model.named_parameters()
                        if any(f".{a}." in n for a in ("tsa", "fsa", "swa"))}
        rec = {"total_loss": float(loss["total_loss"]), "launches": counts,
               "first_step_s": first_s}
        if impl == "pallas":
            want = {k: (66 if k in ("B1-train-f32", "B2-f32") else 0) for k in counts}
            if counts != want:
                fail(f"f32 train step: expected launches {want}, got {counts}")
            t0 = time.perf_counter()
            step(state, mix, targets)
            torch.cuda.synchronize()
            rec.update(ms_per_step=(time.perf_counter() - t0) * 1e3,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[impl] = rec
        del state, step
        torch.cuda.empty_cache()
    a, b = grads["pallas"], grads["xla"]
    cos = float((a @ b) / (a.norm() * b.norm()))
    ref_loss = out["xla"]["total_loss"]
    rel = abs(out["pallas"]["total_loss"] - ref_loss) / abs(ref_loss)
    leaf_cos = {}
    for n, g in leaves["pallas"].items():
        r = leaves["xla"][n]
        den = float(g.norm() * r.norm())
        leaf_cos[n] = float(g @ r) / den if den else float(torch.equal(g, r))
    held = {n: c for n, c in leaf_cos.items() if n not in zero}
    worst = min(held, key=held.get)
    out.update(loss_rel=rel, grad_cosine=cos, leaf_cosine_min=held[worst], worst_leaf=worst,
               leaves_held=len(held), leaves_recorded={n: c for n, c in leaf_cos.items()
                                                       if n in zero})
    log(f"{label} train step on {F32_TRAIN_SEGMENTS} x {TRAIN_SECONDS} s, no remat: "
        f"launches {out['pallas']['launches']}, {out['pallas']['ms_per_step']:.3f} ms/step, "
        f"peak {out['pallas']['peak_mem_gb']:.3f} GB on {gpu}; vs the plain route: loss rel "
        f"{rel:.2e} (limit {F32_STEP_LOSS_REL}), gradient cosine {cos:.8f} (min "
        f"{F32_STEP_COSINE}), row-block leaves {len(held)} held, worst {held[worst]:.8f} "
        f"({worst}; min {F32_STEP_LEAF_COSINE})")
    if not (rel <= F32_STEP_LOSS_REL and cos >= F32_STEP_COSINE
            and held[worst] >= F32_STEP_LEAF_COSINE):
        fail(f"f32 train step vs the plain route: loss rel {rel}, cosine {cos}, worst leaf "
             f"{worst} {held[worst]}")
    return out


def f32_export(torch, np, gpu: str):
    """(d) the f32 kernel routes at EXPORT_SHAPE, depths EXPORT_DEPTHS: the
    torch.export program (.pt2) and the TorchScript trace, each saved,
    loaded back and run with the counts set to 0 just before and read just
    after (21 launches of the route's f32 kernel, 3 a TFSWABlock, none of
    any other) and equal to the model's eager forward bit for bit, under
    cudnn.deterministic (without it the eager forward itself differs from
    run to run in its last bits: cuDNN's algorithms for the transposed
    convs sum in no fixed order; the kernels' launches are bit for bit
    either way)."""
    from tfswa_tpu_torch.optimization import (export_savedmodel, export_stablehlo,
                                              make_forward_fn)

    res = {}
    os.makedirs(OPT_WORK, exist_ok=True)
    x = torch.randn(EXPORT_SHAPE, generator=torch.Generator().manual_seed(7)).cuda()
    want_n = forward_launches(EXPORT_DEPTHS)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for impl, kernel in F32_ROUTES.items():
            t0 = time.perf_counter()
            model = opt_model(torch, np, impl=impl, dtype="float32", depths=EXPORT_DEPTHS)
            eager = make_forward_fn(model)(x)
            pt2 = os.path.join(OPT_WORK, f"{impl}.pt2")
            ts = os.path.join(OPT_WORK, f"{impl}_ts")
            info = {"pt2": export_stablehlo(model, pt2, EXPORT_SHAPE, verify=False),
                    "torchscript": export_savedmodel(model, ts, EXPORT_SHAPE, verify=False)}
            loaded = {"pt2": torch.export.load(pt2).module(),
                      "torchscript": torch.jit.load(os.path.join(ts, "model.pt"),
                                                    map_location="cuda")}
            for name, fn in loaded.items():
                torch.cuda.synchronize()
                reset_counts()
                with torch.no_grad():
                    got = fn(x)
                torch.cuda.synchronize()
                counts = read_counts()
                want = {k: (want_n if k == kernel else 0) for k in counts}
                equal = bool(torch.equal(got, eager))
                info[name].update(launches=counts[kernel], equal=equal,
                                  max_abs_diff=float((got - eager).abs().max()))
                if counts != want or not equal:
                    fail(f"f32 export {impl} {name}: launches {counts} (expected {want}), "
                         f"equal to the model {equal}")
            info["seconds"] = time.perf_counter() - t0
            log(f"f32 (d) {impl}: .pt2 {info['pt2']['bytes']} bytes and TorchScript "
                f"{info['torchscript']['bytes']} bytes loaded back, each {want_n} {kernel} "
                f"launches and equal to the model bit for bit ({info['seconds']:.1f} s)")
            res[impl] = info
            del model, loaded
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(OPT_WORK, ignore_errors=True)
    return res


def f32_param_bf16(torch, np, gpu: str):
    """(e) param_dtype="bfloat16" with dtype="bfloat16" through "pallas":
    two train steps on OPTION_SEGMENTS x 6 s, each with 66 B1-train + 66 B2
    (bf16) launches, finite and falling loss, every parameter, gradient and
    Adam moment in bf16 (the running statistics f32)."""
    mix, targets = train_batch(torch, np)
    mix = mix[:OPTION_SEGMENTS]
    targets = {k: v[:OPTION_SEGMENTS] for k, v in targets.items()}
    state, step = make_trainer(torch, "pallas", param_dtype="bfloat16")[:2]
    losses, per_step = [], []
    for _ in range(2):
        reset_counts()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        per_step.append(read_counts())
        losses.append(float(loss["total_loss"]))
    model = state.model
    dtypes = {str(p.dtype) for p in model.parameters()}
    grad_dtypes = {str(p.grad.dtype) for p in model.parameters() if p.grad is not None}
    moments = {str(v.dtype) for s in state.tx.adamw.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")}
    stats = {str(b.dtype) for n, b in model.named_buffers() if "running" in n}
    want = {k: (66 if k in ("B1-train", "B2") else 0) for k in per_step[0]}
    res = {"losses": losses, "launches": per_step, "param_dtypes": sorted(dtypes),
           "grad_dtypes": sorted(grad_dtypes), "moment_dtypes": sorted(moments),
           "running_stat_dtypes": sorted(stats)}
    log(f"f32 (e) param_dtype=bfloat16: losses {losses}, launches {per_step[-1]}; parameters "
        f"{sorted(dtypes)}, gradients {sorted(grad_dtypes)}, Adam moments {sorted(moments)}, "
        f"running stats {sorted(stats)}")
    if (any(c != want for c in per_step) or not all(math.isfinite(v) for v in losses)
            or not losses[1] < losses[0] or dtypes != {"torch.bfloat16"}
            or grad_dtypes != {"torch.bfloat16"} or moments != {"torch.bfloat16"}
            or stats != {"torch.float32"}):
        fail(f"param_dtype=bfloat16 step: {res}")
    del state, step
    torch.cuda.empty_cache()
    return res


def f32_remat_policy(torch, np, gpu: str):
    """(f) one "dots" remat step through "pallas" (bf16) against the
    no-remat step from the same weights on OPTION_SEGMENTS x 6 s, at
    phase_remat's limits (loss 1e-3 rel., gradient cosine 0.999), with
    the launches (the recompute runs B1-train again: 132 + 66) and the
    peak memory of each."""
    mix, targets = train_batch(torch, np)
    mix = mix[:OPTION_SEGMENTS]
    targets = {k: v[:OPTION_SEGMENTS] for k, v in targets.items()}
    res, grads = {}, {}
    for policy in (None, "dots"):
        state, step = make_trainer(torch, "pallas", remat=policy is not None)[:2]
        if policy:
            state.model.remat_policy = policy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, mix, targets)
        torch.cuda.synchronize()
        counts = read_counts()
        grads[policy] = _grad_vector(torch, state.model)
        want = {k: step_launches(remat=policy is not None).get(k, 0) for k in counts}
        res[str(policy)] = {"total_loss": float(loss["total_loss"]), "launches": counts,
                            "step_s": time.perf_counter() - t0,
                            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if counts != want:
            fail(f"remat policy {policy}: expected launches {want}, got {counts}")
        del state, step
        torch.cuda.empty_cache()
    a, b = grads["dots"], grads[None]
    cos = float((a @ b) / (a.norm() * b.norm()))
    ref_loss = res["None"]["total_loss"]
    rel = abs(res["dots"]["total_loss"] - ref_loss) / abs(ref_loss)
    res.update(loss_rel=rel, grad_cosine=cos)
    log(f"f32 (f) remat policy \"dots\" vs no remat on {OPTION_SEGMENTS} x {TRAIN_SECONDS} s: "
        f"loss rel {rel:.2e} (limit 1e-3), gradient cosine {cos:.6f} (min 0.999); launches "
        f"{res['dots']['launches']}; peak {res['dots']['peak_mem_gb']:.3f} GB vs "
        f"{res['None']['peak_mem_gb']:.3f} GB on {gpu}")
    if not (rel <= 1e-3 and cos >= 0.999):
        fail(f"remat policy dots vs no remat: loss rel {rel}, cosine {cos}")
    return res


def phase_f32(torch, np, gpu: str, skip=()):
    """Phase 15: the f32 kernels (a), the f32 serving (b) and training (c)
    main paths, the kernel routes' exports (d), param_dtype="bfloat16" (e)
    and a remat save policy (f) (those named in ``skip`` run elsewhere:
    beside_quality)."""
    res, seconds = {}, {}
    for name, fn in (("serving", f32_serving), ("train", f32_train), ("export", f32_export),
                     ("param_bf16", f32_param_bf16), ("remat_policy", f32_remat_policy)):
        if name in skip:
            continue
        t0 = time.perf_counter()
        res[name] = fn(torch, np, gpu)
        seconds[name] = time.perf_counter() - t0
        log(f"phase 15 {name}: {seconds[name]:.1f} s")
    res["seconds"] = seconds
    return res


# Phase 16 (widths): wide384's ModelConfig fields and its runs' sizes; the
# lab's forms it checks (the full form and the 5 cuts; the flag forms are
# phase 2a's, at the flagship's widths)
WIDE_MODEL = {k: WIDE384[k] for k in ("dims", "num_heads")}
LAB_CUTS = ("qkv", "scores", "exp2", "av", "attn", "full")
# (b): the 120 s track's timed separations after the warm-up, as phase 4's
WIDE_SERVING_RUNS = SERVING_RUNS
WIDE_TRAIN_SEGMENTS = 2          # (d): 2 x 6 s
WIDE_ATTN_SEGMENTS = 1           # (d): the "pallas_attn" step
# the kernels phase 16 adds, as their instantiations appear in ptxas's
# report and the SASS: the wide-head and any-width attention, and the
# product launches at C = 384 and 512 (the f32 forms' new kernels too)
NEW_KERNEL_MARKS = ("attn_wide_kernel", "attn_bwd_q_wide_kernel", "attn_bwd_kv_wide_kernel",
                    "bilinear_attn_any_kernel", "ILi384E", "ILi512E", "ILi16ELi512E",
                    "ILi16ELi256E")


def _ratio(err, tol) -> float:
    return err / tol if tol else (0.0 if err == 0 else math.inf)


def check_ratio(c) -> float:
    """The largest error over its limit in one regime's result of any of
    the check functions (check_shape, check_int8_shape, check_train_shape,
    check_attn_shape, check_lab_shape, _f32_block_checks)."""
    if "checks" in c:
        return max(_ratio(e["err"], e["tol"]) for e in c["checks"]
                   if "recorded" not in e["name"])
    if "forms" in c:
        return max(_ratio(f["err"], f["tol"]) for f in c["forms"].values())
    pairs = [(c[k], c[k[:-4] + "_tol"]) for k in c
             if k.endswith("_err") and k[:-4] + "_tol" in c and not isinstance(c[k], list)]
    for a, b in (("max_abs_err", "tol"), ("attn_max_abs_err", "attn_tol"), ("dp_rel", "dp_tol"),
                 ("den_rel", "den_tol")):
        if a in c and b in c:
            pairs.append((c[a], c[b]))
    pairs += list(zip(c.get("dqkv_err", ()), c.get("dqkv_tol", ())))
    if c.get("int8_mismatches"):
        pairs.append((c["int8_mismatches"], 0))
    return max(_ratio(a, b) for a, b in pairs)


def kind_err(kind: str, res) -> float:
    """The largest output error of ``kind`` ("B1", "B2", "B1 f32", ...) in a
    check function's per-regime results: the block output's (B2: dx's; L:
    any form's; the f32 forms: their named outputs, counts and recorded
    lines left out)."""
    first = next(iter(res.values()))
    if "checks" in first:
        base = kind[:-len(" f32")]
        return max((x["err"] for c in res.values() for x in c["checks"]
                    if x["name"].split()[0] == base and not any(
                        w in x["name"] for w in ("recorded", "mismatch", "twice", "(rel)"))),
                   default=0.0)
    if "forms" in first:
        return max(f["max_abs_err"] for c in res.values() for f in c["forms"].values())
    return max(c.get("bwd_max_abs_err" if kind == "B2" else "max_abs_err", 0.0)
               for c in res.values())


def kernel_name(fn: str) -> str:
    """The template's name in a mangled kernel name (its length-prefixed
    identifier followed by template arguments)."""
    for m in re.finditer(r"(?=(\d+))", fn):     # every digit run and each of its tails
        end = m.start() + len(m.group(1))
        name = fn[end:end + int(m.group(1))]
        if name.endswith("_kernel") and fn[end + len(name):end + len(name) + 1] == "I":
            return name
    return fn[:60]


def wide_ptxas():
    """Registers and spill bytes of every new instantiation
    (NEW_KERNEL_MARKS), from ptxas's report of the build."""
    from tfswa_tpu_torch.ops import _build

    rows = []
    for lib, report in _build.ptxas_report.items():
        fn, spill = None, (0, 0)
        for line in report.splitlines():
            if "Compiling entry function" in line:
                fn, spill = (line.split("'")[1] if "'" in line else None), (0, 0)
            elif fn and "Used" in line and any(m in fn for m in NEW_KERNEL_MARKS):
                regs = int(line.split("Used ")[1].split()[0])
                rows.append({"lib": lib, "function": fn, "registers": regs,
                             "spill_stores": spill[0], "spill_loads": spill[1]})
            elif fn and "spill stores" in line:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                spill = (nums[1], nums[2]) if len(nums) >= 3 else (0, 0)
    return rows


def wide_kernel_checks(torch):
    """Phase 16 (a): every kernel against its plain version, on CHECK_ROWS
    rows under flat, peaked and clamp weights (f32: flat and clamp), at
    PR 13's limits: B1, B3, B4, L (its full form and 5 cuts) and the f32
    forms of B1, B3, B4 at the 12 (N, C) of wide384's serving path; B1-train
    and B2 and their f32 forms at the 12 of its training path; then all but
    L at every (C, H) of EDGE_GRID at N = 64 (an MLP of 2 C units) and N =
    129 (4 C + 8).  Every check is held and logged before any miss fails
    the run; a launch that raises is a miss.  Returns the log rows and the
    largest error of each kernel."""
    gen = torch.Generator().manual_seed(16)
    H = WIDE384["num_heads"]
    rows, misses = [], []
    err = {}

    def held(kinds, label, fn):
        t0 = time.perf_counter()
        try:
            res = fn()[0]
        except Exception as exc:     # a failed launch is held as a miss, with the others
            log(f"phase 16 (a) {label}: {exc!r} MISS")
            misses.append(f"{label}: {exc!r}")
            return
        worst = max(check_ratio(c) for c in res.values())
        bad = [r for r, c in res.items() if not c["ok"]]
        for kind in kinds:
            err[kind] = max(err.get(kind, 0.0), kind_err(kind, res))
        log(f"phase 16 (a) {label}: worst error / limit {worst:.3f}, "
            f"{time.perf_counter() - t0:.1f} s " + ("ok" if not bad else f"MISS {bad}"))
        rows.append({"label": label, "worst": worst, "ok": not bad})
        if bad:
            misses.append(f"{label} {bad}")

    serving = sorted({(N, C) for _, _, N, C, _ in WIDE_SHAPES}, key=lambda t: (t[1], -t[0]))
    training = sorted({(N, C) for _, _, N, C, _ in WIDE_TRAIN_SHAPES}, key=lambda t: (t[1], -t[0]))
    for N, C in serving:
        at = f"N={N} C={C} H={H}"
        held(("B1",), f"B1 {at}", lambda: check_shape(torch, N, C, gen, H=H))
        held(("B3",), f"B3 {at}", lambda: check_int8_shape(torch, N, C, gen, H=H))
        held(("B4",), f"B4 {at}", lambda: check_attn_shape(torch, N, C, gen, H=H))
        held(("L",), f"L {at}", lambda: check_lab_shape(torch, N, C, gen, True, H=H,
                                                          only=LAB_CUTS))
        held(("B1 f32", "B3 f32", "B4 f32"), f"f32 B1 B3 B4 {at}",
             lambda: _f32_block_checks(torch, N, C, gen, False, H=H))
    for N, C in training:
        at = f"N={N} C={C} H={H}"
        held(("B1-train", "B2"), f"B1-train B2 {at}",
             lambda: check_train_shape(torch, N, C, gen, H=H))
        held(("B1-train f32", "B2 f32"), f"f32 B1-train B2 {at}",
             lambda: _f32_block_checks(torch, N, C, gen, True, H=H))
    for C, h in EDGE_GRID:
        for N, hid in zip(EDGE_N, (2 * C, 4 * C + 8)):
            at = f"N={N} C={C} H={h} MLP {hid}"
            held(("B1",), f"B1 {at}", lambda: check_shape(torch, N, C, gen, hid, H=h))
            held(("B3",), f"B3 {at}", lambda: check_int8_shape(torch, N, C, gen, hid, H=h))
            held(("B1-train", "B2"), f"B1-train B2 {at}",
                 lambda: check_train_shape(torch, N, C, gen, hid, H=h))
            held(("B4",), f"B4 N={N} C={C} H={h}", lambda: check_attn_shape(torch, N, C, gen, H=h))
            held(("B1 f32", "B3 f32", "B4 f32"), f"f32 B1 B3 B4 {at}",
                 lambda: _f32_block_checks(torch, N, C, gen, False, H=h, hidden=hid))
            held(("B1-train f32", "B2 f32"), f"f32 B1-train B2 {at}",
                 lambda: _f32_block_checks(torch, N, C, gen, True, H=h, hidden=hid))
            torch.cuda.empty_cache()
    if misses:
        fail(f"phase 16 (a): {len(misses)} checks missed: " + "; ".join(misses))
    log(f"phase 16 (a): {len(rows)} checks held")
    return rows, err


def wide_shape_times(torch, train: bool, R: int, N: int, C: int, p, gen, H: int):
    """Phase 16 (e) at one of wide384's shapes: {kind: kernel / plain /
    library ms and bound} of one call of each kernel (bf16 and f32) at the
    full row count R.  The kernel over one call after a warm-up; the plain
    version on PLAIN_ROWS rows (f32:
    F32_TIMING_ROWS), scaled by R, after a warm-up; the library yardsticks
    over one call after a warm-up, each timed once and shared by the kernels
    that compute its function (B1 and L: the SDPA block; B2: the SDPA
    block's forward + backward less its forward)."""
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops import row_attention as ra
    out = {}
    for dt, sfx, rows in ((torch.bfloat16, "", PLAIN_ROWS),
                          (torch.float32, " f32", F32_TIMING_ROWS)):
        rs = min(R, rows)
        x = card_randn(torch, (R, N, C), gen).to(dt)
        pf = p               # the wrappers and yardsticks cast it to the rows' dtype
        lib_fwd = cuda_ms(torch, lambda: library_block(torch, x, pf, H), 1)
        f32 = dt == torch.float32

        def kernel_ms(fn):
            return cuda_ms(torch, fn, 1)

        def bound(kind, **kw):
            if f32:
                return bound_f32_ms(kind, R, N, C, 4 * C, H=H)
            if kind == "B4":
                return bound_attn_ms(R, N, C, H)
            if kind == "B2":
                return bound_bwd_ms(R, N, C, 4 * C, H)
            return bound_ms(R, N, C, 4 * C, H=H, **kw)

        def rec(kind, k_ms, pl_ms, lib, b):
            out[kind + sfx] = {"ms": k_ms, "plain_ms": pl_ms * R / rs, "library_ms": lib,
                               "bound_ms": b[0], "bound_by": b[1]}

        if not train:
            forms = [("B1", fb.fused_row_block, fb.fused_row_block_reference, lib_fwd, {}),
                     ("B3", fb.fused_row_block_int8, fb.fused_row_block_int8_reference, None,
                      {"int8": True})]
            for kind, run, plain, lib, kw in forms:
                rec(kind, kernel_ms(lambda: run(x, pf, H)),
                    cuda_ms(torch, lambda: plain(x[:rs], pf, H), 1), lib, bound(kind, **kw))
            xn = ln1_rows(torch, x, pf)
            w = [t.to(dt) for t in (pf.qkv_kernel, pf.proj_kernel, pf.proj_bias)]
            run4 = lambda: ra.flash_row_attention(xn, *w, H)  # noqa: E731
            rec("B4", kernel_ms(run4),
                cuda_ms(torch, lambda: ra.flash_row_attention_reference(xn[:rs], *w, H), 1),
                cuda_ms(torch, lambda: library_attn(torch, xn, *w, H), 1), bound("B4"))
            del xn
        else:
            g = card_randn(torch, (R, N, C), gen).to(dt)
            _, mid, acc, den = fb.fused_row_block_train(x, pf, H)
            rec("B1-train", kernel_ms(lambda: fb.fused_row_block_train(x, pf, H)),
                cuda_ms(torch, lambda: fb.fused_row_block_train_reference(x[:rs], pf, H), 1),
                lib_fwd, bound("B1-train", train=True))
            lib_bwd = max(cuda_ms(torch, lambda: library_fwd_bwd(torch, x, pf, H, g), 1)
                          - lib_fwd, 0.0)
            rec("B2", kernel_ms(lambda: fb.fused_row_block_bwd(x, mid, acc, den, g, pf, H)),
                cuda_ms(torch, lambda: fb.fused_row_block_bwd_reference(
                    x[:rs], mid[:rs], acc[:rs], den[:rs], g[:rs], pf, H), 1), lib_bwd,
                bound("B2"))
            del g, mid, acc, den
        del x
        torch.cuda.empty_cache()
    return out


def wide_times(torch):
    """Phase 16 (e): each kernel at wide384's full row counts
    (wide_shape_times), summed a model forward (66 calls at WIDE_SHAPES: B1,
    B3, B4 and the f32 B1, B3, B4) or a train step (66 calls
    at WIDE_TRAIN_SHAPES: B1-train, B2 and their f32 forms)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams

    H = WIDE384["num_heads"]
    gen = torch.Generator().manual_seed(17)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms")
    tot = {}
    for train, table in ((False, WIDE_SHAPES), (True, WIDE_TRAIN_SHAPES)):
        for stage, attn, N, C, R in table:
            calls = BLOCKS_PER_STAGE[stage]
            p = random_params(torch, RowBlockParams, C, gen)
            for kind, t in wide_shape_times(torch, train, R, N, C, p, gen, H).items():
                acc = tot.setdefault(kind, dict.fromkeys(keys, 0.0))
                for key in keys:
                    v = (t["bound_ms"] if t["bound_by"] == "bytes" else 0.0) \
                        if key == "bound_bytes_ms" else t[key]
                    acc[key] = None if v is None or acc[key] is None else acc[key] + calls * v
    for kind, t in tot.items():
        lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        per = "train step" if kind.startswith(("B1-train", "B2")) else "forward"
        log(f"phase 16 (e) wide384 {kind}, per {per} (66 calls): kernel_ms {t['ms']:.3f} "
            f"plain_ms {t['plain_ms']:.3f} library_ms {lib} bound_ms {t['bound_ms']:.4f}")
    return tot


def wide_serving(torch, np, gpu: str):
    """Phase 16 (b): wide384 in bf16, the 120 s track through each serving
    route (66 launches of the route's kernel a forward, no other kernel;
    best of WIDE_SERVING_RUNS after a warm-up), one profiled separation,
    and one 10 s segment against the plain route at SNR_MIN_DB a stem (B3
    also against B1's route, recorded); the plain route's segment computed
    once, with the same weights."""
    res, seg_out, plain = {}, {}, None
    for impl in ROUTES:
        main, sep = phase_main_path(torch, np, gpu, impl, WIDE_MODEL,
                                    WIDE_SERVING_RUNS.get(impl))
        if impl == "pallas":             # one profiled separation
            main["profile"] = phase_profile(torch, np, sep, impl)
        x = torch.from_numpy(synthetic_track(np, 10.0, sep.sample_rate)[None]).cuda()
        with torch.inference_mode():
            seg_out[impl] = sep._separate_core(x).double().cpu().numpy()
            if plain is None:
                ref = separator_with(torch, sep.model, "xla", **WIDE_MODEL)
                plain = ref._separate_core(x).double().cpu().numpy()
                del ref
        snr = {"xla": _segment_snr(np, seg_out[impl], plain)}
        if impl == "pallas_int8":
            snr["pallas"] = _segment_snr(np, seg_out[impl], seg_out["pallas"])
        log(f"phase 16 (b) route {impl} vs the plain route, one 10 s segment: SNR per stem "
            f"{[round(v, 3) for v in snr['xla']]} dB (min {SNR_MIN_DB} dB)"
            + (f"; vs route pallas {[round(v, 3) for v in snr['pallas']]} dB (recorded)"
               if "pallas" in snr else ""))
        if not np.isfinite(seg_out[impl]).all() or min(snr["xla"]) < SNR_MIN_DB:
            fail(f"phase 16 (b) route {impl} vs the plain route: SNR {snr['xla']} below "
                 f"{SNR_MIN_DB} dB")
        main["route_snr_db"] = snr
        res[impl] = main
        del sep
        torch.cuda.empty_cache()
    return res


def wide_train(torch, np, gpu: str):
    """Phase 16 (d): wide384's train step, no remat, through "pallas" on
    WIDE_TRAIN_SEGMENTS x 6 s of phase 7's batch: bf16 (66 B1-train + 66
    B2 launches, nothing else; against the plain route: loss within 1e-2
    relative, gradient cosine >= 0.99; every row block's gradients finite
    and not all zero; ms a step and peak GB) and f32 (f32_train's limits);
    then one "pallas_attn" bf16 step on WIDE_ATTN_SEGMENTS segment (66 B4
    launches, nothing else)."""
    mix, targets = train_batch(torch, np)
    res, grads = {}, {}
    for impl, n in (("pallas", WIDE_TRAIN_SEGMENTS), ("xla", WIDE_TRAIN_SEGMENTS),
                    ("pallas_attn", WIDE_ATTN_SEGMENTS)):
        m, t = mix[:n], {k: v[:n] for k, v in targets.items()}
        state, step = make_trainer(torch, impl, **WIDE_MODEL)[:2]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state, loss = step(state, m, t)
        torch.cuda.synchronize()
        counts = read_counts()
        rec = {"total_loss": float(loss["total_loss"]), "launches": counts}
        if impl != "pallas_attn":     # the first step's, before the timed one moves the weights
            grads[impl] = _grad_vector(torch, state.model)
        if impl != "xla":
            kernels = ("B1-train", "B2") if impl == "pallas" else ("B4",)
            want = {k: (66 if k in kernels else 0) for k in counts}
            if counts != want:
                fail(f"phase 16 (d) {impl} step: expected launches {want}, got {counts}")
            bad = [nm for nm, g in row_block_grads(state.model)
                   if not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
            t0 = time.perf_counter()
            step(state, m, t)
            torch.cuda.synchronize()
            rec.update(ms_per_step=(time.perf_counter() - t0) * 1e3,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, bad_leaves=bad)
            if bad and impl == "pallas":
                fail(f"phase 16 (d): row-block gradients not finite or all zero: {bad[:5]}")
        res[impl] = rec
        del state, step
        torch.cuda.empty_cache()
    a, b = grads["pallas"], grads["xla"]
    cos = float((a @ b) / (a.norm() * b.norm()))
    rel = abs(res["pallas"]["total_loss"] - res["xla"]["total_loss"]) / \
        abs(res["xla"]["total_loss"])
    res.update(loss_rel=rel, grad_cosine=cos)
    log(f"phase 16 (d) wide384 bf16 step on {WIDE_TRAIN_SEGMENTS} x {TRAIN_SECONDS} s: "
        f"launches {res['pallas']['launches']}, {res['pallas']['ms_per_step']:.3f} ms/step, "
        f"peak {res['pallas']['peak_mem_gb']:.3f} GB on {gpu}; vs the plain route: loss rel "
        f"{rel:.2e} (limit 1e-2), gradient cosine {cos:.6f} (min 0.99); pallas_attn on "
        f"{WIDE_ATTN_SEGMENTS} x {TRAIN_SECONDS} s: {res['pallas_attn']['ms_per_step']:.3f} "
        f"ms/step, launches {res['pallas_attn']['launches']}")
    if not (rel <= 1e-2 and cos >= 0.99):
        fail(f"phase 16 (d): loss rel {rel}, gradient cosine {cos}")
    res["f32"] = f32_train(torch, np, gpu, WIDE_MODEL, "phase 16 (d) wide384 f32")
    return res


def beside_quality(torch, np, gpu: str):
    """What runs beside phase 14's two subprocesses, all of it checks and
    exports, none of it timed against a limit: phase 16 (a) (the kernel
    checks), phase 12 (e) (the plain route's exports) and phase 15 (d) (the
    kernel routes' exports).  Returns {part: (result, seconds)}."""
    out = {}
    try:
        for name, fn in (("widths checks", lambda: wide_kernel_checks(torch)),
                         ("options export", lambda: opt_export(torch, np, gpu)),
                         ("f32 export", lambda: f32_export(torch, np, gpu))):
            t0 = time.perf_counter()
            r = fn()
            out[name] = (r, time.perf_counter() - t0)
            log(f"  beside phase 14, {name}: {out[name][1]:.1f} s")
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(OPT_WORK, ignore_errors=True)
    return out


def phase_widths(torch, np, gpu: str, quick: bool, checks=None):
    """Phase 16: every width on the kernel routes, and wide384 end to end
    ((a) the kernel checks, also under --quick, unless ``checks`` holds
    them (the whole run runs them beside phase 14: beside_quality); (b)
    bf16 serving; (c) f32 serving; (d) the train steps; (e) the kernels'
    times)."""
    res, seconds = {"ptxas": wide_ptxas()}, {}
    by_kernel = {}
    for r in res["ptxas"]:
        by_kernel.setdefault((r["lib"], kernel_name(r["function"])), []).append(r)
    for (lib, name), rs in by_kernel.items():
        log(f"  new instantiations {lib} {name}: {len(rs)}, registers "
            f"{min(r['registers'] for r in rs)}-{max(r['registers'] for r in rs)}, spill "
            f"stores {max(r['spill_stores'] for r in rs)} / loads "
            f"{max(r['spill_loads'] for r in rs)} bytes at most (each in chip_smoke.json)")
    parts = [] if checks is not None else [("checks", wide_kernel_checks, (torch,))]
    if checks is not None:
        res["checks"] = checks
    if not quick:
        parts += [("serving", wide_serving, (torch, np, gpu)),
                  ("f32 serving", f32_serving,
                   (torch, np, gpu, WIDE_MODEL, "phase 16 (c) wide384 f32")),
                  ("train", wide_train, (torch, np, gpu)),
                  ("times", wide_times, (torch,))]
    for name, fn, args in parts:
        t0 = time.perf_counter()
        res[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase 16 {name}: {seconds[name]:.1f} s")
    res["seconds"] = seconds
    return res


# Phase "tools": the nine measuring tools of tfswa_tpu_torch/tools that the
# JAX package's tools/ has, each through its CLI's main in this process at
# the flagship's full width and minimal repeats, their last line read
TOOL_RUNS = [
    ("forward_ablation", ["--batch", "8", "--seconds", "10", "--iters", "1"]),
    ("bench_pipeline", ["--batch", "4", "--iters", "1"]),
    ("bench_train_ablate", ["--iters", "1"]),
    ("bench_train", ["--steps", "2"]),
    ("geom_probe", ["--iters", "1"]),
    ("bench_ola_windows", ["--buckets", "60", "121", "--repeats", "1"]),
    ("bench_device_rate", ["--windows", "2", "--repeats", "1"]),
    ("bench_block", ["--check", "--iters", "2"]),
    ("bench_attention", ["--iters", "2"]),
]


def run_tool_here(name: str, argv):
    """``tfswa_tpu_torch.tools.<name>.main(argv)`` in this process: its last
    line's JSON (its output logged); a non-zero exit fails the run."""
    import contextlib
    import io

    mod = importlib.import_module(f"tfswa_tpu_torch.tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f"  | {line}")
    if rc != 0:
        fail(f"tools.{name} {' '.join(argv)} exited {rc}")
    return json.loads(lines[-1])


def tool_problems(name: str, out, want) -> list:
    """What is wrong with a tool's numbers: a time or rate that is not
    finite and positive, launches a call other than the model's design."""
    bad = []

    def pos(d, keys, where=""):
        for k in keys:
            v = d.get(k)
            if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
                bad.append(f"{where}{k} = {v}")

    def launches(got, exp, where):
        if got != exp:
            bad.append(f"{where} launches {got}, expected {exp}")

    b1, step = want["forward"], want["step_remat"]
    if name == "forward_ablation":
        pos(out, ("full_ms", "identity_ms"))
        launches(out["launches"]["full"], {"B1": b1}, "full arm")
        launches(out["launches"]["identity"], {}, "identity arm")
    elif name == "bench_pipeline":
        pos(out, ("stft_ms", "forward_ms", "mask_istft_ms", "d2h_ms", "audio_s_per_s"))
        launches(out["launches"], {"B1": b1}, "a forward")
    elif name == "bench_train_ablate":
        pos(out, [f"{k}_ms" for k in ("pre", "fwd", "fwdbwd", "opt", "full")])
        for arm, exp in (("pre", {}), ("fwd", {"B1": b1}), ("fwdbwd", step), ("opt", {}),
                         ("full", step)):
            launches(out["launches"][arm], exp, arm)
    elif name == "bench_train":
        pos(out, ("step_time_ms", "steps_per_sec", "audio_sec_per_sec", "mfu"))
        launches(out["launches"], step, "a step")
    elif name == "geom_probe":
        for g in out["geometries"]:
            pos(g, ("total_ms", "ms_per_audio_s"), g["geometry"] + " ")
            for r in g["shapes"]:
                pos(r, ("ms",), f"{g['geometry']} {r['shape']} ")
        launches(out["launches"], {"B1": 1}, "a timed call")
    elif name == "bench_ola_windows":
        for r in out["sweep"]:
            pos(r, ("audio_s_per_s",), f"bucket {r['bucket_s']} ")
            got = r["launches"]
            if set(got) != {"B1"} or got["B1"] % b1:
                bad.append(f"bucket {r['bucket_s']}: launches {got}, not whole forwards of B1")
    elif name == "bench_device_rate":
        pos(out, ("device_only_audio_s_per_s", "wall_audio_s_per_s"))
        launches(out["launches_per_window"], {"B1": b1}, "a window")
    elif name in ("bench_block", "bench_attention"):
        routes = ({"fused": {"B1": 1}, "pallas_attn": {"B4": 1}, "xla": {}}
                  if name == "bench_block" else {"pallas": {"B4": 1}, "xla": {}})
        for r in out["shapes"]:
            pos(r, [f"{k}_ms" for k in routes], r["shape"] + " ")
            if name == "bench_block" and not math.isfinite(r["max_abs_err"]):
                bad.append(f"{r['shape']} max_abs_err {r['max_abs_err']}")
            for k, exp in routes.items():
                launches(r["launches"][k], exp, f"{r['shape']} {k}")
    return bad


def phase_tools(torch, np, gpu: str):
    """The nine tools of TOOL_RUNS: each exits 0, prints finite positive
    times and rates, and launches the kernels the model's design gives (66
    B1 a forward and none in forward_ablation's identity arm; 132 B1-train +
    66 B2 a step with remat, bench_train's and bench_train_ablate's default;
    one B1 or B4 a timed call of bench_block, bench_attention, geom_probe).
    Every tool is run and logged before a problem fails the run."""
    want = {"forward": forward_launches(), "step_remat": step_launches(remat=True)}
    out, problems, seconds = {}, [], {}
    for name, argv in TOOL_RUNS:
        t0 = time.perf_counter()
        res = run_tool_here(name, argv)
        seconds[name] = time.perf_counter() - t0
        bad = tool_problems(name, res, want)
        log(f"tools.{name} {' '.join(argv)}: {seconds[name]:.1f} s, "
            + ("ok" if not bad else f"MISS {bad}"))
        out[name] = {"argv": argv, "result": res, "seconds": seconds[name]}
        problems += [f"{name}: {b}" for b in bad]
        torch.cuda.empty_cache()
    if problems:
        fail("phase tools: " + "; ".join(problems))
    return out


# Phase "bench": python -m tfswa_tpu_torch.bench at its defaults, in this
# process; its value within BENCH_VS_PHASE4 of phase 4's "pallas" rate
BENCH_VS_PHASE4 = 0.10
BENCH_SEPARATION_LAUNCHES = {"B1": 132}


def bench_problems(res, gpu: str, pallas_rate: float) -> list:
    """What is wrong with the bench's JSON line: a rate or time that is not
    finite and positive, a health tag other than bench.py's, launches a
    separation other than 132 B1 (and no other kernel), another card, or a
    value more than BENCH_VS_PHASE4 from phase 4's "pallas" rate."""
    bad = []
    for k in ("value", "vs_baseline", "stream_value", "device_only_value"):
        v = res.get(k)
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            bad.append(f"{k} = {v}")
    runs = res.get("runs_s") or []
    if len(runs) != 5 or not all(math.isfinite(r) and r > 0 for r in runs):
        bad.append(f"runs_s = {runs}")
    for k in ("stream_health", "device_only_health"):
        if res.get(k) not in ("ok", "degraded_sample"):
            bad.append(f"{k} = {res.get(k)}")
    if res.get("launches_per_separation") != BENCH_SEPARATION_LAUNCHES:
        bad.append(f"launches a separation {res.get('launches_per_separation')}, expected "
                   f"{BENCH_SEPARATION_LAUNCHES}")
    if res.get("card") != gpu:
        bad.append(f"card {res.get('card')!r}, expected {gpu!r}")
    value = res.get("value")
    if isinstance(value, (int, float)) and abs(value / pallas_rate - 1) > BENCH_VS_PHASE4:
        bad.append(f"value {value} more than {BENCH_VS_PHASE4:.0%} from phase 4's "
                   f"{pallas_rate}")
    return bad


def phase_bench(torch, gpu: str, pallas_rate: float):
    """python -m tfswa_tpu_torch.bench through its main in this process: exit
    0, its JSON line (the last) read and held by bench_problems."""
    import contextlib
    import io

    from tfswa_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    if rc != 0:
        fail(f"tfswa_tpu_torch.bench exited {rc}")
    try:
        res = json.loads(lines[-1])
    except (IndexError, ValueError):
        fail("tfswa_tpu_torch.bench printed no JSON line")
    bad = bench_problems(res, gpu, pallas_rate)
    log(f"bench: value {res.get('value')} audio-s/s (phase 4 \"pallas\": {pallas_rate}), "
        f"stream {res.get('stream_value')} ({res.get('stream_health')}), device-only "
        f"{res.get('device_only_value')} ({res.get('device_only_health')}) "
        + ("ok" if not bad else f"MISS {bad}"))
    if bad:
        fail("phase bench: " + "; ".join(bad))
    torch.cuda.empty_cache()
    return res


def ab_main(torch, np, label: str) -> None:
    """--ab CHECKOUT LABEL: the port that sys.path finds first (CHECKOUT's),
    timed by this script's harness at the flagship's widths, for an A/B of
    two commits on one card: one process a checkout, so that each imports
    its own package, and in one call parent, change, change, parent.  Each
    kernel through its public wrapper, its 66 calls at SHAPES (B1, B3, B4
    and the f32 B1, B3, B4 a model forward; B4's f32 form one call a shape)
    or at TRAIN_SHAPES (B1-train, B2 and their f32 forms a train step); the
    120 s track's separation rate through "pallas" (best of 3 after a
    warm-up); and the bf16 train step through "pallas" on phase 7's batch
    (best of 3 after a warm-up).  Prints one JSON line."""
    from tfswa_tpu_torch.models.attention import RowBlockParams
    from tfswa_tpu_torch.ops import _build
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops.row_attention import flash_row_attention

    _build.build(["fused_block", "fused_block_bwd", "row_attention", *F32_LIBS])
    gen = torch.Generator().manual_seed(1)
    kinds = ("B1", "B3", "B4", "B1-train", "B2", "B1 f32", "B3 f32", "B4 f32", "B1-train f32",
             "B2 f32")
    res = {"label": label, "device": gpu_line(), **dict.fromkeys(kinds, 0.0)}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, " f32")):
        for stage, _, N, C, R in SHAPES:
            p = random_params(torch, RowBlockParams, C, gen)
            x = card_randn(torch, (R, N, C), gen).to(dt)
            w = [t.to(dt) for t in (p.qkv_kernel, p.proj_kernel, p.proj_bias)]
            calls = BLOCKS_PER_STAGE[stage]
            res["B1" + sfx] += calls * cuda_ms(torch, lambda: fb.fused_row_block(x, p, HEADS), 3)
            res["B3" + sfx] += calls * cuda_ms(
                torch, lambda: fb.fused_row_block_int8(x, p, HEADS), 3)
            res["B4" + sfx] += calls * cuda_ms(
                torch, lambda: flash_row_attention(x, *w, HEADS), 1 if sfx else 3)
            del x
            torch.cuda.empty_cache()
        for stage, _, N, C, R in TRAIN_SHAPES:
            p = random_params(torch, RowBlockParams, C, gen)
            x = card_randn(torch, (R, N, C), gen).to(dt)
            g = card_randn(torch, (R, N, C), gen).to(dt)
            calls = BLOCKS_PER_STAGE[stage]
            _, mid, acc, den = fb.fused_row_block_train(x, p, HEADS)
            res["B1-train" + sfx] += calls * cuda_ms(
                torch, lambda: fb.fused_row_block_train(x, p, HEADS), 3)
            res["B2" + sfx] += calls * cuda_ms(
                torch, lambda: fb.fused_row_block_bwd(x, mid, acc, den, g, p, HEADS), 3)
            del x, g, mid, acc, den
            torch.cuda.empty_cache()
    sep = make_separator(torch, "pallas")
    audio = synthetic_track(np, 120.0, sep.sample_rate)
    sep.separate(audio)
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        sep.separate(audio)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    del sep
    mix, targets = train_batch(torch, np)
    state, step = make_trainer(torch, "pallas")[:2]
    state, _ = step(state, mix, targets)
    torch.cuda.synchronize()
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = step(state, mix, targets)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    res.update(audio_s_per_s=120.0 / min(runs), runs_s=runs, step_ms=min(steps),
               steps_ms=steps)
    print(json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and kernel checks only")
    ap.add_argument("--plant", choices=sorted(PLANTS) + sorted(F32_PLANTS) + sorted(DP_PLANTS)
                    + sorted(LAB_F32_PLANTS) + sorted(NF_PLANTS),
                    help="plant a fault in a copy of B2's source and run only the "
                         "B1-train / B2 checks, in a copy of B4's f32 source and run "
                         "only phase 15 (a)'s checks, in the f32 lab's source and run "
                         "only its score_bf16 checks, in B1's source (fminf_clamp) and "
                         "run only phase 3b, or one of DP_PLANTS in phase 13 (b)'s "
                         "ranks and run only its run: exit 0 if they catch it, 1 if not")
    ap.add_argument("--ab", nargs=2, metavar=("CHECKOUT", "LABEL"),
                    help="time CHECKOUT's kernels at the flagship's widths (bf16 and "
                         "f32, a forward or a step), the 120 s rate and the train step, "
                         "and print them as one JSON line: one process a checkout, for "
                         "an A/B of two commits in one call")
    ap.add_argument("--witness", action="store_true",
                    help="run phase 13 (b)'s witness (WITNESS_RUN) alone and write its "
                         "cosines to chiprun_out/chip_smoke_witness.json")
    # one rank of phase 13 (b), which the phase spawns
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--store", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tags", type=str, default=None, help=argparse.SUPPRESS)
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
    if args.ab:
        sys.path.insert(0, os.path.abspath(args.ab[0]))
        ab_main(torch, np, args.ab[1])
        return
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store, args.out, args.tags.split(";"),
                  args.plant)
        return

    gpu = gpu_line()
    log(gpu)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from tfswa_tpu_torch.ops import _build

    global MUFU_RATE
    MUFU_RATE = mufu_rate(torch)
    log(f"exp2 (MUFU) rate {MUFU_RATE:.4e} /s")
    t0 = time.perf_counter()
    _build.build(["fused_block", "fused_block_bwd", "row_attention", *F32_LIBS])
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
    f32_sass = sass_f32_check()

    if args.witness:
        os.makedirs(PARALLEL_WORK, exist_ok=True)
        try:
            out = par_two_ranks(torch, np, gpu, (WITNESS_RUN[0],))[WITNESS_RUN[0]]
        finally:
            shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
        rec = {"written_by": "python3 chip_smoke.py --witness", "device": gpu,
               "torch": f"{torch.__version__} cuda {torch.version.cuda}",
               "run": list(WITNESS_RUN[:6]),
               **{k: out[k] for k in ("loss_rel", "update_cosine_min", "worst_leaf",
                                      "update_cosine_min_over_1e3", "zero_leaves_max",
                                      "leaves_short", "cosines")}}
        path = os.path.join(HERE, "chiprun_out", "chip_smoke_witness.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(rec, fh, indent=0)
        log(f"witness {WITNESS_RUN[0]!r} written to {path}")
        sys.exit(0)
    if args.plant in DP_PLANTS:
        os.makedirs(PARALLEL_WORK, exist_ok=True)
        try:
            res = par_two_ranks(torch, np, gpu, (DP_PLANTS[args.plant],), args.plant)
        finally:
            shutil.rmtree(PARALLEL_WORK, ignore_errors=True)
        if not res["bad"]:
            fail(f"planted fault {args.plant}: phase 13 (b) passed it")
        log(f"planted fault {args.plant}: caught by phase 13 (b): {res['bad']}")
        sys.exit(0)
    if args.plant in LAB_F32_PLANTS:
        plant_lab_f32(torch)
        sys.exit(0)
    if args.plant in NF_PLANTS:
        plant_nonfinite(torch)
        sys.exit(0)
    if args.plant in F32_PLANTS:
        # phase 15 (a) must catch an f32 fault: B4's at every serving shape's
        # clamp weights (scores in the hundreds); the tile's wherever it can
        plant_fault(torch, args.plant)
        misses = []
        try:
            f32_kernels(torch, True, misses)
        except SystemExit:
            pass
        if args.plant == "b4_tf32_scores":
            want = [f"serving stage {s} {a} N={N} C={C} clamp" for s, a, N, C, _ in SHAPES]
        else:
            want = misses[:1] or ["any shape"]
        passed = [c for c in want if c not in misses]
        if passed:
            fail(f"planted fault {args.plant}: phase 15 (a) passed it at {passed}")
        log(f"planted fault {args.plant}: caught by phase 15 (a) at {len(misses)} of "
            f"{2 * (len(SHAPES) + len(TRAIN_SHAPES))} (shape, regime): {misses}")
        sys.exit(0)
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
    lab_f32 = timed("kernel lab f32", phase_lab_f32, torch, args.quick)
    i8_shapes, i8_err, i8_totals = timed("B3 kernels", phase_int8_kernels, torch, args.quick,
                                         shapes)
    at_shapes, at_err, at_totals = timed("B4 kernels", phase_attn_kernels, torch, args.quick)
    nf_checks, nf_misses = timed("non-finite inputs", phase_nonfinite, torch)
    if nf_misses:
        fail("phase 3b: a kernel's output is non-finite elsewhere than its plain version's "
             "at " + "; ".join(nf_misses))
    results = {"gpu": gpu, "build_s": build_s, "ptxas": ptxas, "spills": spills,
               "sass_hmma": hmma, "sass_f32": f32_sass, "mufu_rate": MUFU_RATE,
               "phase_s": phase_s, "shapes": shapes, "totals": totals,
               "int8_shapes": i8_shapes, "int8_totals": i8_totals,
               "attn_shapes": at_shapes, "attn_totals": at_totals, "lab_shapes": lab_shapes,
               "lab_totals": lab_totals, "lab_path": lab_path, "lab_f32": lab_f32,
               "nonfinite": nf_checks}
    serving = {impl: {"launches": None} for impl in ROUTES}
    if not args.quick:
        serving = timed("serving", phase_serving, torch, np, gpu,
                        {"B1": totals, "B3": i8_totals, "B4": at_totals})
        results["serving"] = serving
    t_shapes, t_err, t_totals = timed("B1-train/B2 kernels", phase_train_kernels, torch,
                                      args.quick)
    r_shapes, r_err, covered = timed("recipe kernels", phase_recipe_kernels, torch)
    q_shapes, q_err = timed("quality kernels", phase_quality_kernels, torch, covered)
    f32_shapes, f32_err, f32_totals = timed("f32 kernels", f32_kernels, torch, args.quick)
    for k in ("train", "bwd"):
        t_err[k] = max(t_err[k], r_err[k], q_err[k])
    max_err = max(max_err, r_err["B1"], q_err["B1"])
    results.update(train_shapes=t_shapes, train_totals=t_totals, recipe_shapes=r_shapes,
                   quality_shapes=q_shapes, f32_shapes=f32_shapes, f32_totals=f32_totals)
    train = {"launches": {}}
    if not args.quick:
        train = timed("train pallas", phase_train, torch, np, gpu)
        results["train_path"] = train
        results["train_path_attn"] = timed("train pallas_attn", phase_train, torch, np, gpu,
                                           "pallas_attn")
        results["train_routes"] = timed("train routes", phase_train_routes, torch, np)
        results["remat"] = timed("remat", phase_remat, torch, np, gpu)
        results["options"] = timed("options and deployment", phase_options, torch, np, gpu,
                                   ("export",))
        results["parallel"] = timed("parallel", phase_parallel, torch, np, gpu,
                                    train["best_ms_per_step"],
                                    serving["pallas"]["audio_s_per_s"])
        beside = {}

        def beside_phase_14():
            # the training CLI (phase 10, two subprocesses) beside phase 14's
            # subprocesses too: its checkpoint serves phase 11
            with ThreadPoolExecutor(1) as pool:
                t0 = time.perf_counter()
                cli = pool.submit(phase_train_cli, torch, np, gpu, covered)
                beside.update(beside_quality(torch, np, gpu))
                beside["train CLI"] = (cli.result(), time.perf_counter() - t0)

        try:
            results["quality"] = timed("quality", phase_quality, torch, np, gpu, covered,
                                       beside_phase_14)
            results["train_cli"], results["train_cli_s"] = beside["train CLI"]
            log(f"phase train CLI, beside phase 14: {results['train_cli_s']:.1f} s")
            results["train_cli"]["served_launches"] = serve_cli_best(torch, np)
            results["serving_entry"] = timed("serving entry points", phase_serving_entry,
                                             torch, np, gpu, train["best_ms_per_step"])
        finally:
            shutil.rmtree(TRAIN_CK, ignore_errors=True)      # about 1 GB
        results["options"]["export"], results["options"]["seconds"]["export"] = \
            beside["options export"]
        results["f32"] = timed("f32 routes", phase_f32, torch, np, gpu, ("export",))
        results["f32"]["export"], results["f32"]["seconds"]["export"] = beside["f32 export"]
        results["widths_checks_s"] = beside["widths checks"][1]
    if not args.quick:
        results["tools"] = timed("tools", phase_tools, torch, np, gpu)
        results["bench"] = timed("bench", phase_bench, torch, gpu,
                                 serving["pallas"]["audio_s_per_s"])
    results["widths"] = timed("widths", phase_widths, torch, np, gpu, args.quick,
                              None if args.quick else beside["widths checks"][0])
    if not args.quick:
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
    # the f32 forms, their launches from phase 15's main paths
    f32 = results.get("f32", {})
    f32_launches = {} if args.quick else {
        "B1": f32["serving"]["pallas"]["launches"],
        "B1-train": f32["train"]["pallas"]["launches"]["B1-train-f32"],
        "B2": f32["train"]["pallas"]["launches"]["B2-f32"],
        "B3": f32["serving"]["pallas_int8"]["segment_launches"],
        "B4": f32["serving"]["pallas_attn"]["segment_launches"]}
    f32_src = "tfswa_tpu_torch/csrc/fused_block_f32.cu"
    for name, kind, src, replaces in (
            ("fused_row_block_f32", "B1", f32_src, "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_train_f32", "B1-train", f32_src,
             "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_bwd_f32", "B2", "tfswa_tpu_torch/csrc/fused_block_bwd_f32.cu",
             "tfswa_tpu/ops/pallas/fused_block.py:526"),
            ("fused_row_block_int8_f32", "B3", f32_src, "tfswa_tpu/ops/pallas/fused_block.py:253"),
            ("flash_row_attention_f32", "B4", "tfswa_tpu_torch/csrc/row_attention_f32.cu",
             "tfswa_tpu/ops/pallas/row_attention.py:53")):
        kernels.append(entry(name, src, replaces, f32_launches.get(kind), f32_err[kind],
                             f32_totals[kind]))
    # L's f32 forms: the full form's numbers (B1 f32's function through the
    # lab's f32 entry), the launches of the CLI in f32
    kernels.append(entry("kernel_lab_f32", f32_src, "tools/kernel_lab.py:101",
                         lab_f32["path"]["launches"], lab_f32["max_err"],
                         dict(lab_f32["totals"]["full"],
                              library_ms=f32_totals["B1"]["library_ms"] if timed else None)))
    # phase 16: wide384's rows, each kernel's launches from its main path there
    wide = results["widths"]
    wide_err = wide["checks"][1]
    wide_launches = {} if args.quick else {
        "B1": wide["serving"]["pallas"]["launches"],
        "B3": wide["serving"]["pallas_int8"]["launches"],
        "B4": wide["serving"]["pallas_attn"]["launches"],
        "B1-train": wide["train"]["pallas"]["launches"]["B1-train"],
        "B2": wide["train"]["pallas"]["launches"]["B2"],
        "B1 f32": wide["f32 serving"]["pallas"]["launches"],
        "B3 f32": wide["f32 serving"]["pallas_int8"]["segment_launches"],
        "B4 f32": wide["f32 serving"]["pallas_attn"]["segment_launches"],
        "B1-train f32": wide["train"]["f32"]["pallas"]["launches"]["B1-train-f32"],
        "B2 f32": wide["train"]["f32"]["pallas"]["launches"]["B2-f32"]}
    for name, kind, src, replaces in (
            ("fused_row_block", "B1", fwd_src, "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_train", "B1-train", fwd_src,
             "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_bwd", "B2", "tfswa_tpu_torch/csrc/fused_block_bwd.cu",
             "tfswa_tpu/ops/pallas/fused_block.py:526"),
            ("fused_row_block_int8", "B3", fwd_src, "tfswa_tpu/ops/pallas/fused_block.py:253"),
            ("flash_row_attention", "B4", "tfswa_tpu_torch/csrc/row_attention.cu",
             "tfswa_tpu/ops/pallas/row_attention.py:53"),
            ("fused_row_block_f32", "B1 f32", f32_src, "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_train_f32", "B1-train f32", f32_src,
             "tfswa_tpu/ops/pallas/fused_block.py:140"),
            ("fused_row_block_bwd_f32", "B2 f32", "tfswa_tpu_torch/csrc/fused_block_bwd_f32.cu",
             "tfswa_tpu/ops/pallas/fused_block.py:526"),
            ("fused_row_block_int8_f32", "B3 f32", f32_src,
             "tfswa_tpu/ops/pallas/fused_block.py:253"),
            ("flash_row_attention_f32", "B4 f32", "tfswa_tpu_torch/csrc/row_attention_f32.cu",
             "tfswa_tpu/ops/pallas/row_attention.py:53")):
        kernels.append(entry(f"{name} (wide384)", src, replaces, wide_launches.get(kind),
                             wide_err.get(kind), None if args.quick else wide["times"][kind]))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
