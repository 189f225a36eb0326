"""Per-rank work and collective traffic of the sharded serving forward and
train step at dp = 1, 2, 4 (counterpart of ``tools/bench_mesh_scaling.py``).

For each dp the tool spawns dp ranks (one process each) on a (dp, 1) mesh
and reads, on rank 0:
  - the serving forward (``SourceSeparator._separate_core`` of the rank's
    ``batch / dp`` segments): its FLOPs and its collectives (none), and
    the separator's batch call, whose one collective gathers the stems;
  - the train step (``make_sharded_train_step``): its FLOPs and its
    collectives (BatchNorm statistics, the gradients, the losses) with
    their bytes;
FLOPs are counted by ``parallel.analysis.analyze`` (``FlopCounterMode``),
which sees PyTorch's products and convolutions but no hand-written
kernel, so the model runs its plain route ("xla").  It asserts that the
forward is collective-free and that each rank's work falls as 1 / dp
(within 5 %; the train step removes at least 90 % of the ideal 1 - 1/dp).
These are counts, not times: on one card they say nothing of scaling.

    python -m tfswa_tpu_torch.tools.bench_mesh_scaling --device cpu --dps 1,2,4
    python -m tfswa_tpu_torch.tools.bench_mesh_scaling --device cuda --dps 1

The flagship model by default (1 s serving segments, 0.5 s train segments,
batch 8); ``--small`` takes the JAX package's test config.  ``--device
cuda`` puts rank r on card r (NCCL), or with ``--backend gloo`` lets ranks
share cards.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)


def _config(args):
    from ..config import Config

    cfg = Config()
    cfg.model.in_channels = cfg.model.out_channels = 4
    cfg.model.attention_impl = "xla"
    if args.small:
        for k, v in SMALL.items():
            setattr(cfg.model, k, v)
        cfg.stft.n_fft, cfg.stft.hop_length = 256, 64
        cfg.stft.sample_rate = cfg.data.sample_rate = 8000
    return cfg


def rank_rows(args, rank: int, world: int, store: str) -> dict:
    """One rank's counts at dp = world (rank 0's are the tool's row)."""
    import numpy as np
    import torch

    from ..evaluation import SourceSeparator
    from ..models import TFSWAUNet
    from ..ops.stft import STFTProcessor
    from ..parallel import analyze, create_mesh, initialize_distributed, shard_batch
    from ..training import create_train_state, make_sharded_train_step

    torch.set_num_threads(1)
    initialize_distributed(f"file://{store}", world, rank, device=args.device,
                           backend=args.backend)
    mesh = create_mesh((world, 1), device=args.device)
    cfg = _config(args)
    proc = STFTProcessor(cfg.stft)
    sr = cfg.stft.sample_rate
    model = TFSWAUNet.from_config(cfg.model, generator=torch.Generator().manual_seed(0))
    sep = SourceSeparator(model, proc, segment_length=args.serve_seconds,
                          segment_batch=args.batch, device=args.device, mesh=mesh)
    rows = torch.zeros(args.batch, sep.segment_samples, device=mesh.device)
    local = shard_batch(rows, mesh)
    with torch.inference_mode():
        flops, coll, _ = analyze(sep._separate_core, local)
        _, gather, _ = analyze(sep._separate_batch, rows)
    serving = {"dp": world, "per_rank_flops": flops, "collective_count": coll.total_count,
               "collective_bytes": coll.total_bytes, "collectives": coll.counts,
               "batch_call_collectives": gather.counts,
               "batch_call_bytes": gather.total_bytes}
    del sep, model

    _, state = create_train_state(cfg, 10, device=args.device, mesh=mesh)
    step = make_sharded_train_step(state.model, proc, cfg.data.stems, mesh)
    rng = np.random.default_rng(0)
    n = int(args.train_seconds * sr)
    mix = torch.from_numpy(rng.standard_normal((args.batch, 2, n)).astype(np.float32))
    targets = {s: torch.from_numpy(rng.standard_normal((args.batch, 2, n)).astype(np.float32))
               for s in cfg.data.stems}
    mix, targets = shard_batch((mix, targets), mesh)
    flops, coll, _ = analyze(step, state, mix, targets)
    train = {"dp": world, "per_rank_flops": flops, "collective_count": coll.total_count,
             "collective_bytes": coll.total_bytes, "collectives": coll.counts,
             "n_params": sum(p.numel() for p in state.model.parameters())}
    return {"serving": serving, "train": train}


def run_dp(args, dp: int, work: str) -> dict:
    """Spawn dp ranks, wait (killing them all at the timeout), return rank
    0's counts."""
    store, out = os.path.join(work, f"store{dp}"), os.path.join(work, f"dp{dp}.json")
    argv = [sys.executable, "-m", "tfswa_tpu_torch.tools.bench_mesh_scaling", "--rank", "0",
            "--world", str(dp), "--store", store, "--out", out] + _forward_flags(args)
    procs = []
    for r in range(dp):
        argv[argv.index("--rank") + 1] = str(r)
        procs.append(subprocess.Popen(list(argv)))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, args.timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise SystemExit(f"dp={dp}: a rank failed or hung: {[p.returncode for p in procs]}")
    with open(out) as fh:
        return json.load(fh)


def _forward_flags(args) -> list:
    flags = ["--device", args.device, "--serve_seconds", str(args.serve_seconds),
             "--train_seconds", str(args.train_seconds), "--batch", str(args.batch)]
    if args.backend:
        flags += ["--backend", args.backend]
    return flags + (["--small"] if args.small else [])


def verdicts(result) -> None:
    """The serving forward is collective-free and each rank's serving work
    is 1 / dp of dp = 1's within 5 %; the train step removes at least 90 %
    of the ideal 1 - 1/dp of it and has its collectives."""
    s0 = result["serving"][0]["per_rank_flops"]
    for row in result["serving"]:
        if row["collective_count"] != 0:
            raise SystemExit(f"serving forward at dp={row['dp']} is not collective-free: "
                             f"{row['collectives']}")
        ratio, want = row["per_rank_flops"] / s0, 1.0 / row["dp"]
        if abs(ratio - want) / want >= 0.05:
            raise SystemExit(f"serving work at dp={row['dp']}: {ratio:.3f} of dp=1's, "
                             f"expected {want:.3f}")
    t0 = result["train"][0]["per_rank_flops"]
    for row in result["train"]:
        removed, ideal = (t0 - row["per_rank_flops"]) / t0, 1.0 - 1.0 / row["dp"]
        if removed < 0.9 * ideal or row["collective_count"] < 1:
            raise SystemExit(f"train step at dp={row['dp']}: {removed:.3f} of the work "
                             f"removed (ideal {ideal:.3f}), collectives {row['collectives']}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default=None, help="nccl or gloo (default: the device's)")
    p.add_argument("--dps", default="1,2,4")
    p.add_argument("--serve_seconds", type=float, default=1.0)
    p.add_argument("--train_seconds", type=float, default=0.5)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--small", action="store_true", help="the small test config")
    p.add_argument("--timeout", type=float, default=1800.0, help="seconds a dp may take")
    p.add_argument("--json", default=None)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        rows = rank_rows(args, args.rank, args.world, args.store)
        if args.rank == 0:
            with open(args.out, "w") as fh:
                json.dump(rows, fh)
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
        return
    if args.device != "cpu":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu for the CPU")
    result = {"serving": [], "train": []}
    with tempfile.TemporaryDirectory() as work:
        for dp in (int(x) for x in args.dps.split(",")):
            rows = run_dp(args, dp, work)
            for kind in ("serving", "train"):
                row = rows[kind]
                result[kind].append(row)
                print(f"[{kind:7s} dp={dp}] per-rank GFLOPs {row['per_rank_flops'] / 1e9:.4f} "
                      f"collectives {row['collectives']} ({row['collective_bytes']} B)"
                      + (f"; the batch call's gather {row['batch_call_collectives']} "
                         f"({row['batch_call_bytes']} B)" if kind == "serving" else ""),
                      flush=True)
    verdicts(result)
    print("VERDICT: the serving forward is collective-free at every dp; each rank's work "
          "falls as 1/dp on both paths.")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=2)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
