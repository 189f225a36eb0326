"""Offline SDR evaluation of a quality-A/B arm's checkpoints (the JAX
package's ``tools/eval_ab_checkpoint.py``).

Rebuilds the arm's Trainer from its ``ck/config.json`` (the same synthetic
split as ``cli.train --synthetic``), restores each named checkpoint and runs
the in-training SDR evaluation (``Trainer.evaluate_sdr``) on it.

    python -m tfswa_tpu_torch.tools.eval_ab_checkpoint --arm shift \\
        --checkpoints epoch_000001 epoch_000005 [--out offline_sdr.json] \\
        [--root runs/torch_quality_ab] [--device cuda]

Writes ``<root>/<arm>/<out>``: {checkpoint: its metrics and global_step}.
Runs on ``--device`` ("cuda" unless "cpu" is asked for; with no card it
stops with exit code 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

import torch

from ..cli.train import build_datasets
from ..config import Config
from ..training.trainer import Trainer
from .quality_ab import OUT


def evaluate_checkpoints(arm_dir: str, names: Sequence[str], device="cuda") -> Dict[str, Dict]:
    """{name: evaluate_sdr's metrics with "global_step"} for each checkpoint
    of ``arm_dir/ck``, on one trainer built from its config.json; the
    trainer logs under ``arm_dir/offline_eval_logs``."""
    ck_dir = os.path.join(arm_dir, "ck")
    with open(os.path.join(ck_dir, "config.json")) as fh:
        cfg = Config.from_dict(json.load(fh))
    cfg.train.log_dir = os.path.join(arm_dir, "offline_eval_logs")
    results = {}
    with tempfile.TemporaryDirectory() as work:
        # the trainer writes its config.json where it would checkpoint:
        # not into the arm's directory, which it only reads
        cfg.train.checkpoint_dir = work
        trainer = Trainer(cfg, *build_datasets(cfg, synthetic=True), device=device)
        trainer.config.train.checkpoint_dir = ck_dir
        for name in names:
            trainer.load_checkpoint(name)
            metrics = trainer.evaluate_sdr()
            metrics["global_step"] = trainer.global_step
            results[name] = metrics
            print(name, json.dumps(metrics), flush=True)
        trainer.logger.close()
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", required=True)
    ap.add_argument("--checkpoints", nargs="+", default=["latest"])
    ap.add_argument("--out", default=None, help="output JSON path relative to the arm dir")
    ap.add_argument("--root", default=OUT, help="the quality A/B's output root")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("eval_ab_checkpoint: no CUDA device (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2

    arm_dir = os.path.join(args.root, args.arm)
    results = evaluate_checkpoints(arm_dir, args.checkpoints, args.device)
    out_path = os.path.join(arm_dir, args.out or "offline_sdr.json")
    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=2)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
