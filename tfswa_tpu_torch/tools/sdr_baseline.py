"""SDR of a fresh-init or checkpointed model on the synthetic val tracks
(the JAX package's ``tools/sdr_baseline.py``).

Measures ``Trainer.evaluate_sdr`` under the quality A/B's training
configuration (``baseline_config``), so that a trained run's SDR curve has
an "untrained" reference point (and, with a checkpoint, an endpoint).

    python -m tfswa_tpu_torch.tools.sdr_baseline [--checkpoint runs/torch_quality_ab/parity/ck \\
        --which best] [--device cuda]

Runs on ``--device`` ("cuda" unless "cpu" is asked for; with no card it
stops with exit code 2).  Prints one JSON line after the untrained
evaluation and, as its last line, the whole result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import torch

from ..cli.train import build_datasets
from ..config import Config
from ..training.trainer import Trainer


def baseline_config() -> Config:
    """The quality A/B's recipe: the flagship in bf16 with remat through
    "pallas", batches of 2 x 2 s, 60 steps an epoch."""
    cfg = Config()
    cfg.model.dtype = "bfloat16"
    # the JAX tool sets the string "tfswa_block" in this bool field, where
    # it is truthy: JAX remats each TFSWABlock, as True does here
    cfg.model.remat = True
    cfg.model.attention_impl = "pallas"
    cfg.data.batch_size = 2
    cfg.data.segment_seconds = 2.0
    cfg.data.num_workers = 0
    cfg.train.steps_per_epoch = 60
    return cfg


def baseline(cfg: Config, checkpoint: Optional[str] = None, which: str = "best",
             device="cuda") -> Dict[str, Dict[str, float]]:
    """{"untrained": SDR metrics of the model at ``cfg``'s init} and, with
    a ``checkpoint`` directory, ``"<which>@step<global_step>"``: the same
    after restoring ``which`` from it.  The datasets are ``cli.train
    --synthetic``'s.  The trainer's own checkpoints and logs go to a
    temporary directory, so nothing is written into ``checkpoint``."""
    with tempfile.TemporaryDirectory() as work:
        cfg.train.checkpoint_dir = os.path.join(work, "ck")
        cfg.train.log_dir = os.path.join(work, "logs")
        trainer = Trainer(cfg, *build_datasets(cfg, synthetic=True), device=device)
        out = {"untrained": trainer.evaluate_sdr()}
        print(json.dumps(out), flush=True)
        if checkpoint:
            # same trainer: only the weights change
            trainer.config.train.checkpoint_dir = checkpoint
            trainer.load_checkpoint(which)
            out[f"{which}@step{trainer.global_step}"] = trainer.evaluate_sdr()
        trainer.logger.close()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint dir; omit for the untrained baseline")
    ap.add_argument("--which", default="best")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("sdr_baseline: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 2
    out = baseline(baseline_config(), args.checkpoint, args.which, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
