"""Quality A/B of the training recipe's mask conventions (the JAX
package's ``tools/quality_ab.py``): can the stack beat the reference's mask
ceiling?

Three training arms, identical data, steps and seed (the flagship 15.4M in
bf16 with remat through "pallas", the 16-track SyntheticDataset, B = 2 x
2 s, 60 steps an epoch):

  parity   the reference's double-sigmoid trainer mask (masks in [0.5, 0.80])
  direct   train.train_mask_mode=direct: the sigmoid head's channels as
           [0, 1] magnitude masks
  shift    parity masks + model.use_shift_mask=true (the Swin mask on the
           shifted SWA blocks; those blocks run the plain route)

Each arm trains through ``python -m tfswa_tpu_torch.cli.train --synthetic``
in its own process, logging under ``<out>/<arm>/`` (checkpoints in
``<out>/<arm>/ck``); the in-training SDR evaluation uses the convention
the arm trained under.  Then the sdr/avg and validation curves are
summarised into ``<out>/summary.json``.

    python -m tfswa_tpu_torch.tools.quality_ab [--arms parity direct shift] [--epochs 10] \\
        [--out runs/torch_quality_ab] [--device cuda]

The arms train on ``--device`` ("cuda" unless "cpu" is asked for; with no
card the tool stops with exit code 2 before training).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "runs", "torch_quality_ab")

ARM_OVERRIDES = {
    "parity": [],
    "direct": ["train.train_mask_mode=direct"],
    "shift": ["model.use_shift_mask=true"],
}


def arm_command(arm: str, epochs: int, out: str = OUT, device: str = "cuda") -> List[str]:
    """The training CLI's command line for ``arm``; ``--device`` is passed
    only when it is not the CLI's default."""
    log_dir = os.path.join(out, arm)
    ck_dir = os.path.join(out, arm, "ck")
    cmd = [
        sys.executable, "-m", "tfswa_tpu_torch.cli.train", "--synthetic",
        "--batch_size", "2", "--num_epochs", str(epochs),
        "--bf16", "--use_checkpointing",
        "--segment_seconds", "2.0",
        "--checkpoint_dir", ck_dir, "--log_dir", log_dir,
        "--set", "model.attention_impl=pallas",
        "--set", "train.steps_per_epoch=60",
        "--set", "data.num_workers=0",
        "--set", "train.log_every_n_steps=50",
    ]
    for ov in ARM_OVERRIDES[arm]:
        cmd += ["--set", ov]
    if device != "cuda":
        cmd += ["--device", device]
    return cmd


def run_arm(arm: str, epochs: int, out: str = OUT, device: str = "cuda") -> None:
    os.makedirs(os.path.join(out, arm), exist_ok=True)
    cmd = arm_command(arm, epochs, out, device)
    print(f"=== arm {arm}: {' '.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def summarize(arms, out: str = OUT) -> dict:
    """Per arm: its sdr and validation-loss curves from ``metrics.jsonl``,
    the best sdr/avg and the last validation loss (arms without a log are
    left out)."""
    summary = {}
    for arm in arms:
        path = os.path.join(out, arm, "metrics.jsonl")
        if not os.path.exists(path):
            continue
        sdr_points, val_points = [], []
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                if "sdr/avg" in rec:
                    sdr_points.append(
                        {k: rec[k] for k in rec if k.startswith(("sdr", "si_sdr", "step"))}
                    )
                if "val/total_loss" in rec:
                    val_points.append({"step": rec["step"], "val_loss": rec["val/total_loss"]})
        summary[arm] = {
            "sdr_curve": sdr_points,
            "val_curve": val_points,
            "best_sdr_avg": max((p["sdr/avg"] for p in sdr_points), default=None),
            "final_val_loss": val_points[-1]["val_loss"] if val_points else None,
        }
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", nargs="+", default=["parity", "direct", "shift"])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--out", default=OUT, help="output root (one directory an arm)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if not args.summarize_only:
        import torch

        if args.device == "cuda" and not torch.cuda.is_available():
            print("quality_ab: no CUDA device (--device cpu trains on the CPU)",
                  file=sys.stderr)
            return 2
        for arm in args.arms:
            run_arm(arm, args.epochs, args.out, args.device)

    summary = summarize(args.arms, args.out)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    for arm, s in summary.items():
        print(f"{arm:8s} best sdr/avg {s['best_sdr_avg']}  "
              f"final val loss {s['final_val_loss']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
