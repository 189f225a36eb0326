"""What OLA overlap buys in separation quality (the JAX package's
``tools/overlap_ab.py``).

Separates the synthetic val tracks with a trained checkpoint (the quality
A/B's ``direct`` arm by default) at several overlap ratios and reports the
per-stem SDR against the references, and the waveform delta against the
first overlap's output.  Overlap multiplies serving compute by
1 / (1 - overlap): if SDR is flat in overlap, serving can take the
cheapest setting on evidence.

    python -m tfswa_tpu_torch.tools.overlap_ab --overlaps 0.5 0.25 0.1 [--arm direct] \\
        [--checkpoint_dir runs/torch_quality_ab/direct/ck] [--device_ola] [--device cuda]

Writes ``--out`` (default ``runs/torch_quality_ab/overlap_ab_<arm>[_<freq_policy>]
[_<stft_precision>].json``).  Runs on ``--device`` ("cuda" unless "cpu" is
asked for; with no card it stops with exit code 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import SyntheticDataset
from ..evaluation.inference import SourceSeparator
from ..evaluation.metrics import sdr as sdr_metric
from ..models import TFSWAUNet
from ..ops.stft import STFTProcessor
from ..training.checkpointing import restore_variables
from .quality_ab import OUT


def load_model(ck_dir: str, checkpoint: str = "latest"):
    """(the model with ``ck_dir/checkpoint``'s weights, the Config of
    ``ck_dir/config.json``)."""
    with open(os.path.join(ck_dir, "config.json")) as fh:
        cfg = Config.from_dict(json.load(fh))
    model = TFSWAUNet.from_config(cfg.model)
    state_dict, _ = restore_variables(os.path.join(ck_dir, checkpoint))
    # the reference registers an unused SWA mask buffer
    model.load_state_dict({k: v for k, v in state_dict.items() if "attn_mask" not in k})
    return model, cfg


def overlap_table(model: TFSWAUNet, cfg: Config, overlaps: Sequence[float],
                  segment_length: float = 10.0, freq_policy: str = "full",
                  transfer_dtype: str = "float32", device_ola: bool = False,
                  device="cuda") -> Dict[str, Dict[str, float]]:
    """{str(overlap): {"sdr/<stem>", "sdr/avg"[, "delta_db_vs_first"]}}:
    the mean SDR a stem over the 4 synthetic validation tracks, separated
    at each overlap with the arm's mask convention, and the power of the
    difference from the first overlap's stems, in dB of theirs."""
    proc = STFTProcessor(cfg.stft)
    val = SyntheticDataset(
        num_tracks=4, track_seconds=30.0,
        segment_seconds=cfg.data.segment_seconds,
        sample_rate=cfg.data.sample_rate, stems=cfg.data.stems,
        random_segments=False, seed=999,
    )
    mask_mode = "trainer" if cfg.train.train_mask_mode == "parity" else "mag_direct"
    stems = tuple(cfg.data.stems)

    results, ref_out = {}, None
    for ov in overlaps:
        sep = SourceSeparator(
            model, proc, segment_length=segment_length, overlap=ov, mask_mode=mask_mode,
            stem_names=stems, segment_batch=8, freq_policy=freq_policy,
            transfer_dtype=transfer_dtype, device_ola=device_ola, device=device,
        )
        per_stem = {s: [] for s in stems}
        outs = []
        for i in range(len(val.track_names)):
            mixture, refs = val.get_full_track(i)
            ests = sep.separate(mixture)
            outs.append(ests)
            for s in stems:
                ref = np.asarray(refs[s]).mean(axis=0)
                est = np.asarray(ests[s])[0]
                per_stem[s].append(float(sdr_metric(torch.from_numpy(est),
                                                    torch.from_numpy(ref))))
        entry = {f"sdr/{s}": float(np.mean(per_stem[s])) for s in stems}
        entry["sdr/avg"] = float(np.mean(list(entry.values())))
        if ref_out is None:
            ref_out = outs
        else:
            # waveform delta vs the first overlap's, in dB rel. its power
            num = den = 0.0
            for a, b in zip(outs, ref_out):
                for s in stems:
                    d = a[s][0].astype(np.float64) - b[s][0].astype(np.float64)
                    num += float(np.sum(d * d))
                    den += float(np.sum(b[s][0].astype(np.float64) ** 2))
            entry["delta_db_vs_first"] = float(
                10 * np.log10(max(num, 1e-30) / max(den, 1e-30)))
        results[str(ov)] = entry
        print(f"overlap {ov:4.2f}: " + json.dumps(entry), flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", default="direct")
    ap.add_argument("--checkpoint", default="latest")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="the arm's checkpoint directory (default <quality A/B root>/<arm>/ck)")
    ap.add_argument("--overlaps", type=float, nargs="+", default=[0.5, 0.25, 0.1])
    ap.add_argument("--segment_length", type=float, default=10.0)
    ap.add_argument("--freq_policy", default="full")
    ap.add_argument("--stft_precision", default=None,
                    help="override cfg.stft.precision (kept for the JAX flag: the port's "
                         "STFT runs in float32 whatever it says)")
    ap.add_argument("--transfer_dtype", default="float32")
    ap.add_argument("--device_ola", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("overlap_ab: no CUDA device (--device cpu runs on the CPU)", file=sys.stderr)
        return 2

    ck_dir = args.checkpoint_dir or os.path.join(OUT, args.arm, "ck")
    model, cfg = load_model(ck_dir, args.checkpoint)
    if args.stft_precision:
        cfg.stft.precision = args.stft_precision
    print(f"loaded {args.arm}/{args.checkpoint}")
    results = overlap_table(model, cfg, args.overlaps, args.segment_length, args.freq_policy,
                            args.transfer_dtype, args.device_ola, args.device)

    suffix = "" if args.freq_policy == "full" else f"_{args.freq_policy}"
    if args.stft_precision:
        suffix += f"_{args.stft_precision}"
    out_path = args.out or os.path.join(OUT, f"overlap_ab_{args.arm}{suffix}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=2)
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
