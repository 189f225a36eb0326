"""Evaluation CLI (counterpart of ``tfswa_tpu/cli/evaluate.py``).

    python -m tfswa_tpu_torch.cli.evaluate --checkpoint ckpts/ --data_root /data/musdb18hq
    python -m tfswa_tpu_torch.cli.evaluate --checkpoint ckpts/ --synthetic
    python -m tfswa_tpu_torch.cli.evaluate --checkpoint ckpts/ \\
        --mixtures_dir mix/ --references_dir refs/     # a custom dataset

``--checkpoint`` is read as by ``cli.separate``.  The MUSDB18 test split
(``--data_root``), the synthetic set (``--synthetic``, or no root: 4
tracks of 30 s) or a custom dataset is separated and scored; the results
go to ``<output_dir>/results.json``.  museval's metrics are taken when the
package imports and ``--no_museval`` is not given.  The model runs on
``--device``: "cuda" unless "cpu" is asked for; with no CUDA device the
CLI exits non-zero.
"""
from __future__ import annotations

import argparse

from .separate import add_serving_args, check_device, eval_config_from_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate a TFSWA-UNet checkpoint (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="the training CLI's checkpoint directory, an epoch directory "
                        "or a reference .pt file")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--mixtures_dir", type=str, default=None)
    p.add_argument("--references_dir", type=str, default=None)
    p.add_argument("--output_dir", type=str, default="eval_results")
    p.add_argument("--stems", type=str, default="vocals,other")
    p.add_argument("--segment_seconds", type=float, default=10.0)
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--mask_mode", type=str, default="trainer",
                   choices=["trainer", "direct", "mag_direct"])
    p.add_argument("--no_museval", action="store_true")
    p.add_argument("--max_tracks", type=int, default=None)
    p.add_argument("--save_estimates", action="store_true")
    p.add_argument("--n_fft", type=int, default=2048)
    p.add_argument("--hop_length", type=int, default=512)
    add_serving_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_device(args, "cli.evaluate")
    from ..config import STFTConfig
    from ..evaluation import (CustomDatasetEvaluator, MUSDB18Evaluator,
                              load_separator_from_checkpoint)

    stems = tuple(args.stems.split(","))
    separator = load_separator_from_checkpoint(
        args.checkpoint, stft_config=STFTConfig(n_fft=args.n_fft, hop_length=args.hop_length),
        eval_config=eval_config_from_args(args), stem_names=stems, device=args.device)
    if args.mixtures_dir and args.references_dir:
        CustomDatasetEvaluator(separator, args.mixtures_dir, args.references_dir, stems=stems,
                               output_dir=args.output_dir,
                               segment_seconds=args.segment_seconds).evaluate()
        return
    if args.synthetic or not args.data_root:
        from ..data.synthetic import SyntheticDataset

        dataset = SyntheticDataset(num_tracks=4, track_seconds=30.0, stems=stems,
                                   sample_rate=separator.sample_rate)
    else:
        from ..data.musdb import MUSDB18Dataset

        dataset = MUSDB18Dataset(args.data_root, split="test", stems=stems,
                                 sample_rate=separator.sample_rate)
    evaluator = MUSDB18Evaluator(separator, dataset, output_dir=args.output_dir,
                                 use_museval=not args.no_museval,
                                 segment_seconds=args.segment_seconds,
                                 save_estimates=args.save_estimates, max_tracks=args.max_tracks)
    MUSDB18Evaluator.print_summary(evaluator.evaluate())


if __name__ == "__main__":
    main()
