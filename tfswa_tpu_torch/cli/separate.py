"""Separation CLI (counterpart of ``tfswa_tpu/cli/separate.py``): WAV
files in, one PCM16 WAV a stem out.

    python -m tfswa_tpu_torch.cli.separate --checkpoint ckpts/ song.wav -o out/
    python -m tfswa_tpu_torch.cli.separate --checkpoint ckpts/ --preset fast --stream *.wav

``--checkpoint`` takes the directory the training CLI wrote (its ``best/``,
else ``latest/``, with the ModelConfig of its ``config.json``), an epoch
directory, or a reference ``.pt`` file.  ``--preset fast`` is
``EvalConfig.fast_serving()`` (device overlap-add, float16 transfers,
Nyquist-row crop); the flags after it override it.  ``--stream`` sends
several files through ``separate_stream``, with the same results as one
at a time.  Inputs at another rate are resampled to the STFT's.  The model
runs on ``--device``: "cuda" unless "cpu" is asked for; with no CUDA
device the CLI exits non-zero.
"""
from __future__ import annotations

import argparse


def add_serving_args(p: argparse.ArgumentParser) -> None:
    """The serving flags the separate and evaluate CLIs share."""
    p.add_argument("--preset", type=str, default="parity", choices=["parity", "fast"],
                   help="'fast' = EvalConfig.fast_serving(); the flags below override it")
    p.add_argument("--segment_batch", type=int, default=None)
    p.add_argument("--transfer_dtype", type=str, default=None,
                   choices=["float32", "float16", "int16", "int8"])
    p.add_argument("--device_ola", action="store_true", default=None)
    p.add_argument("--ola_bucket_seconds", type=float, default=None)
    p.add_argument("--freq_policy", type=str, default=None, choices=["full", "crop_pow2"])
    p.add_argument("--stft_precision", type=str, default=None,
                   choices=["highest", "high", "default"],
                   help="kept for the JAX package's flags: the port's STFT is float32")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu")


def eval_config_from_args(args):
    """EvalConfig from the preset and any flag that overrides it."""
    import dataclasses

    from ..config import EvalConfig

    cfg = EvalConfig.fast_serving() if args.preset == "fast" else EvalConfig()
    cfg = dataclasses.replace(cfg, segment_seconds=args.segment_seconds,
                              overlap=args.overlap, mask_mode=args.mask_mode)
    overrides = {}
    for name in ("segment_batch", "transfer_dtype", "device_ola", "ola_bucket_seconds",
                 "freq_policy", "stft_precision"):
        val = getattr(args, name, None)
        if val is not None:
            overrides[name] = val
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def check_device(args, prog: str) -> None:
    """Exit non-zero when ``--device cuda`` (the default) finds no card:
    never fall back to the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device (--device cpu runs on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Separate audio into stems (PyTorch port)")
    p.add_argument("inputs", nargs="+", help="input WAV files")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("-o", "--output_dir", type=str, default="separated")
    p.add_argument("--stems", type=str, default="vocals,other")
    p.add_argument("--segment_seconds", type=float, default=10.0)
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--mask_mode", type=str, default="trainer",
                   choices=["trainer", "direct", "mag_direct"])
    p.add_argument("--stream", action="store_true",
                   help="pipeline several files through separate_stream (the same "
                        "results, higher throughput; needs device_ola)")
    add_serving_args(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_device(args, "cli.separate")
    from ..evaluation import BatchSeparator, load_separator_from_checkpoint

    eval_cfg = eval_config_from_args(args)
    separator = load_separator_from_checkpoint(
        args.checkpoint, eval_config=eval_cfg, stem_names=tuple(args.stems.split(",")),
        device=args.device)
    if args.stream and len(args.inputs) > 1 and separator.device_ola:
        _stream_files(separator, args.inputs, args.output_dir, eval_cfg.stream_max_in_flight)
        return
    results = BatchSeparator(separator).separate_files(args.inputs, args.output_dir)
    for path, res in results.items():
        print(f"{path}: {res['status']} {res.get('outputs', res.get('error'))}")


def _stream_files(separator, inputs, output_dir, max_in_flight) -> None:
    """Read every file, separate them through separate_stream, write the
    stems."""
    from ..evaluation.inference import _resample_poly, read_audio, write_stems

    tracks = []
    for path in inputs:
        audio, sr = read_audio(path)
        if sr != separator.sample_rate:
            audio = _resample_poly(audio, sr, separator.sample_rate)
        tracks.append(audio)
    outs = separator.separate_stream(tracks, max_in_flight=max_in_flight)
    for path, separated in zip(inputs, outs):
        written = write_stems(separated, path, output_dir, separator.sample_rate)
        print(f"{path}: ok {written}")


if __name__ == "__main__":
    main()
