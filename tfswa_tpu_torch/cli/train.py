"""Training CLI (counterpart of ``tfswa_tpu/cli/train.py``): a YAML config,
dotted overrides and the reference's common flags as shortcuts.

    python -m tfswa_tpu_torch.cli.train --config configs/musdb_repro.yaml \\
        --data_root /data/musdb18hq
    python -m tfswa_tpu_torch.cli.train --config configs/musdb_repro.yaml --synthetic
    torchrun --nproc_per_node 4 -m tfswa_tpu_torch.cli.train --mesh 2,2 ...
    python -m tfswa_tpu_torch.cli.train --mesh 2,1 --multihost \
        --coordinator host0:29500 --num_processes 2 --process_id 0 ...

Training runs on ``--device`` ("cuda" unless "cpu" is asked for).  Multi-GPU
runs one process a card: ``--mesh d,m`` trains on a (data, model) mesh of
d * m ranks (from a launcher's environment, or from ``--multihost`` with
``--coordinator``, ``--num_processes`` and ``--process_id``); a world of
another size raises.  ``--multihost`` alone puts every rank on the data
axis.  Rank 0 writes the checkpoints and the metrics.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train TFSWA-UNet (PyTorch port)")
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. model.dims=(32,64,128,256)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic dataset (no MUSDB needed)")
    p.add_argument("--stems", type=str, default=None,
                   help="comma-separated, e.g. vocals,other")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--segment_seconds", type=float, default=None)
    p.add_argument("--n_fft", type=int, default=None)
    p.add_argument("--hop_length", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--num_epochs", type=int, default=None)
    p.add_argument("--use_checkpointing", action="store_true",
                   help="enable gradient rematerialization")
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--augment", action="store_true")
    p.add_argument("--mixup", action="store_true")
    p.add_argument("--use_mrstft", action="store_true",
                   help="add the multi-resolution STFT loss")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None,
                   help="'latest', 'best', or epoch_NNNNNN")
    p.add_argument("--mesh", type=str, default=None,
                   help="data,model e.g. 4,2 (one rank a card; default: all ranks on data)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group before training, from --coordinator / "
                        "--num_processes / --process_id or a launcher's RANK, WORLD_SIZE "
                        "and LOCAL_RANK.  Each rank loads its own slice of every global "
                        "batch; rank 0 writes checkpoints and logs.")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 (or a file:// store) for --multihost")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    return p


def config_from_args(args):
    """The YAML (or default) config, then the flags' and ``--set``
    overrides; the model's output channels follow the stems (2 a stem)."""
    from ..config import Config

    cfg = Config.from_yaml(args.config) if args.config else Config()

    overrides = list(args.set)
    for flag, key in (("data_root", "data.musdb_root"), ("batch_size", "data.batch_size"),
                      ("segment_seconds", "data.segment_seconds"), ("n_fft", "stft.n_fft"),
                      ("hop_length", "stft.hop_length"), ("lr", "train.learning_rate"),
                      ("num_epochs", "train.max_epochs"),
                      ("checkpoint_dir", "train.checkpoint_dir"),
                      ("log_dir", "train.log_dir"), ("seed", "train.seed")):
        if getattr(args, flag) is not None:
            overrides.append(f"{key}={getattr(args, flag)}")
    if args.stems is not None:
        overrides.append(f"data.stems=({args.stems})")
    for flag, override in (("use_checkpointing", "model.remat=true"),
                           ("bf16", "model.dtype=bfloat16"), ("augment", "data.augment=true"),
                           ("mixup", "data.mixup=true"),
                           ("use_mrstft", "train.use_mrstft_loss=true")):
        if getattr(args, flag):
            overrides.append(override)
    cfg = cfg.apply_overrides(overrides)
    return cfg.apply_overrides([f"model.out_channels={2 * len(cfg.data.stems)}",
                                "model.in_channels=4"])


def build_datasets(cfg, synthetic: bool):
    """(train, validation) datasets: MUSDB18 under ``data.musdb_root``, or
    the synthetic set (16 training tracks and 4 validation tracks of 30 s)
    with ``synthetic`` or without a root."""
    d = cfg.data
    if synthetic or not d.musdb_root:
        from ..data.synthetic import SyntheticDataset

        train = SyntheticDataset(num_tracks=16, track_seconds=30.0,
                                 segment_seconds=d.segment_seconds, sample_rate=d.sample_rate,
                                 stems=d.stems, random_segments=d.random_segments)
        val = SyntheticDataset(num_tracks=4, track_seconds=30.0,
                               segment_seconds=d.segment_seconds, sample_rate=d.sample_rate,
                               stems=d.stems, random_segments=False, seed=999)
        return train, val
    from ..data.musdb import MUSDB18Dataset

    train = MUSDB18Dataset(d.musdb_root, split="train", stems=d.stems,
                           segment_seconds=d.segment_seconds, sample_rate=d.sample_rate,
                           random_segments=d.random_segments)
    val = MUSDB18Dataset(d.musdb_root, split="valid", stems=d.stems,
                         segment_seconds=d.segment_seconds, sample_rate=d.sample_rate,
                         random_segments=False, segment_overlap=d.segment_overlap,
                         max_segments_per_track=d.max_segments_per_track)
    return train, val


def mesh_from_args(args):
    """The mesh of ``--mesh`` / ``--multihost`` after joining the process
    group (a launcher's environment is read with ``--mesh`` alone), or
    None to train in this process alone."""
    if not (args.mesh or args.multihost):
        return None
    from ..parallel import create_mesh, initialize_distributed

    if args.multihost:
        initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                               device=args.device)
    else:
        initialize_distributed(device=args.device)
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split(","))
        return create_mesh((d, m), device=args.device)
    return create_mesh(device=args.device)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from ..training.trainer import Trainer

    mesh = mesh_from_args(args)
    trainer = Trainer(cfg, *build_datasets(cfg, args.synthetic), device=args.device,
                      mesh=mesh)
    if args.resume:
        trainer.load_checkpoint(args.resume)
    metrics = trainer.train()
    if trainer.is_main_process:
        print({k: round(v, 5) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
