"""One rank of the port's multi-process tests (``tests/test_torch_parallel_ranks.py``),
and the scenarios they share with the one-process references.

    python tests/_torch_parallel_worker.py GROUP WORLD RANK STORE OUT

joins a gloo process group of WORLD CPU ranks through the file store STORE
(the training CLI's ``--coordinator file://...`` path), runs the scenarios
of GROUP and writes rank 0's results (and each rank's own facts) as
``torch.save`` files under OUT.  Imports torch and the port only.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tfswa_tpu_torch.config import Config  # noqa: E402
from tfswa_tpu_torch.models import TFSWAUNet  # noqa: E402
from tfswa_tpu_torch.ops.stft import STFTProcessor  # noqa: E402
from tfswa_tpu_torch.training.train_state import (ClippedAdamW, create_train_state,  # noqa: E402
                                                  make_eval_step, make_sharded_eval_step,
                                                  make_sharded_train_step, make_train_step)

SR = 8000
STEMS = ("vocals", "other")
# the small config of the JAX package's tests/test_tensor_parallel.py
SMALL = dict(in_channels=4, out_channels=4, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
             window_size=4, shift_size=2, num_heads=2)
LR = 1e-2
# tracks of the separation scenarios: host OLA across a partial last hop, the
# device OLA's exact cover (2.5 s = a segment and two hops), one segment
TRACKS = {"host": 3.3, "device_ola": 2.5, "short": 0.5}


def small_config(impl="xla", **model_kw) -> Config:
    cfg = Config().apply_overrides([
        f"model.attention_impl={impl}", "model.remat=false", "stft.n_fft=256",
        "stft.hop_length=64", f"stft.sample_rate={SR}", f"data.sample_rate={SR}"])
    for k, v in {**SMALL, **model_kw}.items():
        setattr(cfg.model, k, v)
    return cfg


def batch(n=8, samples=1024):
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((n, 2, samples)).astype(np.float32)
    targets = {s: rng.standard_normal((n, 2, samples)).astype(np.float32) for s in STEMS}
    return torch.from_numpy(mix), {k: torch.from_numpy(v) for k, v in targets.items()}


def use_sgd(state, max_norm=1.0):
    """clip + SGD in place of clip + AdamW (as the JAX package's TP test):
    Adam's first update is about lr * sign(g), so reduction-order noise in
    near-zero gradients flips signs; SGD keeps the update proportional."""
    tx = state.tx
    sgd = ClippedAdamW(tx.params, lambda count: LR, max_norm, 0.0, tx.model_axis, tx.sharded)
    sgd.adamw = torch.optim.SGD(sgd.params, lr=LR)
    state.tx = sgd


def train_once(cfg, mesh=None, max_norm=1.0, steps=1):
    """``steps`` train steps of the small model on :func:`batch` (this
    rank's rows under a mesh) with clip + SGD: (loss dict, whole
    state_dict on the CPU)."""
    from tfswa_tpu_torch.parallel.sharding import gather_state_dict, shard_batch

    model, state = create_train_state(cfg, device="cpu", mesh=mesh)
    use_sgd(state, max_norm)
    proc = STFTProcessor(cfg.stft)
    mix, targets = batch()
    if mesh is None:
        step = make_train_step(model, proc, STEMS)
    else:
        step = make_sharded_train_step(model, proc, STEMS, mesh)
        mix, targets = shard_batch((mix, targets), mesh)
    for _ in range(steps):
        state, loss = step(state, mix, targets)
    whole = {k: v.detach().clone() for k, v in gather_state_dict(model).items()}
    return {k: float(v) for k, v in loss.items()}, whole


def eval_once(cfg, mesh=None):
    from tfswa_tpu_torch.parallel.sharding import shard_batch

    model, state = create_train_state(cfg, device="cpu", mesh=mesh)
    proc = STFTProcessor(cfg.stft)
    mix, targets = batch()
    if mesh is None:
        return {k: float(v) for k, v in make_eval_step(model, proc, STEMS)(
            state, mix, targets).items()}
    mix, targets = shard_batch((mix, targets), mesh)
    return {k: float(v) for k, v in make_sharded_eval_step(model, proc, STEMS, mesh)(
        state, mix, targets).items()}


def validate_once(out, mesh=None):
    """Trainer.validate() of the small model (weights from seed 0) on five
    validation items at a global batch of 4: under a (2, m) mesh the last
    batch's one item falls to data rank 0 and none to data rank 1."""
    from tfswa_tpu_torch.data import SyntheticDataset
    from tfswa_tpu_torch.training import trainer as trainer_mod

    cfg = small_config()
    cfg.data.batch_size, cfg.data.segment_seconds, cfg.data.num_workers = 4, 0.25, 0
    cfg.train.checkpoint_dir = os.path.join(out, "val_ck")
    cfg.train.log_dir = os.path.join(out, "val_logs")
    train = SyntheticDataset(num_tracks=4, track_seconds=0.25, segment_seconds=0.25,
                             sample_rate=SR)
    val = SyntheticDataset(num_tracks=5, track_seconds=0.25, segment_seconds=0.25,
                           sample_rate=SR, random_segments=False, seed=1)
    # no metric log (its TensorBoard import takes about 10 s): validate() writes none
    logger = trainer_mod.MetricLogger
    trainer_mod.MetricLogger = lambda log_dir: trainer_mod._NullLogger()
    try:
        return trainer_mod.Trainer(cfg, train, val, device="cpu", mesh=mesh).validate()
    finally:
        trainer_mod.MetricLogger = logger


def separate_all(impl, mesh=None):
    """{track: {stem: audio}} of the separation scenarios, the model's
    weights from seed 0."""
    from tfswa_tpu_torch.evaluation import SourceSeparator

    rng = np.random.default_rng(1)
    out = {}
    for name, seconds in TRACKS.items():
        model = TFSWAUNet(attention_impl=impl, generator=torch.Generator().manual_seed(0),
                          **SMALL)
        kw = dict(device_ola=True, ola_bucket_seconds=2.5) if name == "device_ola" else {}
        sep = SourceSeparator(model, STFTProcessor(small_config().stft), segment_length=1.0,
                              segment_batch=3, device="cpu", mesh=mesh, **kw)
        track = rng.standard_normal(int(SR * seconds)).astype(np.float32)
        out[name] = sep.separate(track)
    return out


def collectives_of_a_step(cfg, mesh):
    """Per-op counts and bytes of the collectives of one sharded train
    step, from a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    from tfswa_tpu_torch.parallel.analysis import collective_stats
    from tfswa_tpu_torch.parallel.sharding import shard_batch

    model, state = create_train_state(cfg, device="cpu", mesh=mesh)
    step = make_sharded_train_step(model, STFTProcessor(cfg.stft), STEMS, mesh)
    mix, targets = shard_batch(batch(), mesh)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        step(state, mix, targets)
    stats = collective_stats(prof)
    return {"counts": stats.counts, "bytes": stats.bytes}


def cli_argv(ck, logs):
    return ["--device", "cpu", "--synthetic", "--batch_size", "4",
            "--checkpoint_dir", ck, "--log_dir", logs,
            "--set", "data.sample_rate=2000", "--set", "stft.n_fft=256",
            "--set", "stft.hop_length=64", "--set", "model.depths=(1,1,1,1)",
            "--set", "model.dims=(8,16,32,64)", "--set", "model.window_size=4",
            "--set", "model.shift_size=2", "--set", "model.num_heads=2",
            "--set", "model.attention_impl=xla", "--set", "data.num_workers=0",
            "--set", "train.log_every_n_steps=1", "--set", "train.steps_per_epoch=2",
            "--set", "train.sdr_eval_num_tracks=1", "--set", "data.segment_seconds=1.0",
            "--set", "train.sdr_eval_segment_seconds=1.0"]


def run_cli(world, rank, store, out):
    """cli.train on a (2, 1) mesh from the multi-host flags: 2 steps, then
    2 more resumed from latest (no validation: the separation and the eval
    step under a mesh are scenarios of their own).  Returns what this
    rank's trainer was."""
    from tfswa_tpu_torch.cli import train as cli
    from tfswa_tpu_torch.training import trainer as trainer_mod

    ck, logs = os.path.join(out, "ck"), os.path.join(out, "logs")
    argv = cli_argv(ck, logs) + [
        "--set", "train.val_every_n_epochs=100", "--mesh", "2,1", "--multihost",
        "--coordinator", f"file://{store}", "--num_processes", str(world),
        "--process_id", str(rank)]
    cli.main(argv + ["--num_epochs", "1"])
    seen = {}
    init = trainer_mod.Trainer.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        seen.update(main=self.is_main_process, ckpt=self.ckpt is not None,
                    shard=self.train_loader.shard_index, shards=self.train_loader.num_shards)

    trainer_mod.Trainer.__init__ = spy
    try:
        cli.main(argv + ["--num_epochs", "2", "--resume", "latest"])
    finally:
        trainer_mod.Trainer.__init__ = init
    return seen


def run_group(group, world, rank, store, out):
    from tfswa_tpu_torch.parallel import create_mesh

    res, mine = {}, {}
    if group == "two":
        mine["cli"] = run_cli(world, rank, store, out)      # joins the process group
        m21, m12 = create_mesh((2, 1), device="cpu"), create_mesh((1, 2), device="cpu")
        for tag, mesh in (("21", m21), ("12", m12)):
            for impl in ("xla", "pallas"):
                res[f"train_{tag}_{impl}"] = train_once(small_config(impl), mesh)
            res[f"eval_{tag}"] = eval_once(small_config(), mesh)
            res[f"collectives_{tag}"] = collectives_of_a_step(small_config(), mesh)
        res["separate_21_xla"] = separate_all("xla", m21)
        res["separate_12_xla"] = separate_all("xla", m12)
        res["separate_12_pallas"] = separate_all("pallas", m12)
        res["train_21_remat"] = train_once(small_config(remat=True), m21)
        res["train_12_dropout"] = train_once(small_config(dropout=0.1), m12, steps=2)
        res["train_12_clip"] = train_once(small_config(), m12, max_norm=1e-3)
        res["validate_21"] = validate_once(out, m21)
    elif group == "four":
        mesh = create_mesh((2, 2), device="cpu")
        for impl in ("xla", "pallas"):
            res[f"train_22_{impl}"] = train_once(small_config(impl), mesh)
        res["validate_22"] = validate_once(out, mesh)
    if rank == 0:
        torch.save(res, os.path.join(out, f"{group}.pt"))
    with open(os.path.join(out, f"{group}_rank{rank}.json"), "w") as fh:
        json.dump(mine, fh)


def main():
    group, world, rank, store, out = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    # the metric log writes metrics.jsonl alone: TensorBoard's import
    # (TensorFlow, about 10 s) would only slow rank 0 down
    sys.modules["torch.utils.tensorboard"] = None
    if group != "two":      # group "two" joins through the training CLI's flags
        from tfswa_tpu_torch.parallel import initialize_distributed

        initialize_distributed(f"file://{store}", world, rank, device="cpu")
    run_group(group, world, rank, store, out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
