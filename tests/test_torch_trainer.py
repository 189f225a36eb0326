"""The port's Trainer, checkpoints and training CLI on the CPU, with a
small model (dims (8, 16, 32, 64), one block a stage) and an 8 kHz STFT
(n_fft 256, hop 64):
  - the CLI (``tfswa_tpu_torch.cli.train.main``, the recipe of
    ``configs/musdb_repro.yaml`` cut to size: 2 kHz, on the plain f32
    route, since the kernel route's plain version emulates bf16 and takes
    minutes here; it runs under remat in ``test_torch_remat.py``) writes
    the JSONL records and the checkpoint layout, and a resumed run
    continues it;
  - the epoch loop's SDR cadence and best-checkpoint choice follow the
    JAX ``Trainer.train``: both are run on the same stub epochs and
    compared call for call;
  - a restored checkpoint equals the saved state bit for bit;
  - after ``evaluate_sdr`` the model is in train mode with its running
    stats unchanged;
  - ``load_separator_from_checkpoint`` reads the ``best`` file.
"""
import dataclasses
import json
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tfswa_tpu.training.trainer import Trainer as JaxTrainer
from tfswa_tpu_torch.cli import train as cli
from tfswa_tpu_torch.config import (Config, DataConfig, ModelConfig, STFTConfig,
                                    TrainConfig)
from tfswa_tpu_torch.data.augment import SpectrogramAugmentation
from tfswa_tpu_torch.data.synthetic import SyntheticDataset
from tfswa_tpu_torch.evaluation import load_separator_from_checkpoint
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.training.checkpointing import CheckpointManager, restore_variables
from tfswa_tpu_torch.training.trainer import MetricLogger, Trainer

SR = 8000
RECIPE = str(Path(__file__).resolve().parents[1] / "configs" / "musdb_repro.yaml")
SMALL = dict(in_channels=4, out_channels=4, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
             window_size=4, shift_size=2, num_heads=2)
TINY = ["--set", "data.sample_rate=2000", "--set", "stft.n_fft=256",
        "--set", "stft.hop_length=64", "--set", "model.depths=(1,1,1,1)",
        "--set", "model.dims=(8,16,32,64)", "--set", "model.window_size=4",
        "--set", "model.shift_size=2", "--set", "model.num_heads=2",
        "--set", "model.attention_impl=xla", "--set", "model.dtype=float32",
        "--set", "data.num_workers=2", "--set", "train.log_every_n_steps=1",
        "--set", "train.steps_per_epoch=2", "--set", "train.sdr_eval_num_tracks=1",
        "--set", "train.sdr_eval_segment_seconds=2.0", "--set", "data.segment_seconds=2.0",
        "--batch_size", "4", "--device", "cpu", "--synthetic"]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound steps from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The trainers here log to the JSONL alone (TensorBoard's import is
    seconds of CPU); ``test_metric_logger_*`` covers the TensorBoard path."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_metric_logger_writes_jsonl_and_tensorboard_when_it_imports(tmp_path, monkeypatch):
    scalars = []

    class Writer:
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def add_scalar(self, k, v, step):
            scalars.append((k, v, step))

        def close(self):
            scalars.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    logger = MetricLogger(str(tmp_path))
    logger.log({"train/total_loss": 0.5, "val/total_loss": 0.25}, 3)
    logger.close()
    assert scalars == [("train/total_loss", 0.5, 3), ("val/total_loss", 0.25, 3), "closed"]
    (rec,) = _records(str(tmp_path))
    assert rec["step"] == 3 and rec["val/total_loss"] == 0.25


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def test_cli_trains_logs_checkpoints_and_resumes(tmp_path, capsys):
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    argv = ["--config", RECIPE, *TINY, "--checkpoint_dir", ck,
            "--log_dir", logs]
    cli.main(argv + ["--num_epochs", "1"])
    assert sorted(os.listdir(ck)) == ["best", "config.json", "epoch_000000", "latest"]
    recs = _records(logs)
    keys = set().union(*recs)
    for k in ("train/total_loss", "train/grad_norm", "epoch_train/step_time_s",
              "val/total_loss", "sdr/vocals", "si_sdr/other", "sdr/avg"):
        assert k in keys, k
    assert all(np.isfinite(v) for r in recs for v in r.values())
    saved = json.load(open(os.path.join(ck, "config.json")))
    assert saved["model"]["remat"] and saved["data"]["augment"] and saved["data"]["mixup"]
    assert saved["train"]["train_mask_mode"] == "direct"

    cli.main(argv + ["--num_epochs", "2", "--resume", "latest"])
    tree, meta = CheckpointManager(ck).restore("latest")
    assert meta == {"epoch": 1, "global_step": 4, "best_val_loss": meta["best_val_loss"]}
    assert tree["optimizer"]["count"] == 4
    assert "epoch_000001" in os.listdir(ck)
    assert max(r["step"] for r in _records(logs)) == 4
    assert "total_loss" in capsys.readouterr().out
    assert os.listdir(logs) == ["metrics.jsonl"]


def test_cli_use_mrstft_gives_the_jax_clis_config():
    from tfswa_tpu.cli import train as jcli

    argv = ["--use_mrstft", "--set", "train.mrstft_weight=0.25"]
    port = cli.config_from_args(cli.build_parser().parse_args(argv)).train
    jax_train = jcli.config_from_args(jcli.build_parser().parse_args(argv)).train
    assert (port.use_mrstft_loss, port.mrstft_weight) == (True, 0.25)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_train)
    assert cli.config_from_args(cli.build_parser().parse_args([])).train.use_mrstft_loss is False


def test_cli_overrides_and_the_output_channels_rule():
    args = cli.build_parser().parse_args(
        ["--stems", "vocals,drums,bass,other", "--batch_size", "3", "--lr", "0.01",
         "--use_checkpointing", "--bf16", "--augment", "--mixup", "--seed", "5",
         "--set", "model.out_channels=2"])
    cfg = cli.config_from_args(args)
    assert cfg.model.out_channels == 8 and cfg.model.in_channels == 4
    assert (cfg.data.batch_size, cfg.train.learning_rate, cfg.train.seed) == (3, 0.01, 5)
    assert cfg.model.remat and cfg.model.dtype == "bfloat16"
    assert cfg.data.augment and cfg.data.mixup and args.device == "cuda"


def _config(tmp_path, **train_kw):
    return Config(
        model=ModelConfig(**SMALL), stft=STFTConfig(n_fft=256, hop_length=64, sample_rate=SR),
        data=DataConfig(segment_seconds=0.5, sample_rate=SR, batch_size=2, num_workers=0,
                        prefetch=1),
        train=TrainConfig(**dict(dict(
            learning_rate=1e-3, max_epochs=1, log_every_n_steps=1, sdr_eval_num_tracks=1,
            sdr_eval_segment_seconds=0.5, checkpoint_dir=str(tmp_path / "ck"),
            log_dir=str(tmp_path / "logs")), **train_kw)))


def _datasets():
    train = SyntheticDataset(num_tracks=2, track_seconds=2.0, segment_seconds=0.5,
                             sample_rate=SR)
    val = SyntheticDataset(num_tracks=1, track_seconds=2.0, segment_seconds=0.5,
                           sample_rate=SR, random_segments=False, seed=1)
    return train, val


def _run_loop(train_fn, sdr_values, val_losses, val_every):
    """Drive an epoch loop ``train_fn`` (the port's or the JAX
    ``Trainer.train``) on stub epochs; returns its calls and saves."""
    calls = []
    fake = types.SimpleNamespace(
        config=types.SimpleNamespace(train=types.SimpleNamespace(
            max_epochs=len(val_losses), val_every_n_epochs=val_every)),
        current_epoch=0, global_step=0, best_metric=float("inf"), val_loader=object())
    vals, sdrs = iter(val_losses), iter(sdr_values)
    fake.train_epoch = lambda: calls.append("train") or {"total_loss": 1.0}
    fake.validate = lambda: calls.append("val") or {"total_loss": next(vals)}
    fake.evaluate_sdr = lambda: calls.append("sdr") or next(sdrs)
    fake.logger = types.SimpleNamespace(log=lambda *a: None, close=lambda: None)
    fake.ckpt = types.SimpleNamespace(
        save=lambda state, **kw: calls.append(("save", kw["epoch"], kw["is_best"],
                                               kw["best_val_loss"])))
    fake.state = None
    train_fn(fake)
    return calls


@pytest.mark.parametrize("val_every", [1, 2])
def test_sdr_cadence_and_best_choice_follow_jax(val_every):
    val_losses = [0.9, 0.8, 0.85, 0.7, 0.75, 0.6, 0.65, 0.5, 0.55, 0.4, 0.45, 0.3]
    sdr_values = [{"sdr/avg": 3.0}, {"sdr/avg": 2.0}, {}, {"sdr/avg": 5.0}]
    got = _run_loop(Trainer.train, sdr_values, val_losses, val_every)
    want = _run_loop(JaxTrainer.train, sdr_values, val_losses, val_every)
    assert got == want
    assert got.count("sdr") == (3 if val_every == 1 else 2)


def test_resume_restores_the_saved_state_bit_for_bit(tmp_path):
    cfg = _config(tmp_path, steps_per_epoch=2)
    first = Trainer(cfg, *_datasets(), device="cpu")
    first.train()
    second = Trainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=9)),
                     *_datasets(), device="cpu")
    second.load_checkpoint("latest")
    for k, v in first.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[k], v), k
    a, b = first.state.tx.state_dict(), second.state.tx.state_dict()
    assert a["count"] == b["count"] == 2
    for i, s in a["adamw"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(b["adamw"]["state"][i][k], s[k]), (i, k)
    assert (second.state.step, second.global_step, second.current_epoch) == (2, 2, 1)
    assert second.best_metric == first.best_metric < float("inf")


def test_evaluate_sdr_leaves_train_mode_and_running_stats(tmp_path):
    trainer = Trainer(_config(tmp_path), *_datasets(), device="cpu")
    trainer.model.train()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    seen = []
    trainer.model.register_forward_pre_hook(lambda m, a: seen.append(m.training))
    out = trainer.evaluate_sdr()
    assert set(out) == {"sdr/vocals", "sdr/other", "si_sdr/vocals", "si_sdr/other", "sdr/avg"}
    assert seen and not any(seen)                  # the separation ran in eval mode
    assert trainer.model.training
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trainer._sdr_separator.model is trainer.model
    assert trainer._sdr_separator.mask_mode == "trainer"


def test_checkpoint_layout_keep_and_served_best(tmp_path):
    cfg = _config(tmp_path, max_epochs=3, keep_checkpoints=2, steps_per_epoch=1,
                  train_mask_mode="direct")
    trainer = Trainer(cfg, *_datasets(), device="cpu")
    assert trainer._eval_step is not None and trainer.steps_per_epoch == 1
    trainer.train()
    ck = cfg.train.checkpoint_dir
    assert sorted(os.listdir(ck)) == ["best", "config.json", "epoch_000001", "epoch_000002",
                                      "latest"]
    state_dict, saved = restore_variables(ck)
    assert Config.from_dict(saved) == cfg
    sep = load_separator_from_checkpoint(os.path.join(ck, "best", "checkpoint.pt"),
                                         stft_config=cfg.stft, device="cpu")
    best = torch.load(os.path.join(ck, "best", "checkpoint.pt"), weights_only=True)
    for k, v in sep.model.state_dict().items():
        assert torch.equal(v, best["model_state_dict"][k]), k
    out = sep.separate(np.sin(np.arange(SR) * 0.3).astype(np.float32))
    assert set(out) == {"vocals", "other"} and all(np.isfinite(v).all() for v in out.values())
    assert trainer._sdr_separator.mask_mode == "mag_direct"


def test_int8_route_is_refused(tmp_path):
    cfg = _config(tmp_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, attention_impl="int8"))
    with pytest.raises(ValueError, match="inference-only"):
        Trainer(cfg, *_datasets(), device="cpu")


def test_spec_augment_in_the_train_step_is_drawn_from_the_seed_and_step():
    proc = STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR))
    rng = np.random.default_rng(0)
    mix = torch.from_numpy((rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32))
    targets = {k: mix * 0.5 for k in ("vocals", "other")}
    aug = SpectrogramAugmentation(30, 10, prob=1.0)
    seen = []

    def loss(step, seed, spec_augment):
        cfg = Config(model=ModelConfig(**SMALL))
        model, state = pts.create_train_state(cfg, device="cpu")
        model.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
        state.step = step
        fn = pts.make_train_step(model, proc, cfg.data.stems, spec_augment=spec_augment,
                                 rng_seed=seed)
        return float(fn(state, mix, targets)[1]["total_loss"])

    plain = loss(0, 3, None)
    a, b, c = loss(0, 3, aug), loss(0, 3, aug), loss(1, 3, aug)
    assert a == b and a != plain and c != a
    want = aug(np.random.default_rng((3, 0)), seen[0])
    torch.testing.assert_close(seen[1], want, rtol=0, atol=0)
