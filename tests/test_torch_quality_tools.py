"""The port's quality tools (``tfswa_tpu_torch/tools/``: quality_ab,
sdr_baseline, eval_ab_checkpoint, overlap_ab, visualize) against the JAX
package's root ``tools/`` on the CPU:
  - quality_ab: each arm's training command equals the JAX tool's with the
    module swapped (``subprocess.run`` monkeypatched in both), and
    ``summarize`` over the committed ``runs/quality_ab/`` gives the JAX
    tool's dict;
  - sdr_baseline: ``baseline_config()`` equals the JAX tool's config field
    by field (remat by truthiness), and ``baseline()`` on a checkpoint
    gives JAX ``Trainer.evaluate_sdr``'s SDR on the same weights (carried
    over by ``weights.py``) within 0.05 dB a stem;
  - overlap_table: on the same weights at two overlaps, each stem's SDR
    within 0.05 dB of the JAX ``SourceSeparator`` + ``metrics.sdr`` loop
    of ``tools/overlap_ab.py`` and ``delta_db_vs_first`` within 0.1 dB;
  - eval_ab_checkpoint: on the checkpoints ``cli.train`` writes, every
    named checkpoint with its global_step, equal to ``evaluate_sdr`` run
    directly;
  - visualize: the architecture lines equal the JAX tool's, the total its
    parameter count and each module's count its JAX counterpart's;
  - every tool exits non-zero with ``--device cuda`` and no card.
The model is small (depths (1, 1, 1, 1), dims (8, 16, 32, 64)) on the
plain f32 route, with weights from a seed, at 2 kHz with n_fft 64 and hop
32 (F = 33): the tools separate all of each 30 s synthetic track, so the
STFT is kept small; the SDR evaluations separate 1 s segments.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.config import Config as JaxConfig
from tfswa_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.evaluation.metrics import sdr as jax_sdr
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxSTFT
from tfswa_tpu.training.trainer import Trainer as JaxTrainer
from tfswa_tpu_torch.cli import train as cli
from tfswa_tpu_torch.config import Config
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.tools import (eval_ab_checkpoint, overlap_ab, quality_ab, sdr_baseline,
                                   visualize)
from tfswa_tpu_torch.training.trainer import Trainer
from tfswa_tpu_torch.weights import top_modules, variables_from_state_dict

REPO = Path(__file__).resolve().parents[1]
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 32, 64)
SR = 2000
SMALL = [f"model.depths={DEPTHS}", f"model.dims={DIMS}", "model.window_size=4",
         "model.shift_size=2", "model.num_heads=2", "model.attention_impl=xla",
         "model.dtype=float32", f"data.sample_rate={SR}", f"stft.sample_rate={SR}",
         "stft.n_fft=64", "stft.hop_length=32", "train.sdr_eval_segment_seconds=1.0",
         "train.sdr_eval_num_tracks=1"]
SDR_DB = 0.05
DELTA_DB = 0.1


def load_jax_tool(name: str):
    """The JAX package's root ``tools/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound separations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The trainers of both packages log to the JSONL alone (TensorBoard's
    import is seconds of CPU)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def small_config(tmp_path) -> Config:
    """baseline_config() cut to the small model, f32 plain route."""
    cfg = sdr_baseline.baseline_config().apply_overrides(SMALL)
    cfg.train.checkpoint_dir = str(tmp_path / "ck")
    cfg.train.log_dir = str(tmp_path / "logs")
    return cfg


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(small Config, the port's init from a seed as a state_dict, a JAX
    Trainer holding the same weights, carried over by ``weights.py``)."""
    cfg = small_config(tmp_path_factory.mktemp("jax"))
    sd = TFSWAUNet.from_config(cfg.model, torch.Generator().manual_seed(0)).state_dict()
    jcfg = JaxConfig.from_dict(cfg.to_dict())
    d = jcfg.data
    train = JaxSynthetic(num_tracks=16, track_seconds=30.0, segment_seconds=d.segment_seconds,
                         sample_rate=d.sample_rate)
    val = JaxSynthetic(num_tracks=4, track_seconds=30.0, segment_seconds=d.segment_seconds,
                       sample_rate=d.sample_rate, random_segments=False, seed=999)
    variables = jax.tree_util.tree_map(jnp.asarray, variables_from_state_dict(sd, DEPTHS))
    # evaluate_sdr reads the state's params and batch_stats alone
    state = types.SimpleNamespace(**variables)
    jt = JaxTrainer(jcfg, train_dataset=train, val_dataset=val,
                    model=JaxUNet.from_config(jcfg.model), state=state)
    return cfg, sd, jt


# ------------------------------------------------------------------ quality_ab
@pytest.mark.parametrize("arm", ["parity", "direct", "shift"])
def test_run_arm_command_equals_the_jax_tools(arm, tmp_path, monkeypatch):
    jq = load_jax_tool("quality_ab")
    monkeypatch.setattr(jq, "OUT", str(tmp_path))
    calls = []

    def fake_run(cmd, check, cwd):
        calls.append((cmd, check, cwd))

    monkeypatch.setattr(subprocess, "run", fake_run)
    jq.run_arm(arm, 6)
    quality_ab.run_arm(arm, 6, out=str(tmp_path))
    (jcmd, jcheck, jcwd), (cmd, check, cwd) = calls
    assert jcmd[:3] == [sys.executable, "-m", "tfswa_tpu.cli.train"]
    assert cmd == jcmd[:2] + ["tfswa_tpu_torch.cli.train"] + jcmd[3:]
    assert (check, cwd) == (jcheck, jcwd) == (True, str(REPO))
    assert quality_ab.arm_command(arm, 6, str(tmp_path), "cpu") == cmd + ["--device", "cpu"]


def test_summarize_over_the_committed_runs_equals_the_jax_tools(monkeypatch):
    jq = load_jax_tool("quality_ab")
    committed = str(REPO / "runs" / "quality_ab")
    monkeypatch.setattr(jq, "OUT", committed)
    arms = ["parity", "direct", "shift"]
    want = jq.summarize(arms)
    assert want["direct"]["best_sdr_avg"] == pytest.approx(7.587950140237808)
    assert quality_ab.summarize(arms, out=committed) == want


# ---------------------------------------------------------------- sdr_baseline
def test_baseline_config_equals_the_jax_tools(monkeypatch):
    js = load_jax_tool("sdr_baseline")
    seen = {}

    class Capture:
        def __init__(self, cfg, train_dataset, val_dataset):
            seen.update(cfg=cfg, train=train_dataset, val=val_dataset)

        def evaluate_sdr(self):
            return {}

    monkeypatch.setattr(js, "Trainer", Capture)
    monkeypatch.setattr(sys, "argv", ["sdr_baseline.py"])
    with contextlib.redirect_stdout(io.StringIO()):
        js.main()
    want, got = seen["cfg"].to_dict(), sdr_baseline.baseline_config().to_dict()
    assert want["model"]["remat"] == "tfswa_block" and got["model"]["remat"] is True
    assert set(got) == set(want)
    for section in want:
        assert set(got[section]) == set(want[section]), section
        for key, value in want[section].items():
            if (section, key) == ("model", "remat"):
                assert bool(got[section][key]) == bool(value)
            elif key not in ("checkpoint_dir", "log_dir"):   # the JAX tool's fixed paths
                assert got[section][key] == value, (section, key)
    cfg = sdr_baseline.baseline_config()
    train, val = cli.build_datasets(cfg, synthetic=True)
    for ours, theirs in ((train, seen["train"]), (val, seen["val"])):
        assert (len(ours), ours.track_names) == (len(theirs), theirs.track_names)
        assert ours.random_segments == theirs.random_segments


def test_baseline_on_a_checkpoint_matches_jax_evaluate_sdr(weights, tmp_path):
    cfg, sd, jt = weights
    # a checkpoint directory of the port's trainer holding the weights
    writer = Trainer(small_config(tmp_path), *cli.build_datasets(cfg, True), device="cpu")
    writer.model.load_state_dict(sd)
    writer.ckpt.save(writer.state, epoch=0, global_step=7, best_val_loss=1.0, is_best=True)
    writer.logger.close()
    config_json = (tmp_path / "ck" / "config.json").read_text()

    out = sdr_baseline.baseline(small_config(tmp_path / "b"), str(tmp_path / "ck"), "best",
                                device="cpu")
    assert set(out) == {"untrained", "best@step7"}
    assert np.isfinite(out["untrained"]["sdr/avg"])
    want = jt.evaluate_sdr()
    got = out["best@step7"]
    assert set(got) == set(want)
    for s in cfg.data.stems:
        assert abs(got[f"sdr/{s}"] - want[f"sdr/{s}"]) < SDR_DB, s
    # the checkpoint directory is read, not written
    assert (tmp_path / "ck" / "config.json").read_text() == config_json
    assert sorted(os.listdir(tmp_path / "ck")) == ["best", "config.json", "epoch_000000",
                                                    "latest"]


# ------------------------------------------------------------------ overlap_ab
def test_overlap_table_matches_the_jax_loop(weights):
    cfg, sd, jt = weights
    cfg = cfg.apply_overrides(["train.train_mask_mode=direct"])
    model = TFSWAUNet.from_config(cfg.model)
    model.load_state_dict(sd)
    overlaps = (0.5, 0.25)
    got = overlap_table_cpu(model, cfg, overlaps)

    # the JAX tool's loop (tools/overlap_ab.py:73-104) on the same weights
    proc = JaxSTFT(jt.config.stft)
    val = JaxSynthetic(num_tracks=4, track_seconds=30.0,
                       segment_seconds=cfg.data.segment_seconds,
                       sample_rate=cfg.data.sample_rate, stems=cfg.data.stems,
                       random_segments=False, seed=999)
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    stems = tuple(cfg.data.stems)
    ref_out = None
    for ov in overlaps:
        sep = JaxSeparator(jt.model, variables, proc, segment_length=1.0, overlap=ov,
                           mask_mode="mag_direct", stem_names=stems, segment_batch=8)
        per_stem, outs = {s: [] for s in stems}, []
        for i in range(len(val.track_names)):
            mixture, refs = val.get_full_track(i)
            ests = sep.separate(mixture)
            outs.append(ests)
            for s in stems:
                per_stem[s].append(float(jax_sdr(jnp.asarray(np.asarray(ests[s])[0]),
                                                 jnp.asarray(np.asarray(refs[s]).mean(0)))))
        entry = got[str(ov)]
        for s in stems:
            assert abs(entry[f"sdr/{s}"] - np.mean(per_stem[s])) < SDR_DB, (ov, s)
        assert entry["sdr/avg"] == pytest.approx(np.mean([entry[f"sdr/{s}"] for s in stems]))
        if ref_out is None:
            ref_out = outs
            assert "delta_db_vs_first" not in entry
            continue
        num = sum(float(np.sum((a[s][0].astype(np.float64) - b[s][0]) ** 2))
                  for a, b in zip(outs, ref_out) for s in stems)
        den = sum(float(np.sum(b[s][0].astype(np.float64) ** 2)) for b in ref_out for s in stems)
        assert abs(entry["delta_db_vs_first"] - 10 * np.log10(num / den)) < DELTA_DB


def overlap_table_cpu(model, cfg, overlaps):
    with contextlib.redirect_stdout(io.StringIO()):
        return overlap_ab.overlap_table(model, cfg, overlaps, segment_length=1.0, device="cpu")


# ---------------------------------------------------------- eval_ab_checkpoint
def test_eval_ab_checkpoint_equals_evaluate_sdr_on_the_cli_checkpoints(tmp_path):
    arm_dir = tmp_path / "parity"
    argv = ["--device", "cpu", "--synthetic", "--batch_size", "4", "--num_epochs", "2",
            "--segment_seconds", "2.0", "--checkpoint_dir", str(arm_dir / "ck"),
            "--log_dir", str(arm_dir), "--set", "train.steps_per_epoch=1",
            "--set", "data.num_workers=0"]
    for ov in SMALL:
        argv += ["--set", ov]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
        names = ["epoch_000000", "epoch_000001"]
        rc = eval_ab_checkpoint.main(["--arm", "parity", "--root", str(tmp_path), "--device",
                                      "cpu", "--checkpoints", *names, "--out", "sdr.json"])
    assert rc == 0
    got = json.loads((arm_dir / "sdr.json").read_text())
    assert list(got) == names

    with open(arm_dir / "ck" / "config.json") as fh:
        cfg = Config.from_dict(json.load(fh))
    trainer = Trainer(cfg, *cli.build_datasets(cfg, True), device="cpu")
    for step, name in enumerate(names, start=1):
        trainer.load_checkpoint(name)
        assert got[name] == dict(trainer.evaluate_sdr(), global_step=step)
    trainer.logger.close()


# ------------------------------------------------------------------- visualize
def test_visualize_matches_the_jax_tool(monkeypatch):
    args = ["--depths", "1,1,2,1", "--dims", "8,16,32,64", "--height", "64", "--width", "96"]
    jv = load_jax_tool("visualize")
    monkeypatch.setattr(sys, "argv", ["visualize.py"] + args)
    monkeypatch.setattr(jax.config, "update", lambda *a: None)   # already on the CPU
    # the parameter shapes alone: JAX's init runs op by op here (a minute)
    init = JaxUNet.init
    monkeypatch.setattr(JaxUNet, "init", lambda self, *a: jax.eval_shape(
        lambda *b: init(self, *b), *a))
    jout, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        jv.main()
    with contextlib.redirect_stdout(out):
        assert visualize.main(args + ["--device", "cpu"]) == 0
    jlines, lines = jout.getvalue().splitlines(), out.getvalue().splitlines()
    arch = slice(3, lines.index("-" * 64))
    assert lines[1] == "TFSWA-UNet (tfswa_tpu_torch)"
    assert lines[arch] == jlines[arch] == visualize.architecture_lines(
        (1, 1, 2, 1), DIMS, 2, 2, 64, 96)

    def table(text_lines):
        start = text_lines.index("-" * 64) + 2
        rows = {}
        for line in text_lines[start:]:
            if line.startswith("-"):
                break
            name, count, _ = line.split()
            rows[name] = int(count.replace(",", ""))
        total = next(int(x.split()[1].replace(",", "")) for x in text_lines
                     if x.startswith("TOTAL"))
        return rows, total, text_lines[-1]

    (jrows, jtotal, jsizes), (rows, total, sizes) = table(jlines), table(lines)
    assert total == jtotal and sizes == jsizes
    names = top_modules((1, 1, 2, 1))
    assert list(rows) == list(names)
    assert {names[k]: v for k, v in rows.items()} == jrows
    model = TFSWAUNet(2, 2, depths=(1, 1, 2, 1), dims=DIMS)
    assert total == model.count_parameters()


# --------------------------------------------------------------- no card, no run
@pytest.mark.parametrize("tool,argv", [
    (visualize, []), (sdr_baseline, []), (quality_ab, ["--arms", "direct", "--epochs", "1"]),
    (eval_ab_checkpoint, ["--arm", "direct"]), (overlap_ab, []),
])
def test_each_tool_exits_non_zero_on_cuda_without_a_card(tool, argv, monkeypatch, capsys,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("trained anyway"))
    rc = tool.main(argv + (["--out", str(tmp_path)] if tool is quality_ab else []))
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)
