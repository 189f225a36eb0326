"""The port's evaluators and evaluation CLI on the CPU, against the JAX
package's:
  - ``MUSDB18Evaluator`` (the port's own metrics) and
    ``CustomDatasetEvaluator`` on the same synthetic data, through
    separators with the same weights at 8 kHz: per-track metrics within
    2e-3 dB (below);
  - ``aggregate_track_metrics`` exactly, on a fixed dict;
  - the museval branch through a fake ``museval`` module (the package is
    not installed), as ``tests/test_evaluator.py`` drives the JAX one;
  - saved estimates, results.json, a failing track warned about and left
    out;
  - ``cli.evaluate.main`` with ``--device cpu`` on a small checkpoint
    directory (``--synthetic``, and a custom dataset), and its refusal
    without a card when ``--device`` is not given.

Tolerance of the metrics: the two separations agree within 1e-4 of audio
O(0.3) (float32 transfers, ``test_torch_separation.py``), a relative
error of about 3e-4 in the estimate.  An SDR is 10 log10 of an energy
ratio, so that moves it by about 10 / ln 10 x 2 x 3e-4 = 2.6e-3 dB at
most where the estimate's error dominates; the separations here are
untrained, far from that case, and 2e-3 dB holds with a margin of ten.
"""
import json
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _soundfile_standin import standin
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from tfswa_tpu.evaluation import evaluator as jev
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.utils.torch_compat import torch_state_dict_to_variables
from tfswa_tpu_torch.cli import evaluate as pcli
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig
from tfswa_tpu_torch.data.synthetic import SyntheticDataset
from tfswa_tpu_torch.data.wav import wav_info, write_wav
from tfswa_tpu_torch.evaluation import evaluator as pev
from tfswa_tpu_torch.evaluation.inference import SourceSeparator
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import create_train_state
from tfswa_tpu_torch.training.checkpointing import CheckpointManager

SR = 8000
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
KNOBS = dict(segment_length=1.0, overlap=0.5, stem_names=("vocals", "other"))
DB = 2e-3


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    pm = TFSWAUNet(4, 4, attention_impl="xla", generator=torch.Generator().manual_seed(0),
                   **SMALL)
    variables = jax.tree_util.tree_map(
        jnp.asarray, torch_state_dict_to_variables(pm.state_dict(), SMALL["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **SMALL)
    js = JaxSeparator(jm, variables, JaxProcessor(JaxSTFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), **KNOBS)
    ps = SourceSeparator(pm, STFTProcessor(STFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), device="cpu", **KNOBS)
    return js, ps


def _close(got, want):
    assert set(got) == set(want)
    for track, stems in want.items():
        assert set(got[track]) == set(stems)
        for stem, metrics in stems.items():
            assert set(got[track][stem]) == set(metrics)
            for m, v in metrics.items():
                assert abs(got[track][stem][m] - v) <= DB, (track, stem, m)


def test_musdb_evaluator_matches_jax(pair, tmp_path):
    js, ps = pair
    kw = dict(num_tracks=3, track_seconds=2.5, sample_rate=SR, seed=3)
    got = pev.MUSDB18Evaluator(ps, SyntheticDataset(**kw), output_dir=str(tmp_path),
                               use_museval=False, segment_seconds=1.0, max_tracks=2,
                               save_estimates=True).evaluate()
    want = jev.MUSDB18Evaluator(js, JaxSynthetic(**kw), use_museval=False,
                                segment_seconds=1.0, max_tracks=2).evaluate()
    assert list(got["tracks"]) == ["synthetic_000", "synthetic_001"]
    _close(got["tracks"], want["tracks"])
    _close({"agg": {k: {m: v["mean"] for m, v in s.items()}
                    for k, s in got["aggregated"].items() if k != "overall"}},
           {"agg": {k: {m: v["mean"] for m, v in s.items()}
                    for k, s in want["aggregated"].items() if k != "overall"}})
    assert json.load(open(tmp_path / "results.json")) == got
    for stem in ("vocals", "other"):
        path = tmp_path / "estimates" / "synthetic_001" / f"{stem}.wav"
        assert wav_info(str(path)) == (int(2.5 * SR), 1, SR)


def test_custom_dataset_evaluator_matches_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", standin())
    js, ps = pair
    ds = SyntheticDataset(num_tracks=2, track_seconds=2.2, sample_rate=SR, seed=5)
    mix_dir, ref_dir = tmp_path / "mix", tmp_path / "refs"
    mix_dir.mkdir()
    for i, name in enumerate(("b_track", "a_track")):
        mix, refs = ds.get_full_track(i)
        write_wav(str(mix_dir / f"{name}.wav"), mix, SR)
        (ref_dir / name).mkdir(parents=True)
        for stem, ref in refs.items():
            write_wav(str(ref_dir / name / f"{stem}.wav"), ref, SR)
    write_wav(str(mix_dir / "orphan.wav"), mix, SR)         # no references: skipped
    with pytest.warns(UserWarning, match="orphan"):
        got = pev.CustomDatasetEvaluator(ps, str(mix_dir), str(ref_dir),
                                         output_dir=str(tmp_path / "out"),
                                         segment_seconds=1.0).evaluate()
    with pytest.warns(UserWarning, match="orphan"):
        want = jev.CustomDatasetEvaluator(js, str(mix_dir), str(ref_dir),
                                          segment_seconds=1.0).evaluate()
    assert list(got["tracks"]) == ["a_track", "b_track"]
    _close(got["tracks"], want["tracks"])
    assert json.load(open(tmp_path / "out" / "results.json")) == got


def test_aggregate_track_metrics_equals_jax():
    per_track = {
        "t0": {"vocals": {"sdr": 1.5, "sir": 7.0}, "other": {"sdr": -2.25, "sar": 3.0}},
        "t1": {"vocals": {"sdr": 4.0, "sir": 5.5}, "other": {"sdr": 0.75, "sar": 1.0}},
        "t2": {"vocals": {"sdr": -1.0, "sir": 9.0}},
    }
    got = pev.aggregate_track_metrics(per_track)
    assert got == jev.aggregate_track_metrics(per_track)
    assert got["overall"] == {"sdr_mean": (1.5 + (-1.5 / 2)) / 2}
    assert pev.aggregate_track_metrics({}) == {}


def test_museval_branch_consumes_the_package(pair, monkeypatch):
    """As the JAX test: a fake museval.evaluate with fixed frame rows; the
    evaluator takes the nan-median of each."""
    calls = {}

    def fake_evaluate(refs, ests, win=None, hop=None):
        calls["shapes"] = (refs.shape, ests.shape, win, hop)

        def rows(base):
            arr = np.full((refs.shape[0], 3), np.nan)
            for i in range(refs.shape[0]):
                arr[i, :2] = [base + i, base + i + 1]
            return arr
        return rows(5.0), rows(10.0), rows(15.0), rows(20.0)

    monkeypatch.setitem(sys.modules, "museval", types.SimpleNamespace(evaluate=fake_evaluate))
    ds = SyntheticDataset(num_tracks=1, track_seconds=1.5, sample_rate=SR, seed=9)
    ev = pev.MUSDB18Evaluator(pair[1], ds, use_museval=True, segment_seconds=1.0)
    assert ev.use_museval
    track = next(iter(ev.evaluate()["tracks"].values()))
    assert track["vocals"] == {"sdr": 5.5, "isr": 10.5, "sir": 15.5, "sar": 20.5}
    assert track["other"]["sdr"] == 6.5
    assert calls["shapes"] == ((2, int(1.5 * SR), 1), (2, int(1.5 * SR), 1), SR, SR)
    monkeypatch.setitem(sys.modules, "museval", None)
    assert not pev.MUSDB18Evaluator(pair[1], ds, use_museval=True).use_museval


def test_a_failing_track_is_warned_about_and_left_out(pair):
    ds = SyntheticDataset(num_tracks=2, track_seconds=1.5, sample_rate=SR, seed=1)
    good = ds.get_full_track

    def broken(i):
        if i == 0:
            raise RuntimeError("unreadable")
        return good(i)

    ds.get_full_track = broken
    with pytest.warns(UserWarning, match="synthetic_000 failed: unreadable"):
        res = pev.MUSDB18Evaluator(pair[1], ds, use_museval=False).evaluate()
    assert list(res["tracks"]) == ["synthetic_001"] and "overall" in res["aggregated"]


def _checkpoint(tmp_path):
    """A small checkpoint directory as the training CLI writes it (plain
    f32 route)."""
    cfg = Config(model=ModelConfig(in_channels=4, out_channels=4, **SMALL))
    _, state = create_train_state(cfg, device="cpu")
    CheckpointManager(str(tmp_path / "ck"), config=cfg).save(state, 0, 1, 0.5, is_best=True)
    return str(tmp_path / "ck")


def test_evaluate_cli_on_the_cpu(tmp_path, capsys):
    """--synthetic (the first of the 4 tracks of 30 s at 44.1 kHz) and a
    custom dataset of two 3 s tracks, at a small STFT (n_fft 512, hop 256)
    and 1 s segments."""
    ck = _checkpoint(tmp_path)
    common = ["--checkpoint", ck, "--device", "cpu", "--n_fft", "512", "--hop_length", "256",
              "--segment_seconds", "1.0", "--no_museval"]
    out = tmp_path / "synthetic"
    pcli.main(common + ["--synthetic", "--max_tracks", "1", "--output_dir", str(out)])
    assert "Evaluated 1 tracks" in capsys.readouterr().out
    res = json.load(open(out / "results.json"))
    assert list(res["tracks"]) == ["synthetic_000"]
    assert all(np.isfinite(v) for s in res["tracks"]["synthetic_000"].values()
               for v in s.values())
    assert np.isfinite(res["aggregated"]["overall"]["sdr_mean"])

    ds = SyntheticDataset(num_tracks=2, track_seconds=3.0, sample_rate=44100, seed=2)
    mix_dir, ref_dir = tmp_path / "mix", tmp_path / "refs"
    mix_dir.mkdir()
    for i in range(2):
        mix, refs = ds.get_full_track(i)
        write_wav(str(mix_dir / f"t{i}.wav"), mix, 44100)
        (ref_dir / f"t{i}").mkdir(parents=True)
        for stem, ref in refs.items():
            write_wav(str(ref_dir / f"t{i}" / f"{stem}.wav"), ref, 44100)
    out = tmp_path / "custom"
    with warnings.catch_warnings():
        warnings.simplefilter("error")                      # no track may fail
        pcli.main(common + ["--mixtures_dir", str(mix_dir), "--references_dir", str(ref_dir),
                            "--output_dir", str(out)])
    res = json.load(open(out / "results.json"))
    assert list(res["tracks"]) == ["t0", "t1"]
    assert set(res["aggregated"]) == {"vocals", "other", "overall"}


def test_evaluate_cli_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        pcli.main(["--checkpoint", str(tmp_path), "--synthetic"])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert pcli.build_parser().parse_args(["--checkpoint", "c"]).device == "cuda"
