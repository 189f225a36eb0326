"""The port's serving entry points on the CPU, against the JAX package's
where it has them:
  - ``load_separator_from_checkpoint`` on a directory the port's
    ``CheckpointManager`` wrote (its root, and an epoch directory): the
    ModelConfig from ``config.json``, the weights equal to the ``.pt``
    route's, and ``ValueError`` with neither a config nor a model_config;
  - ``separate_file`` and ``BatchSeparator`` (a missing file recorded as an
    error, the next one separated) against the JAX package's, with 8 kHz
    and 48 kHz inputs (``_resample_poly`` against JAX's, exactly: both
    call scipy);
  - ``eval_config_from_args`` equal to JAX's for the same argv;
  - ``cli.separate.main`` with ``--device cpu`` on a small checkpoint
    directory (the stream and the BatchSeparator path), and its refusal
    without a card when ``--device`` is not given.
The JAX package reads and writes WAVs through ``soundfile``, which is not
installed: those tests give it the stand-in of ``_soundfile_standin.py``,
which goes through the port's numpy WAV code.

Tolerances: the separations are the float16 serving preset's, held as in
``test_torch_separation.py`` (1e-3 where the Hann envelope is at least
0.5, an SNR above 50 dB over the whole track), plus one PCM16 step
(1/32768 in, 1/32767 out) where a file was written and read back.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _soundfile_standin import standin
from tfswa_tpu.cli import separate as jcli
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.evaluation import inference as jinf
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.utils.torch_compat import torch_state_dict_to_variables
from tfswa_tpu_torch.cli import separate as pcli
from tfswa_tpu_torch.config import Config, EvalConfig, ModelConfig, STFTConfig
from tfswa_tpu_torch.data.wav import wav_info, wav_read, write_wav
from tfswa_tpu_torch.evaluation import inference as pinf
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import create_train_state
from tfswa_tpu_torch.training.checkpointing import CheckpointManager

SR = 8000
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
KNOBS = dict(segment_length=1.0, overlap=0.25, segment_batch=3, ola_bucket_seconds=3.0,
             stem_names=("vocals", "other"), transfer_dtype="float16", device_ola=True,
             freq_policy="crop_pow2")
PCM_OUT = 1.0 / 32767


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Six test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _audio(seconds, sr=SR, seed=0, channels=2):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    mono = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
    return (mono + 0.1 * rng.standard_normal((channels, n))).astype(np.float32)


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


@pytest.fixture(scope="module")
def pair():
    pm = TFSWAUNet(4, 4, attention_impl="xla", generator=torch.Generator().manual_seed(0),
                   **SMALL)
    variables = jax.tree_util.tree_map(
        jnp.asarray, torch_state_dict_to_variables(pm.state_dict(), SMALL["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **SMALL)
    js = jinf.SourceSeparator(jm, variables, JaxProcessor(JaxSTFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), **KNOBS)
    ps = pinf.SourceSeparator(pm, STFTProcessor(STFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), device="cpu", **KNOBS)
    return js, ps


def _small_config(**model):
    return Config(model=ModelConfig(in_channels=4, out_channels=4, **dict(SMALL, **model)))


def _trainer_dir(path, cfg):
    """The layout the training CLI writes: epoch_000000, latest, best,
    config.json (the weights are the seeded init's)."""
    model, state = create_train_state(cfg, device="cpu")
    CheckpointManager(str(path), config=cfg).save(state, 0, 1, 0.5, is_best=True)
    return model


def test_loader_serves_a_trainer_directory_as_the_pt_route(tmp_path):
    cfg = _small_config(attention_impl="pallas", dtype="bfloat16")
    model = _trainer_dir(tmp_path / "ck", cfg)
    stft = STFTConfig(n_fft=256, hop_length=64, sample_rate=SR)
    ev = EvalConfig.fast_serving(segment_seconds=1.0, ola_bucket_seconds=3.0)
    pt = pinf.load_separator_from_checkpoint(
        str(tmp_path / "ck" / "best" / "checkpoint.pt"), cfg.model, stft, ev, device="cpu")
    audio = _audio(2.6)
    want = pt.separate(audio)
    for path in (tmp_path / "ck", tmp_path / "ck" / "epoch_000000"):
        sep = pinf.load_separator_from_checkpoint(str(path), stft_config=stft, eval_config=ev,
                                                  device="cpu")
        assert (sep.model.attention_impl, sep.model.dtype) == ("pallas", torch.bfloat16)
        for k, v in model.state_dict().items():
            assert torch.equal(sep.model.state_dict()[k], v), k
        got = sep.separate(audio)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    os.remove(tmp_path / "ck" / "config.json")
    with pytest.raises(ValueError, match="model_config"):
        pinf.load_separator_from_checkpoint(str(tmp_path / "ck"), device="cpu")
    sep = pinf.load_separator_from_checkpoint(str(tmp_path / "ck"), cfg.model, stft, ev,
                                              device="cpu")
    np.testing.assert_array_equal(sep.separate(audio)["vocals"], want["vocals"])


def test_resample_poly_equals_jax():
    audio = _audio(1.3, sr=48000)
    got = pinf._resample_poly(audio, 48000, 44100)
    np.testing.assert_array_equal(got, jinf._resample_poly(audio, 48000, 44100))
    assert got.shape == (2, -(-audio.shape[1] * 147 // 160)) and got.dtype == np.float32


def test_separate_file_and_batch_separator_match_jax(pair, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", standin())
    js, ps = pair
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, _audio(3.3), SR)
    write_wav(b, _audio(2.2, sr=12000, seed=1), 12000)
    missing = str(tmp_path / "missing.wav")
    got = pinf.BatchSeparator(ps).separate_files([a, missing, b], str(tmp_path / "port"))
    ref = jinf.BatchSeparator(js).separate_files([a, missing, b], str(tmp_path / "jax"))
    assert [r["status"] for r in got.values()] == ["ok", "error", "ok"]
    assert [r["status"] for r in ref.values()] == ["ok", "error", "ok"]
    assert missing in got[missing]["error"]
    for path, frames in ((a, int(3.3 * SR)), (b, int(2.2 * SR))):
        assert got[path]["outputs"] == {
            s: str(tmp_path / "port" / f"{os.path.basename(path)[:-4]}_{s}.wav")
            for s in ("vocals", "other")}
        for stem, out in got[path]["outputs"].items():
            assert wav_info(out) == (frames, 1, SR)
            x = wav_read(out, 0, frames, 1)[0]
            y = wav_read(ref[path]["outputs"][stem], 0, frames, 1)[0]
            hop = ps.hop_samples
            np.testing.assert_allclose(x[hop // 3:], y[hop // 3:], atol=1e-3 + PCM_OUT, rtol=0)
            assert _snr_db(y, x) > 50.0


@pytest.mark.parametrize("argv", [
    [], ["--preset", "fast"], ["--preset", "fast", "--transfer_dtype", "int8"],
    ["--segment_batch", "4", "--device_ola", "--ola_bucket_seconds", "30",
     "--freq_policy", "crop_pow2", "--stft_precision", "high", "--segment_seconds", "6",
     "--overlap", "0.5", "--mask_mode", "mag_direct"]],
    ids=["parity", "fast", "fast-int8", "overrides"])
def test_eval_config_from_args_matches_jax(argv):
    import dataclasses

    def args_of(module):
        p = module.argparse.ArgumentParser()
        module.add_serving_args(p)
        for flag, default in (("--segment_seconds", 10.0), ("--overlap", 0.25),
                              ("--mask_mode", "trainer")):
            p.add_argument(flag, type=type(default), default=default)
        return p.parse_args(argv)

    got = pcli.eval_config_from_args(args_of(pcli))
    want = jcli.eval_config_from_args(args_of(jcli))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _cli_checkpoint(tmp_path):
    """A small checkpoint directory as the training CLI writes it: the
    plain f32 route, since the CLI runs at the default 44.1 kHz STFT."""
    _trainer_dir(tmp_path / "ck", _small_config())
    return str(tmp_path / "ck")


def _read(path):
    frames, channels, sr = wav_info(path)
    return wav_read(path, 0, frames, channels), sr


def test_separate_cli_streams_and_batches_on_the_cpu(tmp_path, capsys):
    ck = _cli_checkpoint(tmp_path)
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    write_wav(a, _audio(2.7, sr=44100), 44100)
    write_wav(b, _audio(1.4, sr=48000, seed=1), 48000)
    common = ["--checkpoint", ck, "--preset", "fast", "--segment_seconds", "1.0",
              "--ola_bucket_seconds", "3", "--device", "cpu", a, b]
    pcli.main(common + ["--stream", "-o", str(tmp_path / "stream")])
    assert capsys.readouterr().out.count(": ok {") == 2
    pcli.main(common + ["-o", str(tmp_path / "batch")])
    for path, frames in ((a, int(2.7 * 44100)), (b, -(-int(1.4 * 48000) * 147 // 160))):
        base = os.path.basename(path)[:-4]
        for stem in ("vocals", "other"):
            x, sr = _read(str(tmp_path / "stream" / f"{base}_{stem}.wav"))
            y, _ = _read(str(tmp_path / "batch" / f"{base}_{stem}.wav"))
            assert sr == 44100 and x.shape == y.shape == (1, frames)
            assert np.isfinite(x).all() and np.abs(x).max() > 0
            np.testing.assert_array_equal(x, y)


def test_separate_cli_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        pcli.main(["--checkpoint", str(tmp_path), str(tmp_path / "a.wav")])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)
    assert pcli.build_parser().parse_args(["--checkpoint", "c", "a.wav"]).device == "cuda"


def test_stream_files_matches_the_jax_cli(pair, tmp_path, monkeypatch, capsys):
    """``_stream_files`` (the --stream path) against the JAX CLI's, on the
    same separator weights and files."""
    monkeypatch.setitem(sys.modules, "soundfile", standin())
    js, ps = pair
    paths = [str(tmp_path / f"{n}.wav") for n in ("a", "b")]
    write_wav(paths[0], _audio(3.1), SR)
    write_wav(paths[1], _audio(1.9, sr=16000, seed=2), 16000)
    pcli._stream_files(ps, paths, str(tmp_path / "port"), 2)
    jcli._stream_files(js, paths, str(tmp_path / "jax"), 2)
    assert capsys.readouterr().out.count(": ok {") == 4
    for stem in ("vocals", "other"):
        for n in ("a", "b"):
            x, _ = _read(str(tmp_path / "port" / f"{n}_{stem}.wav"))
            y, _ = _read(str(tmp_path / "jax" / f"{n}_{stem}.wav"))
            assert x.shape == y.shape
            assert _snr_db(y, x) > 50.0
