"""The port's SourceSeparator against the JAX package's, on the CPU, at a
small STFT (8 kHz, n_fft 256, hop 64) and a small model, same weights.

The JAX model runs its plain ("xla") route; the port runs "pallas", which
on a CPU tensor is the plain version of the CUDA kernel.  The kernel's
equivalence to the Pallas kernel is tested in test_torch_fused_block.py and
test_torch_modules.py.

Tolerances:
  - float32 transfers: the whole path in f32 with sums in another order
    (FFT vs DFT matmul, convs, attention); audio is O(0.3), atol 1e-4.
  - float16 transfers (the serving preset): the per-window accumulation
    crosses to the host in float16 on both sides, and an f32 difference of
    1e-6 can flip one f16 rounding (2^-11 relative).  Where the Hann
    envelope is >= 0.5 that bounds the error by ~1e-3; at the track's first
    samples the envelope goes to 0 and the division magnifies the flip, so
    those samples are held to an SNR instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.utils.torch_compat import torch_state_dict_to_variables
from tfswa_tpu_torch.config import STFTConfig
from tfswa_tpu_torch.evaluation import SourceSeparator
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor

SR = 8000
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4,
             shift_size=2, num_heads=2)
KNOBS = dict(segment_length=1.0, overlap=0.25, segment_batch=3,
             ola_bucket_seconds=3.0, stem_names=("vocals", "other"))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound separations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _audio(seconds, seed=0):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """The port's seeded init carried into JAX variables through the JAX
    package's reference-state_dict converter (no JAX init trace needed)."""
    pm = TFSWAUNet(4, 4, attention_impl="pallas",
                   generator=torch.Generator().manual_seed(0), **SMALL)
    variables = torch_state_dict_to_variables(pm.state_dict(), SMALL["depths"])
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **SMALL)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), pm


def _pair(models, **knobs):
    jm, variables, pm = models
    kw = dict(KNOBS, **knobs)
    js = JaxSeparator(jm, variables, JaxProcessor(JaxSTFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), **kw)
    ps = SourceSeparator(pm, STFTProcessor(STFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), device="cpu", **kw)
    return js, ps


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


def test_device_ola_crop_pow2_float16_matches_jax(models):
    js, ps = _pair(models, transfer_dtype="float16", device_ola=True,
                   freq_policy="crop_pow2")
    assert ps.ola_window_segments == js.ola_window_segments == 4
    audio = _audio(5.3)
    ref, out = js.separate(audio), ps.separate(audio)
    hop = ps.hop_samples
    for name in ("vocals", "other"):
        assert out[name].shape == ref[name].shape == (1, audio.size)
        assert np.isfinite(out[name]).all()
        # the envelope is >= 0.5 from a quarter segment on
        np.testing.assert_allclose(out[name][:, hop // 3:], ref[name][:, hop // 3:],
                                   atol=1e-3, rtol=0)
        assert _snr_db(ref[name], out[name]) > 50.0


def test_host_ola_float32_matches_jax(models):
    js, ps = _pair(models, transfer_dtype="float32", device_ola=False)
    audio = _audio(3.7, seed=1)
    ref, out = js.separate(audio), ps.separate(audio)
    for name in ("vocals", "other"):
        assert out[name].shape == ref[name].shape
        np.testing.assert_allclose(out[name], ref[name], atol=1e-4, rtol=0)


def test_single_segment_branch_matches_jax(models):
    js, ps = _pair(models, transfer_dtype="float32", device_ola=True,
                   freq_policy="crop_pow2")
    audio = _audio(0.7, seed=2)
    ref, out = js.separate(audio), ps.separate(audio)
    for name in ("vocals", "other"):
        np.testing.assert_allclose(out[name], ref[name], atol=1e-4, rtol=0)


def test_stereo_input_is_forced_mono(models):
    _, ps = _pair(models, transfer_dtype="float32")
    a = _audio(0.5, seed=3)
    np.testing.assert_array_equal(ps.separate(np.stack([a, a]))["vocals"],
                                  ps.separate(a)["vocals"])


def test_unknown_transfer_codec_raises(models):
    with pytest.raises(ValueError, match="bfloat16"):
        SourceSeparator(models[2], STFTProcessor(STFTConfig(n_fft=256, hop_length=64)),
                        transfer_dtype="bfloat16", device="cpu")


def test_int8_output_codec_matches_jax_and_float32(models):
    """The int8 codec against JAX's int8 codec: within one int8 step of the
    stem's peak (a rounding that the route's f32 differences flip) plus
    the float16 route tolerance above (1e-3: the input rides float16).
    Against the port's own float32 transfers: within one int8 step of the
    peak, the codec's error (the half step of its rounding, in units of
    each window's peak of acc / env)."""
    js, ps = _pair(models, transfer_dtype="int8", device_ola=True, freq_policy="crop_pow2")
    assert ps.int8_output and ps.transfer_dtype == np.float16
    audio = _audio(5.3)
    ref, out = js.separate(audio), ps.separate(audio)
    _, p32 = _pair(models, transfer_dtype="float32", device_ola=True, freq_policy="crop_pow2")
    exact = p32.separate(audio)
    for name in ("vocals", "other"):
        step = np.abs(ref[name]).max() / 127
        assert out[name].shape == ref[name].shape == (1, audio.size)
        np.testing.assert_allclose(out[name], ref[name], atol=step + 1e-3, rtol=0)
        assert np.abs(out[name] - exact[name]).max() <= np.abs(exact[name]).max() / 127


@pytest.mark.parametrize("device_ola", [True, False])
def test_separate_stream_equals_separate_and_matches_jax(models, device_ola):
    """separate_stream with two tracks in flight: each result equal to the
    port's own separate() bit for bit, and to JAX's separate_stream within
    the float16 tolerance above (the first samples, where the envelope
    goes to 0, by SNR).  The 0.6 s track (one segment or less) and, with
    device_ola off, every track take the sequential branch."""
    js, ps = _pair(models, transfer_dtype="float16", device_ola=device_ola,
                   freq_policy="crop_pow2")
    tracks = [_audio(5.3), _audio(2.1, seed=1), _audio(0.6, seed=2), _audio(3.3, seed=3)]
    outs = ps.separate_stream(tracks, max_in_flight=2)
    refs = js.separate_stream(tracks, max_in_flight=2)
    hop = ps.hop_samples
    for audio, out, ref in zip(tracks, outs, refs):
        alone = ps.separate(audio)
        for name in ("vocals", "other"):
            np.testing.assert_array_equal(out[name], alone[name])
            assert out[name].shape == ref[name].shape == (1, audio.size)
            np.testing.assert_allclose(out[name][:, hop // 3:], ref[name][:, hop // 3:],
                                       atol=1e-3, rtol=0)
            assert _snr_db(ref[name], out[name]) > 50.0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py never runs on the CPU: with no CUDA device it exits
    non-zero and prints no result, in the checkout and alone in a directory."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(script, alone)
    for path in (script, alone):
        res = subprocess.run([sys.executable, str(path)], capture_output=True,
                             text=True, timeout=120, cwd=path.parent)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_load_separator_from_pt_checkpoint_honours_eval_knobs(models, tmp_path):
    """A reference-named .pt loads into the port; the EvalConfig knobs reach
    the separator, which then separates as one built by hand."""
    from tfswa_tpu_torch.config import EvalConfig, ModelConfig
    from tfswa_tpu_torch.evaluation import load_separator_from_checkpoint

    pm = models[2]
    path = tmp_path / "model.pt"
    torch.save({"model_state_dict": pm.state_dict()}, path)
    cfg = ModelConfig(in_channels=4, out_channels=4, attention_impl="pallas",
                      **SMALL)
    ev = EvalConfig.fast_serving(segment_seconds=1.0, segment_batch=3,
                                 ola_bucket_seconds=3.0)
    sep = load_separator_from_checkpoint(
        str(path), cfg, STFTConfig(n_fft=256, hop_length=64, sample_rate=SR), ev,
        device="cpu")
    assert (sep.device_ola, sep.freq_policy, sep.transfer_dtype.name) == \
        (True, "crop_pow2", "float16")
    _, ps = _pair(models, transfer_dtype="float16", device_ola=True,
                  freq_policy="crop_pow2")
    audio = _audio(3.1, seed=4)
    a, b = sep.separate(audio), ps.separate(audio)
    for name in ("vocals", "other"):
        np.testing.assert_array_equal(a[name], b[name])
