"""The port's augmentation against the JAX package's at fixed draws (8 kHz,
n_fft 256, hop 64, a batch of (2, 3, 2, 4000) signals):
  - ``time_stretch`` and ``gain``: within 1e-4 of max|x| (both compute the
    same f32 products; they agree exactly here);
  - ``phase_vocoder`` and ``pitch_shift``: within 1e-4 of max|x| plus two
    f32 spacings of the accumulated phase times max|x|.  The phase is a
    running sum over up to 2T frames of advances up to pi * hop (about
    2.6e4 rad here, where f32 holds 2e-3 rad), summed in another order by
    XLA than by torch, so the two packages differ by about one such
    spacing (measured 1.1e-3 of max|spec| for the vocoder, 1.9e-4 of
    max|x| after the pitch shift's iSTFT and resample);
  - mixup at a fixed lambda (the JAX Beta and Bernoulli draws fixed the
    same way): within 1e-6 of max|x|.
The random parts are held to their contracts: a mask is one contiguous
band at most ``param`` wide, the same on every channel; the same generator
seed gives the same draws; a transform drawn off is not applied.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.data import augment as jaug
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu_torch.config import DataConfig, STFTConfig
from tfswa_tpu_torch.data import augment as paug
from tfswa_tpu_torch.ops.stft import STFTProcessor

SR, N_FFT, HOP = 8000, 256, 64
JP = JaxProcessor(JaxSTFTConfig(n_fft=N_FFT, hop_length=HOP, sample_rate=SR))
PP = STFTProcessor(STFTConfig(n_fft=N_FFT, hop_length=HOP, sample_rate=SR))


@pytest.fixture(scope="module")
def x():
    return (np.random.default_rng(0).standard_normal((2, 3, 2, 4000)) * 0.3).astype(np.float32)


def _phase_atol(out_frames: int, scale: float) -> float:
    """1e-4 of ``scale`` plus two f32 spacings at the largest accumulated
    phase (out_frames advances of at most pi * hop + pi), times ``scale``."""
    top = out_frames * (math.pi * HOP + math.pi) + math.pi
    spacing = 2.0 ** (math.floor(math.log2(top)) - 23)
    return (1e-4 + 2 * spacing) * scale


@pytest.mark.parametrize("rate", [0.9, 1.0, 1.07, 1.1])
def test_time_stretch_matches_jax(x, rate):
    got = paug.time_stretch(torch.from_numpy(x), rate).numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.time_stretch(jnp.asarray(x), rate)),
                               atol=1e-4 * np.abs(x).max(), rtol=0)


@pytest.mark.parametrize("db", [-6.0, 0.0, 2.5])
def test_gain_matches_jax(x, db):
    got = paug.gain(torch.from_numpy(x), db).numpy()
    np.testing.assert_allclose(got, np.asarray(jaug.gain(jnp.asarray(x), db)),
                               atol=1e-4 * np.abs(x).max(), rtol=0)


@pytest.mark.parametrize("rate,out_frames", [(0.8, None), (1.2, None), (0.85, 126)])
def test_phase_vocoder_matches_jax(x, rate, out_frames):
    spec = np.asarray(JP.stft(jnp.asarray(x)))
    want = np.asarray(jaug.phase_vocoder(jnp.asarray(spec), rate, HOP, out_frames))
    got = paug.phase_vocoder(torch.from_numpy(spec.copy()), rate, HOP, out_frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_phase_atol(want.shape[-1], np.abs(spec).max()))


@pytest.mark.parametrize("semitones", [-2.0, 0.7, 2.0])
def test_pitch_shift_matches_jax(x, semitones):
    want = np.asarray(jaug.pitch_shift(jnp.asarray(x), semitones, JP))
    got = paug.pitch_shift(torch.from_numpy(x), semitones, PP).numpy()
    frames = 2 * (x.shape[-1] // HOP + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=_phase_atol(frames, np.abs(x).max()))


def test_mixup_at_a_fixed_lambda_matches_jax(x, monkeypatch):
    lam = 0.3
    monkeypatch.setattr(jax.random, "beta", lambda key, a, b: jnp.float32(lam))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p: jnp.bool_(True))
    mix, tg = x[:, 0], {"vocals": x[:, 1], "other": x[:, 2]}
    wm, wt = jaug.MixupAugmentation(0.4)(jax.random.PRNGKey(0), jnp.asarray(mix),
                                         {k: jnp.asarray(v) for k, v in tg.items()})

    class Fixed:
        def beta(self, a, b):
            return lam

        def random(self):
            return 0.0

    gm, gt = paug.MixupAugmentation(0.4)(Fixed(), torch.from_numpy(mix),
                                         {k: torch.from_numpy(v) for k, v in tg.items()})
    tol = 1e-6 * np.abs(x).max()
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=tol, rtol=0)
    for k in tg:
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(wt[k]), atol=tol, rtol=0)


def test_mixup_drawn_off_is_the_identity(x):
    class Off:
        def beta(self, a, b):
            return 0.3

        def random(self):
            return 0.9

    m = torch.from_numpy(x[:, 0])
    gm, gt = paug.MixupAugmentation(0.4, prob=0.5)(Off(), m, {"vocals": m})
    assert gm is m and gt["vocals"] is m


@pytest.mark.parametrize("seed", range(4))
def test_spec_augment_masks_are_contiguous_bands_shared_across_channels(seed):
    B, C, F_, T = 6, 4, 129, 40
    spec = torch.rand(B, C, F_, T, generator=torch.Generator().manual_seed(seed)) + 0.5
    aug = paug.SpectrogramAugmentation(freq_mask_param=30, time_mask_param=10, prob=0.7)
    out = aug(np.random.default_rng(seed), spec).numpy()
    zero = out == 0
    for b in range(B):
        assert (zero[b] == zero[b, :1]).all()                    # the same on every channel
        rows = np.nonzero(zero[b, 0].all(axis=1))[0]
        cols = np.nonzero(zero[b, 0].all(axis=0))[0]
        for band, param in ((rows, 30), (cols, 10)):
            assert len(band) <= param
            if len(band):
                assert band[-1] - band[0] + 1 == len(band)       # contiguous
        expect = np.zeros((F_, T), bool)
        expect[rows, :] = True
        expect[:, cols] = True
        assert (zero[b, 0] == expect).all()                      # nothing else zeroed
    again = aug(np.random.default_rng(seed), spec).numpy()
    np.testing.assert_array_equal(out, again)                    # same seed, same draws


def test_spec_augment_draw_order_and_probability():
    aug = paug.SpectrogramAugmentation(freq_mask_param=5, time_mask_param=3, prob=0.5)
    spec = torch.ones(3, 2, 20, 9)
    out = aug(np.random.default_rng(11), spec).numpy()
    rng = np.random.default_rng(11)
    for b in range(3):
        for axis, n, param in ((0, 20, 5), (1, 9, 3)):
            on = rng.random() < 0.5
            width = int(rng.integers(0, param + 1))
            start = int(rng.integers(0, max(n - width, 1)))
            zero = (out[b, 0] == 0).all(axis=1 - axis)
            want = np.zeros(n, bool)
            if on:
                want[start:start + width] = True
            assert (zero == want).all()


def test_frequency_and_time_masking_single_band():
    spec = torch.ones(2, 30, 12)
    f = paug.frequency_masking(spec, np.random.default_rng(1), 6).numpy()
    t = paug.time_masking(spec, np.random.default_rng(1), 4).numpy()
    rows, cols = np.nonzero((f == 0).all(axis=(0, 2)))[0], np.nonzero((t == 0).all(axis=(0, 1)))[0]
    rng = np.random.default_rng(1)
    w = int(rng.integers(0, 7))
    s = int(rng.integers(0, max(30 - w, 1)))
    assert list(rows) == list(range(s, s + w))
    assert len(cols) <= 4 and (f != 0).sum() == 2 * 12 * (30 - w)


def test_audio_augmentation_applies_the_drawn_transforms(x):
    mix, tg = torch.from_numpy(x[:, 0]), {"vocals": torch.from_numpy(x[:, 1]),
                                          "other": torch.from_numpy(x[:, 2])}
    aug = paug.AudioAugmentation(PP, prob=1.0)
    gm, gt = aug(np.random.default_rng(5), mix, tg)
    rng = np.random.default_rng(5)
    rng.random()
    rate = rng.uniform(0.9, 1.1)
    rng.random()
    semi = rng.uniform(-2.0, 2.0)
    rng.random()
    g = rng.uniform(-6.0, 6.0)
    stack = torch.stack([mix, tg["vocals"], tg["other"]], dim=1)
    want = paug.gain(paug.pitch_shift(paug.time_stretch(stack, rate), semi, PP), g)
    torch.testing.assert_close(gm, want[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(gt["other"], want[:, 2], rtol=0, atol=0)
    off_m, off_t = paug.AudioAugmentation(PP, prob=0.0)(np.random.default_rng(5), mix, tg)
    torch.testing.assert_close(off_m, mix, rtol=0, atol=0)


def test_stretch_and_gain_keep_mixture_the_sum_of_the_stems(x):
    """Stretch and gain are linear, so a mixture that is the sum of its stems
    stays so (the phase vocoder is not linear)."""
    tg = {"vocals": torch.from_numpy(x[:, 1]), "other": torch.from_numpy(x[:, 2])}
    aug = paug.AudioAugmentation(PP, prob=1.0, use_pitch_shift=False)
    gm, gt = aug(np.random.default_rng(2), tg["vocals"] + tg["other"], tg)
    torch.testing.assert_close(gm, gt["vocals"] + gt["other"], rtol=0, atol=1e-6)


def test_build_augmentations_follows_the_config():
    a, m, s = paug.build_augmentations(DataConfig(), PP)
    assert a is m is s is None
    a, m, s = paug.build_augmentations(
        DataConfig(augment=True, mixup=True, spec_augment=True, aug_prob=0.25,
                   aug_gain_db=(-1.0, 1.0), mixup_alpha=0.2, aug_time_mask_param=7), PP)
    assert (a.prob, a.gain_range_db, m.alpha, m.prob, s.prob, s.time_mask_param) == \
        (0.25, (-1.0, 1.0), 0.2, 0.5, 0.25, 7)
