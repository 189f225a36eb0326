"""Waveform and spectrogram augmentation on the batch's device (counterpart
of ``tfswa_tpu/data/augment.py``).

The transforms are torch on the tensors' device and keep the segment
length: time stretch and pitch shift resample within it.  Pitch shift is a
phase vocoder and a resample, as torchaudio's ``PitchShift``.  The random
draws (whether a transform applies, its rate, semitones or gain, mixup's
Beta lambda, the mask positions) are a few scalars a batch and come from a
host ``numpy.random.Generator`` the caller passes, so a seed fixes them;
a transform that is not drawn is not computed.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DataConfig
from ..ops.stft import STFTProcessor


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _linear_resample_positions(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Sample x (..., S) at fractional positions (N,) f32; zeros outside."""
    S = x.shape[-1]
    idx0 = torch.clamp(torch.floor(positions).long(), 0, S - 1)
    idx1 = torch.clamp(idx0 + 1, 0, S - 1)
    frac = positions - idx0.float()
    y = x[..., idx0] * (1 - frac) + x[..., idx1] * frac
    valid = (positions >= 0) & (positions <= S - 1)
    return torch.where(valid, y, torch.zeros((), dtype=y.dtype, device=y.device))


def time_stretch(x: torch.Tensor, rate: float) -> torch.Tensor:
    """Linear-interpolation time stretch of (..., S), length kept: sample i
    reads position i * rate, zero past the end."""
    S = x.shape[-1]
    positions = torch.arange(S, dtype=torch.float32, device=x.device) * _f32(rate, x)
    return _linear_resample_positions(x, positions)


def gain(x: torch.Tensor, gain_db: float) -> torch.Tensor:
    """Volume gain in dB."""
    return x * (10.0 ** (gain_db / 20.0))


def phase_vocoder(spec: torch.Tensor, rate: float, hop_length: int,
                  out_frames: Optional[int] = None) -> torch.Tensor:
    """Phase-vocoder time stretch of a complex (..., F, T) spectrogram to
    ``out_frames`` frames (default T): output frame t reads input position
    t * rate, magnitudes interpolated, phase advances accumulated."""
    F_, T = spec.shape[-2:]
    if out_frames is None:
        out_frames = T
    dev = spec.device
    n_fft = 2 * (F_ - 1)
    phi_advance = (2.0 * math.pi * hop_length
                   * torch.arange(F_, dtype=torch.float32, device=dev) / n_fft)[:, None]
    steps = torch.arange(out_frames, dtype=torch.float32, device=dev) * _f32(rate, spec.real)
    idx0 = torch.clamp(torch.floor(steps).long(), 0, T - 1)
    idx1 = torch.clamp(idx0 + 1, 0, T - 1)
    frac = steps - idx0.float()
    s0, s1 = spec[..., idx0], spec[..., idx1]
    mag = s0.abs() * (1 - frac) + s1.abs() * frac
    mag = torch.where(steps < T, mag, torch.zeros((), device=dev))
    dphase = s1.angle() - s0.angle() - phi_advance
    dphase = dphase - 2.0 * math.pi * torch.round(dphase / (2.0 * math.pi))
    dphase = dphase + phi_advance
    phase = s0[..., :1].angle() + torch.cat(
        [torch.zeros_like(dphase[..., :1]), torch.cumsum(dphase[..., :-1], dim=-1)], dim=-1)
    return torch.polar(mag, phase)


def pitch_shift(x: torch.Tensor, semitones: float, stft: STFTProcessor) -> torch.Tensor:
    """Pitch shift of (..., S) by fractional semitones at constant duration:
    phase vocoder at rate 2^(-s/12) into 2T frames (room for shifts up to
    +12 semitones), then resampling by 2^(s/12)."""
    S = x.shape[-1]
    rate = 2.0 ** (-semitones / 12.0)
    spec = stft.stft(x)
    T = spec.shape[-1]
    stretched = phase_vocoder(spec, rate, stft.hop_length, out_frames=2 * T)
    wav = stft.istft(stretched, length=2 * S)
    positions = torch.arange(S, dtype=torch.float32, device=x.device) * _f32(1.0 / rate, x)
    return _linear_resample_positions(wav, positions)


def _band(length: int, rng: np.random.Generator, max_width: int) -> Tuple[int, int]:
    """(start, width): width uniform in [0, max_width], start uniform in
    [0, max(length - width, 1))."""
    width = int(rng.integers(0, max_width + 1))
    return int(rng.integers(0, max(length - width, 1))), width


def _masked(spec: torch.Tensor, axis: int, start: torch.Tensor,
            width: torch.Tensor) -> torch.Tensor:
    """Zero positions [start, start + width) of ``axis`` (-2 or -1) of
    (B, ..., F, T), with per-item (B,) start and width."""
    n = spec.shape[axis]
    pos = torch.arange(n, device=spec.device)
    band = (pos >= start[:, None]) & (pos < (start + width)[:, None])     # (B, n)
    shape = [spec.shape[0]] + [1] * (spec.dim() - 1)
    shape[axis] = n
    return spec.masked_fill(band.reshape(shape), 0.0)


def frequency_masking(spec: torch.Tensor, rng: np.random.Generator,
                      max_width: int = 30) -> torch.Tensor:
    """Zero one random band of frequency rows of a (..., F, T) spectrogram."""
    start, width = _band(spec.shape[-2], rng, max_width)
    return _masked(spec[None], -2, *(torch.tensor([v], device=spec.device)
                                     for v in (start, width)))[0]


def time_masking(spec: torch.Tensor, rng: np.random.Generator,
                 max_width: int = 40) -> torch.Tensor:
    """Zero one random band of time frames of a (..., F, T) spectrogram."""
    start, width = _band(spec.shape[-1], rng, max_width)
    return _masked(spec[None], -1, *(torch.tensor([v], device=spec.device)
                                     for v in (start, width)))[0]


class AudioAugmentation:
    """Time stretch, pitch shift and gain, each with probability ``prob``,
    the same transform on the mixture and on every stem, so that mixture =
    sum(stems) still holds."""

    def __init__(self, stft: STFTProcessor,
                 time_stretch_range: Tuple[float, float] = (0.9, 1.1),
                 pitch_shift_range: Tuple[float, float] = (-2.0, 2.0),
                 gain_range_db: Tuple[float, float] = (-6.0, 6.0),
                 prob: float = 0.5, use_pitch_shift: bool = True):
        self.stft = stft
        self.time_stretch_range = time_stretch_range
        self.pitch_shift_range = pitch_shift_range
        self.gain_range_db = gain_range_db
        self.prob = prob
        self.use_pitch_shift = use_pitch_shift

    def __call__(self, rng: np.random.Generator, mixture: torch.Tensor,
                 targets: Dict[str, torch.Tensor]):
        """mixture (B, C, S), targets {stem: (B, C, S)} -> augmented pair.
        Draws, in order: stretch on?, rate, pitch on?, semitones, gain on?,
        gain (the pitch pair only with ``use_pitch_shift``)."""
        stack = torch.stack([mixture, *targets.values()], dim=1)    # (B, 1+n, C, S)
        do, rate = rng.random() < self.prob, float(rng.uniform(*self.time_stretch_range))
        if do:
            stack = time_stretch(stack, rate)
        if self.use_pitch_shift:
            do, semi = rng.random() < self.prob, float(rng.uniform(*self.pitch_shift_range))
            if do:
                stack = pitch_shift(stack, semi, self.stft)
        do, g = rng.random() < self.prob, float(rng.uniform(*self.gain_range_db))
        if do:
            stack = gain(stack, g)
        return stack[:, 0], {k: stack[:, i + 1] for i, k in enumerate(targets)}


class MixupAugmentation:
    """lambda ~ Beta(alpha, alpha) convex mix of a batch with its roll by
    one item, with probability ``prob``."""

    def __init__(self, alpha: float = 0.4, prob: float = 0.5):
        self.alpha = alpha
        self.prob = prob

    def __call__(self, rng: np.random.Generator, mixture: torch.Tensor,
                 targets: Dict[str, torch.Tensor]):
        """Draws lambda, then whether to mix."""
        lam = float(rng.beta(self.alpha, self.alpha))
        if not rng.random() < self.prob:
            return mixture, targets

        def mix(x):
            return lam * x + (1 - lam) * torch.roll(x, 1, dims=0)

        return mix(mixture), {k: mix(v) for k, v in targets.items()}


class SpectrogramAugmentation:
    """Per-item frequency and time masks on the model-input spectrogram,
    each with probability ``prob``, the same across channels.  The targets
    stay clean (SpecAugment-style regularisation)."""

    def __init__(self, freq_mask_param: int = 30, time_mask_param: int = 40,
                 prob: float = 0.5):
        self.freq_mask_param = freq_mask_param
        self.time_mask_param = time_mask_param
        self.prob = prob

    def __call__(self, rng: np.random.Generator, spec: torch.Tensor) -> torch.Tensor:
        """spec (B, C, F, T).  Draws per item, in order: frequency mask on?,
        its band, time mask on?, its band; a mask that is off has width 0."""
        F_, T = spec.shape[-2:]
        bands = np.zeros((spec.shape[0], 4), np.int64)   # f start, f width, t start, t width
        for b in range(spec.shape[0]):
            for j, (n, param) in enumerate(((F_, self.freq_mask_param),
                                            (T, self.time_mask_param))):
                on = rng.random() < self.prob
                start, width = _band(n, rng, param)
                bands[b, 2 * j:2 * j + 2] = (start, width if on else 0)
        bands = torch.from_numpy(bands).to(spec.device)
        spec = _masked(spec, -2, bands[:, 0], bands[:, 1])
        return _masked(spec, -1, bands[:, 2], bands[:, 3])


def build_augmentations(cfg: DataConfig, stft: STFTProcessor):
    """(waveform bundle, mixup, spec augment) from the config, None where off."""
    audio_aug = AudioAugmentation(
        stft, time_stretch_range=cfg.aug_time_stretch,
        pitch_shift_range=cfg.aug_pitch_shift_semitones,
        gain_range_db=cfg.aug_gain_db, prob=cfg.aug_prob) if cfg.augment else None
    mixup = MixupAugmentation(cfg.mixup_alpha) if cfg.mixup else None
    spec_aug = SpectrogramAugmentation(
        freq_mask_param=cfg.aug_freq_mask_param, time_mask_param=cfg.aug_time_mask_param,
        prob=cfg.aug_prob) if cfg.spec_augment else None
    return audio_aug, mixup, spec_aug
