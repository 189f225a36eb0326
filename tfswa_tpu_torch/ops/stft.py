"""STFT / iSTFT front end (counterpart of ``tfswa_tpu/ops/stft.py``).

The JAX package computes the transforms as framed matmuls against DFT bases;
here they are ``torch.stft`` / ``torch.istft`` with the same semantics
(center=True, reflect padding, periodic window, sum-of-squared-window
normalisation).  Both run in float32.  The JAX serving preset's
``precision="default"`` is a 1-pass bf16 DFT on a TPU; the port has no such
mode and always keeps float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import STFTConfig


def get_window(name: str, win_length: int) -> np.ndarray:
    """Periodic analysis window, as torch.*_window(periodic=True), float64."""
    n = np.arange(win_length, dtype=np.float64)
    if name == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if name == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    if name == "blackman":
        x = 2.0 * np.pi * n / win_length
        return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)
    raise ValueError(f"Unknown window function: {name}")


def _window(name: str, win_length: int, device) -> torch.Tensor:
    return torch.from_numpy(get_window(name, win_length).astype(np.float32)).to(device)


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: Optional[int] = None, window: str = "hann",
         center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Batched STFT.  (..., S) float -> (..., F, T) complex64."""
    win_length = win_length or n_fft
    lead = x.shape[:-1]
    spec = torch.stft(
        x.reshape(-1, x.shape[-1]).float(), n_fft=n_fft, hop_length=hop_length,
        win_length=win_length, window=_window(window, win_length, x.device),
        center=center, pad_mode=pad_mode, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
          win_length: Optional[int] = None, window: str = "hann",
          center: bool = True, length: Optional[int] = None) -> torch.Tensor:
    """Batched inverse STFT.  (..., F, T) complex -> (..., S) float32.
    With ``length`` the output is cut or zero-padded to it."""
    win_length = win_length or n_fft
    lead = spec.shape[:-2]
    out = torch.istft(
        spec.reshape(-1, *spec.shape[-2:]).to(torch.complex64), n_fft=n_fft,
        hop_length=hop_length, win_length=win_length,
        window=_window(window, win_length, spec.device), center=center)
    if length is not None:
        cur = out.shape[-1]
        out = out[..., :length] if cur >= length else \
            torch.nn.functional.pad(out, (0, length - cur))
    return out.reshape(*lead, out.shape[-1])


class STFTProcessor:
    """STFT front end with the JAX package's API surface."""

    def __init__(self, config: Optional[STFTConfig] = None, **kwargs):
        if config is None:
            config = STFTConfig(**kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = config
        self.n_fft = config.n_fft
        self.hop_length = config.hop_length
        self.win_length = config.win_length or config.n_fft
        self.window = config.window
        self.center = config.center
        self.pad_mode = config.pad_mode
        self.sample_rate = config.sample_rate

    def stft(self, waveform: torch.Tensor, return_magnitude_phase: bool = False):
        """(B, C, S) | (C, S) -> complex (B, C, F, T) | (C, F, T)."""
        spec = stft(waveform, self.n_fft, self.hop_length, self.win_length,
                    self.window, self.center, self.pad_mode)
        if return_magnitude_phase:
            return spec.abs(), spec.angle()
        return spec

    def istft(self, complex_spec: Optional[torch.Tensor] = None,
              magnitude: Optional[torch.Tensor] = None,
              phase: Optional[torch.Tensor] = None,
              length: Optional[int] = None) -> torch.Tensor:
        """Inverse of :meth:`stft`."""
        if complex_spec is None:
            if magnitude is None or phase is None:
                raise ValueError(
                    "Either complex_spec or (magnitude, phase) must be provided")
            complex_spec = torch.polar(magnitude, phase)
        return istft(complex_spec, self.n_fft, self.hop_length, self.win_length,
                     self.window, self.center, length)

    @staticmethod
    def to_model_input(complex_spec: torch.Tensor) -> torch.Tensor:
        """complex (B, C, F, T) -> real (B, 2C, F, T) as [re..., im...]."""
        return torch.cat([complex_spec.real, complex_spec.imag], dim=1)


class SpectrogramNormalizer:
    """Per-frequency-bin instance / global normalisation with the stats for
    denormalising (unbiased std)."""

    def __init__(self, mode: str = "instance", eps: float = 1e-8):
        if mode not in ("instance", "batch", "none"):
            raise ValueError(f"Unknown normalization mode: {mode}")
        self.mode = mode
        self.eps = eps

    def __call__(self, spec: torch.Tensor, return_stats: bool = False):
        if self.mode == "none":
            mean = torch.zeros_like(spec[..., :1])
            std = torch.ones_like(mean)
        elif self.mode == "instance":
            mean = spec.mean(dim=-1, keepdim=True)
            std = spec.std(dim=-1, keepdim=True, correction=1) + self.eps
        else:
            mean = spec.mean()
            std = spec.std(correction=1) + self.eps
        normed = (spec - mean) / std
        return (normed, mean, std) if return_stats else normed

    @staticmethod
    def denormalize(normalized_spec: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
        return normalized_spec * std + mean
