"""Separation losses (counterpart of ``tfswa_tpu/training/losses.py``).

All losses run in float32 whatever the model's compute dtype, with the
reference's NaN/Inf guard: an invalid loss contributes 0 instead of
poisoning training.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.stft import stft


def _guard(loss: torch.Tensor) -> torch.Tensor:
    """Invalid (NaN/Inf) -> 0.0."""
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def l1_spectrogram_loss(pred_spec: torch.Tensor, target_spec: torch.Tensor) -> torch.Tensor:
    """L1 on magnitudes; complex inputs are abs()'d first."""
    if pred_spec.is_complex():
        pred_spec = pred_spec.abs()
    if target_spec.is_complex():
        target_spec = target_spec.abs()
    return _guard((pred_spec.float() - target_spec.float()).abs().mean())


def multi_resolution_stft_loss(pred_audio: torch.Tensor, target_audio: torch.Tensor,
                               fft_sizes: Sequence[int] = (2048, 1024, 512),
                               hop_sizes: Sequence[int] = (512, 256, 128),
                               win_lengths: Sequence[int] = (2048, 1024, 512),
                               magnitude_weight: float = 1.0,
                               log_magnitude_weight: float = 1.0,
                               eps: float = 1e-5) -> torch.Tensor:
    """L1 on the magnitudes plus L1 on the log-magnitudes at each STFT
    resolution, averaged over the resolutions.  (B, C, S) audio has its
    channels folded into the batch; (B, S) is taken as it is."""
    if pred_audio.dim() == 3:
        pred_audio = pred_audio.reshape(-1, pred_audio.shape[-1])
        target_audio = target_audio.reshape(-1, target_audio.shape[-1])
    total = 0.0
    for n_fft, hop, win in zip(fft_sizes, hop_sizes, win_lengths):
        pred_mag = stft(pred_audio, n_fft=n_fft, hop_length=hop, win_length=win).abs()
        target_mag = stft(target_audio, n_fft=n_fft, hop_length=hop, win_length=win).abs()
        if magnitude_weight > 0:
            total = total + magnitude_weight * (pred_mag - target_mag).abs().mean()
        if log_magnitude_weight > 0:
            total = total + log_magnitude_weight * (
                torch.log(pred_mag + eps) - torch.log(target_mag + eps)).abs().mean()
    return _guard(total / len(fft_sizes))


class PerceptualLoss:
    """A stub with the JAX package's API: the reference declares the class
    and leaves it unimplemented, so calling it raises."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            "PerceptualLoss is a declared-but-unimplemented capability in the "
            "reference as well (reference: losses.py:296-297)")


def source_separation_loss(pred_specs: Dict[str, torch.Tensor],
                           target_specs: Dict[str, torch.Tensor],
                           pred_audios: Optional[Dict[str, torch.Tensor]] = None,
                           target_audios: Optional[Dict[str, torch.Tensor]] = None,
                           l1_weight: float = 1.0, mrstft_weight: float = 0.5,
                           use_mrstft: bool = False) -> Dict[str, torch.Tensor]:
    """Combined per-stem loss dict: {'total_loss', 'l1_loss', 'l1_<stem>'}
    and, with ``use_mrstft``, {'mrstft_loss', 'mrstft_<stem>'} on the
    stems' audio; per-stem losses are averaged over the stems."""
    out: Dict[str, torch.Tensor] = {}
    stems = list(pred_specs)
    l1_total = 0.0
    for stem in stems:
        l1 = l1_spectrogram_loss(pred_specs[stem], target_specs[stem])
        out[f"l1_{stem}"] = l1
        l1_total = l1_total + l1
    l1_total = l1_total / len(stems)
    out["l1_loss"] = l1_total
    total = l1_weight * l1_total
    if use_mrstft:
        if pred_audios is None or target_audios is None:
            raise ValueError("use_mrstft requires pred/target audios")
        mr_total = 0.0
        for stem in stems:
            mr = multi_resolution_stft_loss(pred_audios[stem], target_audios[stem])
            out[f"mrstft_{stem}"] = mr
            mr_total = mr_total + mr
        mr_total = mr_total / len(stems)
        out["mrstft_loss"] = mr_total
        total = total + mrstft_weight * mr_total
    out["total_loss"] = total
    return out
