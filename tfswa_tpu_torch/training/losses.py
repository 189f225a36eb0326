"""Separation losses (counterpart of ``tfswa_tpu/training/losses.py``).

All losses run in float32 whatever the model's compute dtype, with the
reference's NaN/Inf guard: an invalid loss contributes 0 instead of
poisoning training.  The multi-resolution STFT loss is not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch


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


def source_separation_loss(pred_specs: Dict[str, torch.Tensor],
                           target_specs: Dict[str, torch.Tensor],
                           l1_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """Combined per-stem loss dict: {'total_loss', 'l1_loss', 'l1_<stem>'},
    per-stem losses averaged over stems (the JAX function without its
    MR-STFT terms)."""
    out: Dict[str, torch.Tensor] = {}
    l1_total = 0.0
    for stem in pred_specs:
        l1 = l1_spectrogram_loss(pred_specs[stem], target_specs[stem])
        out[f"l1_{stem}"] = l1
        l1_total = l1_total + l1
    l1_total = l1_total / len(pred_specs)
    out["l1_loss"] = l1_total
    out["total_loss"] = l1_weight * l1_total
    return out
