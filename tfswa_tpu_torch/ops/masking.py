"""Mask conventions (counterpart of ``tfswa_tpu/ops/masking.py``).

"trainer": per-stem channel pair -> sigmoid(sqrt(re^2 + im^2 + 1e-8)) on the
mono mixture magnitude, with the mixture phase (the convention the model is
trained under).  "direct": raw head channels 0..n_stems-1 as masks.
"""
from __future__ import annotations

import torch


def trainer_magnitude_masks(model_output: torch.Tensor, n_stems: int) -> torch.Tensor:
    """(B, 2*n_stems, F, T) head output -> (B, n_stems, F, T) magnitude masks."""
    B, C, F, T = model_output.shape
    if C != 2 * n_stems:
        raise ValueError(f"expected {2 * n_stems} channels, got {C}")
    pairs = model_output.reshape(B, n_stems, 2, F, T)
    return torch.sigmoid(torch.sqrt(pairs[:, :, 0] ** 2 + pairs[:, :, 1] ** 2 + 1e-8))


def apply_trainer_masks(model_output: torch.Tensor, mixture_mag_mono: torch.Tensor,
                        n_stems: int) -> torch.Tensor:
    """-> (B, n_stems, F, T) predicted mono magnitudes."""
    return trainer_magnitude_masks(model_output, n_stems) * mixture_mag_mono[:, None]


def trainer_masked_complex(model_output: torch.Tensor, mixture_mag_mono: torch.Tensor,
                           mixture_phase_mono: torch.Tensor, n_stems: int) -> torch.Tensor:
    """-> (B, n_stems, F, T) complex: masked mono magnitude, mixture phase."""
    pred_mags = apply_trainer_masks(model_output, mixture_mag_mono, n_stems)
    return torch.polar(pred_mags, mixture_phase_mono[:, None].expand_as(pred_mags))


def direct_masks(model_output: torch.Tensor, n_stems: int) -> torch.Tensor:
    """First n_stems head channels used directly as real-valued masks."""
    return model_output[:, :n_stems]


def apply_magnitude_masks(model_output: torch.Tensor, mixture_mag_mono: torch.Tensor,
                          n_stems: int, convention: str = "parity") -> torch.Tensor:
    """-> (B, n_stems, F, T) predicted mono magnitudes: "parity" is the
    double sigmoid of the trainer masks, "direct" the head channels."""
    if convention == "parity":
        return apply_trainer_masks(model_output, mixture_mag_mono, n_stems)
    if convention == "direct":
        return direct_masks(model_output, n_stems) * mixture_mag_mono[:, None]
    raise ValueError(f"unknown mask convention: {convention!r}")


def apply_direct_masks(model_output: torch.Tensor, mixture_spec: torch.Tensor,
                       n_stems: int) -> torch.Tensor:
    """Direct masks x complex mixture (B, C, F, T) -> (B, n_stems, C, F, T)."""
    return mixture_spec[:, None] * direct_masks(model_output, n_stems)[:, :, None]
