"""Separation metrics: SDR / SI-SDR / SIR / SAR and helpers, as torch
functions on tensors, on the tensors' device (counterpart of
``tfswa_tpu/evaluation/metrics.py``, formula for formula).

  - SIR's interference is sum(sources) - the target source, picked by the
    largest correlation with the reference;
  - framewise metrics reshape into (num_segments, ...) and evaluate every
    segment in one call;
  - the median is torch.median's, the lower of the two middle elements.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch


def _safe_db(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    ratio = torch.clamp(num / (den + eps), min=eps)
    return 10.0 * torch.log10(ratio)


def _batched(*tensors):
    if tensors[0].dim() == 1:
        return tuple(t[None] for t in tensors), True
    return tensors, False


def sdr(estimate: torch.Tensor, reference: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Signal-to-Distortion Ratio in dB over the last axis."""
    if estimate.shape != reference.shape:
        raise ValueError(f"shapes differ: {tuple(estimate.shape)} vs {tuple(reference.shape)}")
    (estimate, reference), squeeze = _batched(estimate, reference)
    signal_power = torch.sum(reference ** 2, dim=-1)
    noise_power = torch.sum((estimate - reference) ** 2, dim=-1)
    val = _safe_db(signal_power, noise_power, eps)
    return val[0] if squeeze else val


def si_sdr(estimate: torch.Tensor, reference: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis."""
    if estimate.shape != reference.shape:
        raise ValueError(f"shapes differ: {tuple(estimate.shape)} vs {tuple(reference.shape)}")
    (estimate, reference), squeeze = _batched(estimate, reference)
    estimate = estimate - estimate.mean(dim=-1, keepdim=True)
    reference = reference - reference.mean(dim=-1, keepdim=True)
    scaled_target = _project(estimate, reference, eps)
    error = estimate - scaled_target
    val = _safe_db(torch.sum(scaled_target ** 2, dim=-1), torch.sum(error ** 2, dim=-1), eps)
    return val[0] if squeeze else val


def _project(estimate: torch.Tensor, reference: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """The projection of ``estimate`` onto ``reference``."""
    dot = torch.sum(estimate * reference, dim=-1, keepdim=True)
    ref_energy = torch.sum(reference ** 2, dim=-1, keepdim=True)
    return dot / (ref_energy + eps) * reference


def _batched_sources(estimate, reference, sources):
    if estimate.dim() == 1:
        return estimate[None], reference[None], sources[None], True
    return estimate, reference, sources, False


def sir(estimate: torch.Tensor, reference: torch.Tensor, sources: torch.Tensor,
        eps: float = 1e-10) -> torch.Tensor:
    """Signal-to-Interference Ratio in dB: the target source is the one most
    correlated with the reference, the interference the sum of the others."""
    estimate, reference, sources, squeeze = _batched_sources(estimate, reference, sources)
    correlations = torch.sum(reference[:, None] * sources, dim=-1)      # (B, S)
    target_idx = torch.argmax(correlations, dim=1)                       # (B,)
    target = torch.take_along_dim(sources, target_idx[:, None, None], dim=1)[:, 0]
    interference = torch.sum(sources, dim=1) - target
    ref_proj = _project(estimate, reference, eps)
    int_proj = _project(estimate, interference, eps)
    val = _safe_db(torch.sum(ref_proj ** 2, dim=-1), torch.sum(int_proj ** 2, dim=-1), eps)
    return val[0] if squeeze else val


def sar(estimate: torch.Tensor, reference: torch.Tensor, sources: torch.Tensor,
        eps: float = 1e-10) -> torch.Tensor:
    """Signal-to-Artifacts Ratio in dB."""
    estimate, reference, sources, squeeze = _batched_sources(estimate, reference, sources)
    allowed = torch.sum(_project(estimate[:, None], sources, eps), dim=1)   # (B, T)
    artifacts = estimate - allowed
    val = _safe_db(torch.sum(allowed ** 2, dim=-1), torch.sum(artifacts ** 2, dim=-1), eps)
    return val[0] if squeeze else val


def bss_eval(estimate: torch.Tensor, reference: torch.Tensor, sources: torch.Tensor,
             eps: float = 1e-10) -> Dict[str, torch.Tensor]:
    """All four metrics."""
    return {"sdr": sdr(estimate, reference, eps), "si_sdr": si_sdr(estimate, reference, eps),
            "sir": sir(estimate, reference, sources, eps),
            "sar": sar(estimate, reference, sources, eps)}


def _torch_median(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """torch.median semantics: the lower of the two middle elements."""
    return torch.median(values, dim=dim).values


def median_filter_metrics(metrics: Dict[str, torch.Tensor],
                          window_size: int = 3) -> Dict[str, torch.Tensor]:
    """Median filter (scipy.ndimage.median_filter, reflect mode) over
    per-frame metric arrays; scalars pass through."""
    from scipy.ndimage import median_filter

    out = {}
    for key, values in metrics.items():
        v = torch.as_tensor(values)
        if v.dim() == 0:
            out[key] = values
        else:
            filtered = median_filter(v.detach().cpu().numpy(), size=window_size)
            out[key] = torch.from_numpy(np.ascontiguousarray(filtered)).to(v.device)
    return out


class MetricsCalculator:
    """Full-signal metrics, or framewise over non-overlapping segments of
    ``segment_length`` samples, median-aggregated, when the signal is
    longer; ``device`` is where they are computed ("cuda" unless the caller
    asks for "cpu")."""

    def __init__(self, sample_rate: int = 44100, segment_length: Optional[int] = None,
                 eps: float = 1e-10, device="cuda"):
        self.sample_rate = sample_rate
        self.segment_length = segment_length
        self.eps = eps
        self.device = torch.device(device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    def compute(self, estimate, reference, sources=None,
                compute_all: bool = True) -> Dict[str, float]:
        estimate, reference = self._tensor(estimate), self._tensor(reference)
        if sources is not None:
            sources = self._tensor(sources)
        if self.segment_length is not None and estimate.shape[-1] > self.segment_length:
            metrics = self._compute_framewise(estimate, reference, sources, compute_all)
        else:
            metrics = self._compute_full(estimate, reference, sources, compute_all)
        return {k: float(v.mean()) for k, v in metrics.items()}

    def _compute_full(self, estimate, reference, sources, compute_all):
        metrics = {"sdr": sdr(estimate, reference, self.eps),
                   "si_sdr": si_sdr(estimate, reference, self.eps)}
        if compute_all and sources is not None:
            metrics["sir"] = sir(estimate, reference, sources, self.eps)
            metrics["sar"] = sar(estimate, reference, sources, self.eps)
        return metrics

    def _compute_framewise(self, estimate, reference, sources, compute_all):
        """Non-overlapping segments, median-aggregated, all in one call."""
        if estimate.dim() == 1:
            estimate, reference = estimate[None], reference[None]
            if sources is not None:
                sources = sources[None]
        B, total = estimate.shape
        seg = self.segment_length
        n_seg = total // seg

        def to_segs(x):   # (B, T) -> (n_seg * B, seg), segment-major
            return x[:, :n_seg * seg].reshape(B, n_seg, seg).transpose(0, 1).reshape(-1, seg)

        est_s, ref_s = to_segs(estimate), to_segs(reference)
        metrics = {"sdr": sdr(est_s, ref_s, self.eps).reshape(n_seg, B),
                   "si_sdr": si_sdr(est_s, ref_s, self.eps).reshape(n_seg, B)}
        if compute_all and sources is not None:
            S = sources.shape[1]
            src_s = (sources[:, :, :n_seg * seg].reshape(B, S, n_seg, seg)
                     .permute(2, 0, 1, 3).reshape(-1, S, seg))
            metrics["sir"] = sir(est_s, ref_s, src_s, self.eps).reshape(n_seg, B)
            metrics["sar"] = sar(est_s, ref_s, src_s, self.eps).reshape(n_seg, B)
        return {k: _torch_median(v, dim=0) for k, v in metrics.items()}


def compute_musdb_metrics(estimates: Dict[str, np.ndarray], references: Dict[str, np.ndarray],
                          sample_rate: int = 44100, device="cuda") -> Dict[str, Dict[str, float]]:
    """Per stem: framewise (10 s) SDR, SI-SDR, SIR and SAR with every
    reference stacked as the sources."""
    calculator = MetricsCalculator(sample_rate=sample_rate, segment_length=sample_rate * 10,
                                   device=device)
    all_refs = torch.stack([calculator._tensor(r) for r in references.values()])
    results = {}
    for stem_name, est in estimates.items():
        if stem_name not in references:
            warnings.warn(f"Reference for {stem_name} not found, skipping")
            continue
        results[stem_name] = calculator.compute(estimate=est, reference=references[stem_name],
                                                sources=all_refs, compute_all=True)
    return results
