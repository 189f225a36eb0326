"""Train state, optimizer and the train / eval steps (counterpart of
``tfswa_tpu/training/train_state.py``).

One train step: stereo STFT (no gradient) -> mono complex mean and its
magnitude -> the model in train mode -> magnitude masks -> L1 loss ->
backward -> clip by global norm -> AdamW with a per-step cosine schedule.
The JAX step is a pure function of its state; here the state holds the
model and the optimizer, which the step updates in place (parameters,
BatchNorm running stats, moments), and returns.  bf16 compute needs no
loss scaling.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch

from ..config import Config
from ..models import TFSWAUNet
from ..ops.masking import apply_magnitude_masks
from ..ops.stft import STFTProcessor
from .losses import source_separation_loss

Schedule = Callable[[int], float]


def make_learning_rate_schedule(cfg: Config, steps_per_epoch: int) -> Schedule:
    """optax's cosine decay to lr_min over the whole run (alpha = lr_min /
    lr), after a linear warmup from 0 when ``warmup_steps`` > 0.  Called
    with the number of updates made before the current one, as optax
    counts, so the first update uses lr(0) (0 with a warmup)."""
    total = cfg.train.max_epochs * steps_per_epoch
    lr, lr_min = cfg.train.learning_rate, cfg.train.lr_min
    warmup = cfg.train.warmup_steps
    decay_steps = max(total - warmup, 1)
    alpha = lr_min / lr

    def cosine(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    def schedule(count: int) -> float:
        if warmup > 0 and count < warmup:
            return lr * count / warmup
        return cosine(count - warmup) if warmup > 0 else cosine(count)

    return schedule


class ClippedAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule, 0.9,
    0.999, 1e-8, weight_decay)): the gradients are scaled by
    max_norm / norm when norm >= max_norm (optax's formula; torch's
    ``clip_grad_norm_`` adds 1e-6 to the norm), then ``torch.optim.AdamW``,
    whose update is optax's adamw update, runs with lr = schedule(count)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 max_norm: float, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.max_norm = max_norm
        self.adamw = torch.optim.AdamW(self.params, lr=schedule(0), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, count.  Returns the global norm of the gradients
        before the clip (an f32 tensor on the parameters' device)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(cfg: Config, steps_per_epoch: int,
                   params: Iterable[torch.nn.Parameter]) -> Tuple[ClippedAdamW, Schedule]:
    """clip-by-global-norm(gradient_clip_val) -> AdamW(weight_decay) on a
    per-step cosine schedule; returns (optimizer, schedule)."""
    schedule = make_learning_rate_schedule(cfg, steps_per_epoch)
    tx = ClippedAdamW(params, schedule, cfg.train.gradient_clip_val,
                      cfg.train.weight_decay)
    return tx, schedule


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running stats), its optimizer and
    the number of steps taken."""

    step: int
    model: TFSWAUNet
    tx: ClippedAdamW


def create_train_state(cfg: Config, steps_per_epoch: int = 1000,
                       device: str = "cuda") -> Tuple[TFSWAUNet, TrainState]:
    """Model from ``cfg.model`` with weights from a ``torch.Generator``
    seeded with ``cfg.train.seed``, on ``device``, and its optimizer."""
    _check_trainable(cfg.model.attention_impl)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = TFSWAUNet.from_config(cfg.model, generator=gen).to(device)
    tx, _ = make_optimizer(cfg, steps_per_epoch, model.parameters())
    return model, TrainState(step=0, model=model, tx=tx)


def _check_trainable(attention_impl: str) -> None:
    if attention_impl == "pallas_int8":
        raise ValueError("attention_impl='pallas_int8' is serving only (B3 has no "
                         "gradient); train with 'pallas', 'pallas_attn' or 'xla'")


def _crop_nyquist(spec: torch.Tensor) -> torch.Tensor:
    """Drop the odd Nyquist row of an (..., F, T) spectrogram (1025 -> 1024
    at the flagship STFT); freq_policy="crop_pow2"."""
    return spec[..., :-1, :] if spec.shape[-2] % 2 == 1 else spec


def _spectrograms(stft_processor: STFTProcessor, mixtures: torch.Tensor,
                  targets: Dict[str, torch.Tensor], freq_policy: str):
    """Model input, mono mixture magnitude and mono target magnitudes."""
    with torch.no_grad():
        mixture_spec = stft_processor.stft(mixtures)              # (B, 2, F, T) c64
        target_mags = {k: stft_processor.stft(v).mean(dim=1).abs()
                       for k, v in targets.items()}
        if freq_policy == "crop_pow2":
            mixture_spec = _crop_nyquist(mixture_spec)
            target_mags = {k: _crop_nyquist(v) for k, v in target_mags.items()}
        mixture_mag = mixture_spec.mean(dim=1).abs()              # (B, F, T)
        model_input = stft_processor.to_model_input(mixture_spec)
    return model_input, mixture_mag, target_mags


def _check_policy(freq_policy: str) -> None:
    if freq_policy not in ("full", "crop_pow2"):
        raise ValueError(f"unknown freq_policy: {freq_policy!r}")


def make_train_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                    stems: Tuple[str, ...], l1_weight: float = 1.0,
                    use_mrstft: bool = False, spec_augment=None,
                    mask_mode: str = "parity",
                    freq_policy: str = "full",
                    data_axis: Optional[str] = None) -> Callable:
    """``train_step(state, mixtures (B, 2, S), targets {stem: (B, 2, S)})
    -> (state, loss_dict)``: the model in train mode (batch-statistics BN,
    every row block through B1-train + B2 on the card), the JAX loss_dict
    keys plus ``grad_norm`` (taken before the clip), as f32 tensors on the
    model's device."""
    if use_mrstft:
        raise NotImplementedError("use_mrstft (the MR-STFT loss) is not ported yet")
    if spec_augment is not None:
        raise NotImplementedError("spec_augment is not ported yet")
    if data_axis is not None:
        raise NotImplementedError("data_axis (multi-GPU) is not ported yet")
    _check_policy(freq_policy)
    _check_trainable(model.attention_impl)
    n_stems = len(stems)

    def train_step(state: TrainState, mixtures: torch.Tensor,
                   targets: Dict[str, torch.Tensor]):
        model.train()
        model_input, mixture_mag, target_mags = _spectrograms(
            stft_processor, mixtures, targets, freq_policy)
        pred = apply_magnitude_masks(model(model_input), mixture_mag, n_stems, mask_mode)
        loss_dict = source_separation_loss(
            {k: pred[:, i] for i, k in enumerate(stems)}, target_mags, l1_weight)
        state.tx.zero_grad()
        loss_dict["total_loss"].backward()
        grad_norm = state.tx.step()
        state.step += 1
        loss_dict = {k: v.detach().float() for k, v in loss_dict.items()}
        loss_dict["grad_norm"] = grad_norm
        return state, loss_dict

    return train_step


def make_eval_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                   stems: Tuple[str, ...], l1_weight: float = 1.0,
                   mask_mode: str = "parity", freq_policy: str = "full",
                   data_axis: Optional[str] = None) -> Callable:
    """``eval_step(state, mixtures, targets) -> loss_dict``: the same mask
    pipeline with eval-mode BN and no gradient (row blocks through B1's
    serving form)."""
    if data_axis is not None:
        raise NotImplementedError("data_axis (multi-GPU) is not ported yet")
    _check_policy(freq_policy)
    n_stems = len(stems)

    @torch.no_grad()
    def eval_step(state: TrainState, mixtures: torch.Tensor,
                  targets: Dict[str, torch.Tensor]):
        model.eval()
        model_input, mixture_mag, target_mags = _spectrograms(
            stft_processor, mixtures, targets, freq_policy)
        pred = apply_magnitude_masks(model(model_input), mixture_mag, n_stems, mask_mode)
        loss_dict = source_separation_loss(
            {k: pred[:, i] for i, k in enumerate(stems)}, target_mags, l1_weight)
        return {k: v.float() for k, v in loss_dict.items()}

    return eval_step
