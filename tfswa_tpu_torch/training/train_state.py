"""Train state, optimizer and the train / eval steps (counterpart of
``tfswa_tpu/training/train_state.py``).

One train step: stereo STFT (no gradient) -> mono complex mean and its
magnitude -> the model in train mode -> magnitude masks -> L1 loss (and,
with ``use_mrstft``, the MR-STFT loss on the masked magnitudes under the
mixture phase, through the iSTFT) -> backward -> clip by global norm -> AdamW with a per-step cosine schedule.
The JAX step is a pure function of its state; here the state holds the
model and the optimizer, which the step updates in place (parameters,
BatchNorm running stats, moments), and returns.  bf16 compute needs no
loss scaling.

On a mesh (``create_train_state(mesh=)``, ``make_sharded_train_step``)
each rank runs its ``B / d`` rows end to end; BatchNorm averages its
statistics over "data" in the forward; after the backward the gradients
are summed over "data" and divided by d (one ``all_reduce``), before the
clip, so that ``grad_norm`` is the averaged gradient's, and the losses are
averaged over "data".  Under tensor parallelism the clip's global norm sums
the shards' squares over "model" and counts each replicated parameter
once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..models import TFSWAUNet
from ..models.attention import sub_seed
from ..ops.masking import apply_magnitude_masks
from ..ops.stft import STFTProcessor
from ..parallel.comm import active, all_reduce_
from ..parallel.sharding import shard_model, tp_split
from .losses import source_separation_loss

Schedule = Callable[[int], float]
# the key that keeps a step's dropout seed apart from its spec-augment draws
DROPOUT_STREAM = 1


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
    whose update is optax's adamw update, runs with lr = schedule(count).

    ``model_axis`` (tensor parallelism, more than one rank) with
    ``sharded`` (a flag a parameter, True for a shard of a split weight):
    the global norm is the square root of the shards' squares summed over
    the axis plus the replicated parameters' squares, counted once."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 max_norm: float, weight_decay: float, model_axis=None,
                 sharded: Optional[Iterable[bool]] = None):
        params = list(params)
        flags = [False] * len(params) if sharded is None else list(sharded)
        keep = [i for i, p in enumerate(params) if p.requires_grad]
        self.params = [params[i] for i in keep]
        self.sharded = [flags[i] for i in keep]
        self.model_axis = model_axis
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
        pairs = [(p.grad, f) for p, f in zip(self.params, self.sharded) if p.grad is not None]
        grads = [g for g, _ in pairs]
        if self.model_axis is None:
            norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        else:
            split = sum(g.float().square().sum() for g, f in pairs if f)
            whole = sum(g.float().square().sum() for g, f in pairs if not f)
            norm = torch.sqrt(all_reduce_(torch.as_tensor(split, device=grads[0].device),
                                          self.model_axis) + whole)
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """The update count and AdamW's state (moments, its own step)."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.adamw.load_state_dict(state["adamw"])


def make_optimizer(cfg: Config, steps_per_epoch: int,
                   params: Iterable[torch.nn.Parameter], model_axis=None,
                   sharded: Optional[Iterable[bool]] = None) -> Tuple[ClippedAdamW, Schedule]:
    """clip-by-global-norm(gradient_clip_val) -> AdamW(weight_decay) on a
    per-step cosine schedule; returns (optimizer, schedule).  ``model_axis``
    and ``sharded``: the clip under tensor parallelism (``ClippedAdamW``)."""
    schedule = make_learning_rate_schedule(cfg, steps_per_epoch)
    tx = ClippedAdamW(params, schedule, cfg.train.gradient_clip_val,
                      cfg.train.weight_decay, model_axis, sharded)
    return tx, schedule


@dataclass
class TrainState:
    """The model (parameters and BatchNorm running stats), its optimizer and
    the number of steps taken."""

    step: int
    model: TFSWAUNet
    tx: ClippedAdamW


def create_train_state(cfg: Config, steps_per_epoch: int = 1000,
                       device: str = "cuda", mesh=None) -> Tuple[TFSWAUNet, TrainState]:
    """Model from ``cfg.model`` with weights from a ``torch.Generator``
    seeded with ``cfg.train.seed``, on ``device``, and its optimizer.

    With a ``mesh`` every rank builds the same whole model and
    ``parallel.sharding.shard_model`` puts it on the mesh (BatchNorm over
    "data", the split weights cut to the rank's shards, the rank's device
    in place of ``device``); the clip then takes the model axis."""
    _check_trainable(cfg.model.attention_impl)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    model = TFSWAUNet.from_config(cfg.model, generator=gen)
    if mesh is None:
        model = model.to(device)
        tx, _ = make_optimizer(cfg, steps_per_epoch, model.parameters())
    else:
        model = shard_model(model, mesh)
        named = list(model.named_parameters())
        tx, _ = make_optimizer(cfg, steps_per_epoch, [p for _, p in named], model.tp_axis,
                               [tp_split(n) is not None for n, _ in named])
    return model, TrainState(step=0, model=model, tx=tx)


def _check_trainable(attention_impl: str) -> None:
    if attention_impl == "pallas_int8":
        raise ValueError("attention_impl='pallas_int8' is serving only (B3 has no "
                         "gradient); train with 'pallas', 'pallas_attn' or 'xla'")
    if attention_impl == "int8":
        raise ValueError(
            "attention_impl='int8' is inference-only: rounding has zero gradient, so "
            "training would not learn.  Train with 'pallas' or 'xla' and quantize the "
            "result (optimization/quantization.py).")


def dropout_generator(rng_seed: int, step: int) -> torch.Generator:
    """The CPU generator of a train step's dropout, seeded from
    (``rng_seed``, ``step``): the same pair gives the same masks, after a
    resume too (the JAX step folds the step into its key)."""
    return torch.Generator().manual_seed(sub_seed(rng_seed, step, DROPOUT_STREAM))


def _crop_nyquist(spec: torch.Tensor) -> torch.Tensor:
    """Drop the odd Nyquist row of an (..., F, T) spectrogram (1025 -> 1024
    at the flagship STFT); freq_policy="crop_pow2"."""
    return spec[..., :-1, :] if spec.shape[-2] % 2 == 1 else spec


def _spectrograms(stft_processor: STFTProcessor, mixtures: torch.Tensor,
                  targets: Dict[str, torch.Tensor], freq_policy: str):
    """Model input, mono mixture complex spectrogram (B, F, T) and mono
    target magnitudes."""
    with torch.no_grad():
        mixture_spec = stft_processor.stft(mixtures)              # (B, 2, F, T) c64
        target_mags = {k: stft_processor.stft(v).mean(dim=1).abs()
                       for k, v in targets.items()}
        if freq_policy == "crop_pow2":
            mixture_spec = _crop_nyquist(mixture_spec)
            target_mags = {k: _crop_nyquist(v) for k, v in target_mags.items()}
        mono = mixture_spec.mean(dim=1)
        model_input = stft_processor.to_model_input(mixture_spec)
    return model_input, mono, target_mags


def _check_policy(freq_policy: str) -> None:
    if freq_policy not in ("full", "crop_pow2"):
        raise ValueError(f"unknown freq_policy: {freq_policy!r}")


def make_train_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                    stems: Tuple[str, ...], l1_weight: float = 1.0,
                    mrstft_weight: float = 0.5, use_mrstft: bool = False,
                    spec_augment=None,
                    rng_seed: int = 0, mask_mode: str = "parity",
                    freq_policy: str = "full",
                    data_axis=None) -> Callable:
    """``train_step(state, mixtures (B, 2, S), targets {stem: (B, 2, S)})
    -> (state, loss_dict)``: the model in train mode (batch-statistics BN,
    every row block through B1-train + B2 on the card), the JAX loss_dict
    keys plus ``grad_norm`` (taken before the clip), as f32 tensors on the
    model's device.

    ``spec_augment`` (a ``data.augment.SpectrogramAugmentation``) masks the
    model input, the targets stay clean; its draws come from a generator
    seeded with (``rng_seed``, ``state.step``), so that they are fixed by
    the seed and the same after a resume, as the JAX step folds the step
    into its key.  The model's dropout, when its rate is above 0, draws
    from :func:`dropout_generator` (``rng_seed``, ``state.step``); it sends
    every row block to the plain route, as in JAX.

    ``use_mrstft`` adds ``mrstft_weight`` times the MR-STFT loss between
    each stem's predicted audio (its masked magnitude under the mixture
    phase, the Nyquist row zero-padded back under crop_pow2, through the
    iSTFT) and the channel mean of its target audio.

    ``data_axis`` (a mesh's data axis; ``make_sharded_train_step``): this
    rank's rows of the batch; the gradients summed over the axis and
    divided by its size before the clip, the losses averaged over it.  The
    model must average its BatchNorm statistics over the same axis
    (``model.bn_axis``; ``create_train_state(mesh=)`` sets it)."""
    _check_data_axis(model, data_axis)
    _check_policy(freq_policy)
    _check_trainable(model.attention_impl)
    n_stems = len(stems)

    def train_step(state: TrainState, mixtures: torch.Tensor,
                   targets: Dict[str, torch.Tensor]):
        model.train()
        model_input, mono, target_mags = _spectrograms(
            stft_processor, mixtures, targets, freq_policy)
        if spec_augment is not None:
            model_input = spec_augment(np.random.default_rng((rng_seed, state.step)),
                                       model_input)
        gen = dropout_generator(rng_seed, state.step) if model.dropout > 0.0 else None
        pred = apply_magnitude_masks(model(model_input, generator=gen), mono.abs(), n_stems,
                                     mask_mode)
        pred_mags = {k: pred[:, i] for i, k in enumerate(stems)}
        pred_audios = target_audios = None
        if use_mrstft:
            pred_audios = {k: _stem_audio(stft_processor, v, mono.angle(), freq_policy,
                                          mixtures.shape[-1]) for k, v in pred_mags.items()}
            target_audios = {k: targets[k].mean(dim=1, keepdim=True) for k in stems}
        loss_dict = source_separation_loss(
            pred_mags, target_mags, pred_audios, target_audios, l1_weight=l1_weight,
            mrstft_weight=mrstft_weight, use_mrstft=use_mrstft)
        state.tx.zero_grad()
        loss_dict["total_loss"].backward()
        if active(data_axis):
            _average_gradients(state.tx.params, data_axis)
        grad_norm = state.tx.step()
        state.step += 1
        loss_dict = _average_losses({k: v.detach().float() for k, v in loss_dict.items()},
                                    data_axis)
        loss_dict["grad_norm"] = grad_norm
        return state, loss_dict

    return train_step


def _check_data_axis(model: TFSWAUNet, data_axis) -> None:
    if data_axis is not None and model.bn_axis is not data_axis:
        raise ValueError(
            f"data_axis={data_axis!r} needs the model's BatchNorm statistics averaged over "
            f"it (model.bn_axis is {model.bn_axis!r}) so that they are the global batch's")


def _average_gradients(params, axis) -> None:
    """Each gradient summed over ``axis`` and divided by its size, in one
    ``all_reduce`` of the gradients laid end to end."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, axis).div_(axis.size)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _average_losses(loss_dict: Dict[str, torch.Tensor], axis) -> Dict[str, torch.Tensor]:
    """The losses averaged over ``axis`` (one ``all_reduce``)."""
    if not active(axis):
        return loss_dict
    flat = all_reduce_(torch.stack(list(loss_dict.values())), axis) / axis.size
    return dict(zip(loss_dict, flat.unbind(0)))


def make_sharded_train_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                            stems: Tuple[str, ...], mesh, **kwargs) -> Callable:
    """The data-parallel train step over ``mesh``: :func:`make_train_step`
    with ``data_axis=mesh.data`` (every rank calls it with its own rows of
    the batch).  The model must come from ``create_train_state(mesh=)``."""
    return make_train_step(model, stft_processor, stems, data_axis=mesh.data, **kwargs)


def _stem_audio(stft_processor: STFTProcessor, mag: torch.Tensor, phase: torch.Tensor,
                freq_policy: str, length: int) -> torch.Tensor:
    """(B, F, T) magnitude under the mixture phase -> (B, 1, S) audio; under
    crop_pow2 a zero Nyquist row goes back for the full-width iSTFT."""
    spec = mag.float() * torch.exp(1j * phase)
    if freq_policy == "crop_pow2":
        spec = torch.nn.functional.pad(spec, (0, 0, 0, 1))
    return stft_processor.istft(spec, length=length)[:, None, :]


def make_eval_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                   stems: Tuple[str, ...], l1_weight: float = 1.0,
                   mask_mode: str = "parity", freq_policy: str = "full",
                   data_axis=None) -> Callable:
    """``eval_step(state, mixtures, targets) -> loss_dict``: the same mask
    pipeline with eval-mode BN and no gradient (row blocks through B1's
    serving form).  ``data_axis``: the losses averaged over it (eval-mode
    BatchNorm reads its running stats, so nothing else crosses ranks)."""
    _check_policy(freq_policy)
    n_stems = len(stems)

    @torch.no_grad()
    def eval_step(state: TrainState, mixtures: torch.Tensor,
                  targets: Dict[str, torch.Tensor]):
        model.eval()
        model_input, mono, target_mags = _spectrograms(
            stft_processor, mixtures, targets, freq_policy)
        pred = apply_magnitude_masks(model(model_input), mono.abs(), n_stems, mask_mode)
        loss_dict = source_separation_loss(
            {k: pred[:, i] for i, k in enumerate(stems)}, target_mags, l1_weight=l1_weight)
        return _average_losses({k: v.float() for k, v in loss_dict.items()}, data_axis)

    return eval_step


def make_sharded_eval_step(model: TFSWAUNet, stft_processor: STFTProcessor,
                           stems: Tuple[str, ...], mesh, **kwargs) -> Callable:
    """The validation step over ``mesh``: :func:`make_eval_step` with
    ``data_axis=mesh.data``."""
    return make_eval_step(model, stft_processor, stems, data_axis=mesh.data, **kwargs)
