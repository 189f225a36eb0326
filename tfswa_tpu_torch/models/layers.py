"""Layer primitives on NHWC activations (counterpart of
``tfswa_tpu/models/layers.py``).

Activations stay channels-last, as in the JAX model, so that attention rows
are contiguous in C.  Parameters live in ``nn.Conv2d`` / ``nn.BatchNorm2d``
/ ``nn.ConvTranspose2d`` modules under the reference's state_dict names and
are applied here in the compute dtype:
  - Conv2d / ConvTranspose2d k4 s2 p1 with torch's shape rules;
  - BatchNorm, eps 1e-5, in f32: in eval mode from the running stats; in
    train mode (``bn.training``) from the batch, with flax's semantics;
  - exact (erf) GELU;
  - bilinear resize = F.interpolate(align_corners=False).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.comm import average_over


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def conv2d(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """NHWC conv in x's dtype."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), bias,
                 conv.stride, conv.padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose2d(x: torch.Tensor, deconv: nn.ConvTranspose2d) -> torch.Tensor:
    """NHWC transposed conv in x's dtype (torch ConvTranspose2d shapes)."""
    dt = x.dtype
    bias = None if deconv.bias is None else deconv.bias.to(dt)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), deconv.weight.to(dt), bias,
                           deconv.stride, deconv.padding)
    return y.permute(0, 2, 3, 1)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm over the last (channel) axis of NHWC ``x``, in f32, back in
    x's dtype.  Eval mode normalises with the running stats.  Train mode
    follows flax's ``BatchNorm`` (the JAX model's), not torch's: statistics
    over (B, H, W) in f32 with the biased variance E[x^2] - E[x]^2, used
    both to normalise and, as ``(1 - m) * old + m * batch`` with torch's
    momentum m = 0.1 (flax's 0.9), to update the running stats.  torch's
    ``F.batch_norm`` would store the unbiased variance instead.  Under
    :func:`frozen_stats` (a remat recompute) the running stats stay as
    they are."""
    if not bn.training:
        y = (x.float() - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
        return (y * bn.weight + bn.bias).to(x.dtype)
    xf = x.float()
    mean = xf.mean(dim=(0, 1, 2))
    mean_sq = xf.square().mean(dim=(0, 1, 2))
    axis = getattr(bn, "sync_axis", None)
    if axis is not None:
        mean, mean_sq = average_over(torch.stack([mean, mean_sq]), axis).unbind(0)
    var = (mean_sq - mean.square()).clamp_min(0.0)
    if not getattr(bn, "stats_frozen", False):
        with torch.no_grad():
            m = bn.momentum
            bn.running_mean.copy_((1.0 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1.0 - m) * bn.running_var + m * var)
            bn.num_batches_tracked += 1
    y = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    return y.to(x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module) -> Iterator[None]:
    """Train-mode BatchNorms under ``module`` normalise with the batch's
    statistics but leave their running stats and ``num_batches_tracked``
    alone: the context of a remat recompute, which runs a forward that
    has already updated them once."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.stats_frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.stats_frozen = False


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, F.interpolate(align_corners=False)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX model's init: Kaiming-normal (fan_out, relu gain) for convs
    and transposed convs, truncated normal std 0.02 (+-2 std) for linears,
    zero biases, BatchNorm 1/0 with running stats 0/1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                    generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
