"""TFSWA block and resampling blocks on NHWC activations (counterpart of
``tfswa_tpu/models/blocks.py``), under the reference's state_dict names."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .attention import (FrequencySequenceAttention, ShiftedWindowAttention,
                        TemporalSequenceAttention, sub_seed)
from .layers import batch_norm, bilinear_resize, conv2d, conv_transpose2d, gelu


class TFSWABlock(nn.Module):
    """input-proj (1x1 conv + BN) -> {TSA || FSA || SWA} -> concat -> 1x1 fuse
    (conv + BN + GELU) -> + residual -> + encoder skip.  With a
    ``dropout_seed`` (train mode, dropout > 0), TSA, FSA and SWA draw their
    dropout from ``sub_seed(dropout_seed, 0 / 1 / 2)``."""

    def __init__(self, dim: int, window_size: int, shift_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, attention_impl: str = "xla",
                 use_shift_mask: bool = False, dropout: float = 0.0):
        super().__init__()
        self.input_proj = nn.Sequential(nn.Conv2d(dim, dim, 1), nn.BatchNorm2d(dim))
        self.tsa = TemporalSequenceAttention(dim, num_heads, mlp_ratio, attention_impl,
                                             dropout)
        self.fsa = FrequencySequenceAttention(dim, num_heads, mlp_ratio, attention_impl,
                                              dropout)
        self.swa = ShiftedWindowAttention(dim, window_size, num_heads, shift_size,
                                          mlp_ratio, use_shift_mask, attention_impl, dropout)
        self.fusion = nn.Sequential(nn.Conv2d(3 * dim, dim, 1), nn.BatchNorm2d(dim),
                                    nn.GELU())

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None) -> torch.Tensor:
        h = batch_norm(conv2d(x, self.input_proj[0]), self.input_proj[1])
        seeds = [None if dropout_seed is None else sub_seed(dropout_seed, i) for i in range(3)]
        combined = torch.cat([self.tsa(h, seeds[0]), self.fsa(h, seeds[1]),
                              self.swa(h, seeds[2])], dim=-1)
        f = gelu(batch_norm(conv2d(combined, self.fusion[0]), self.fusion[1]))
        f = f + x
        if skip is not None:
            f = f + bilinear_resize(skip, f.shape[1:3])
        return f


class DownsampleBlock(nn.Module):
    """Conv k4 s2 p1 + BN + GELU (torch floor-halving shapes)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 4, 2, 1),
                                        nn.BatchNorm2d(cout), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(batch_norm(conv2d(x, self.downsample[0]), self.downsample[1]))


class UpsampleBlock(nn.Module):
    """ConvTranspose k4 s2 p1 + BN + GELU (torch output shapes)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.upsample = nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1),
                                      nn.BatchNorm2d(cout), nn.GELU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(batch_norm(conv_transpose2d(x, self.upsample[0]), self.upsample[1]))
