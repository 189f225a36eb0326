"""Window partition / reverse on NHWC tensors (counterpart of
``tfswa_tpu/ops/windowing.py``), in the same window order."""
from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C).  H, W must be ws-multiples."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, window_size: int, B: int, H: int,
                   W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`: -> (B, H, W, C)."""
    ws = window_size
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)
