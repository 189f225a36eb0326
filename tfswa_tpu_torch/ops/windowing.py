"""Window partition / reverse on NHWC tensors and the Swin shift masks
(counterpart of ``tfswa_tpu/ops/windowing.py``), in the same window order."""
from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=32)
def swin_attention_mask(H: int, W: int, window_size: int, shift_size: int) -> np.ndarray:
    """Additive attention mask (nWindows, ws*ws, ws*ws) f32 for shifted
    windows of a padded (H, W) map: -100.0 between tokens of different
    regions of the rolled map, 0 within one (the standard Swin
    construction; the slices encode the post-roll layout, so the region
    image is partitioned directly).  Cached, as the JAX package caches it:
    treat the array as read-only."""
    ws, ss = window_size, shift_size
    img = np.zeros((H, W), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
        for wz in (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)):
            img[hs, wz] = cnt
            cnt += 1
    nH, nW = H // ws, W // ws
    wins = img.reshape(nH, ws, nW, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def swin_mask_table(H: int, W: int, window_size: int, shift_size: int):
    """:func:`swin_attention_mask` factored as a 4-pattern table: ``(table,
    idx)`` with ``table`` (4, ws*ws, ws*ws) f32 (interior, last window row,
    last window column, corner) and ``idx`` (nH*nW,) int32, each window's
    pattern in :func:`window_partition` order; ``table[idx]`` is the dense
    mask.  The model gathers it a chunk of windows at a time, so that the
    dense mask (1.8 GB at a batch of eight 10 s segments) never exists.
    Cached on (H, W, ws, ss): treat the arrays as read-only."""
    ws, ss = window_size, shift_size
    interior = np.zeros(ws, dtype=np.int32)
    last = np.concatenate([np.full(ws - ss, 1, np.int32), np.full(ss, 2, np.int32)])
    table = np.zeros((4, ws * ws, ws * ws), dtype=np.float32)
    for kind in range(4):
        rb = last if kind & 2 else interior
        cb = last if kind & 1 else interior
        ids = (3 * rb[:, None] + cb[None, :]).reshape(-1)
        table[kind] = np.where(ids[None, :] != ids[:, None], -100.0, 0.0).astype(np.float32)
    nH, nW = H // ws, W // ws
    is_last_row = (np.arange(nH) == nH - 1).astype(np.int32)
    is_last_col = (np.arange(nW) == nW - 1).astype(np.int32)
    idx = (2 * is_last_row[:, None] + is_last_col[None, :]).reshape(-1)
    return table, idx
