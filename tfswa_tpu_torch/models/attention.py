"""TSA / FSA / SW-MSA attention (counterpart of ``tfswa_tpu/models/attention.py``).

All three attentions share one primitive, a pre-LN transformer block over
independent rows (R, N, C): rows are frequency columns (TSA), time frames
(FSA) or ws*ws windows (SWA), in the JAX package's row order.

``row_transformer_block`` has four routes:
  - ``attention_impl="pallas"``: the fused row-block kernel B1 (B1-train
    and B2 under autograd; ``ops/fused_block.py``), at every shape;
  - ``"pallas_int8"``: the fused block with int8 scores, B3
    (``fused_row_block_int8``), serving only, at every shape;
  - ``"pallas_attn"``: plain LN1, the bilinear attention kernel B4
    (``ops/row_attention.py``), the residual, plain LN2 and MLP
    (``_BilinearBlock``);
  - ``"xla"``: the plain path, LN, multi-head attention with a standard
    softmax chunked over rows, MLP.
The JAX package sends some shapes of ``"pallas"`` and ``"pallas_int8"``
to its plain path (its autotune gates and ``_pallas_fwd_profitable``), and
runs B3 only where its ``"fused_int8"`` gate reads "1", which it ships for
no shape.  The port has no autotune: its routes equal the JAX routes with
the ``"attn_route"`` gate set to the kernel and ``"fused_int8"`` to "1" at
every shape.  ``"pallas"``, ``"pallas_attn"`` and ``"xla"`` are
differentiable.  The plain route runs the block a chunk of rows at a
time, so that one chunk's f32 score planes exist at once; under autograd
it recomputes each chunk in the backward (``torch.utils.checkpoint``, as
the JAX package's ``jax.checkpoint`` per chunk), so that it keeps only
each block's input and output.  ``"pallas_attn"`` under autograd keeps
only the rows and B4's output.  Masked SWA and dropout, which send the
JAX package to its plain path, are not ported yet; nor is the XLA int8
route ``"int8"`` (``ops/int8.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import fused_block
from ..ops.fused_block import fused_row_block, fused_row_block_int8, layer_norm_f32
from ..ops.row_attention import flash_row_attention, mha_rows
from ..ops.windowing import window_partition, window_reverse
from .layers import gelu

ATTENTION_IMPLS = ("pallas", "pallas_int8", "pallas_attn", "xla")


def check_attention_impl(impl: str) -> None:
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported yet (ported: "
            f"{ATTENTION_IMPLS}); the XLA int8 route is queued in ROADMAP.md")


class RowBlockParams(NamedTuple):
    """Flat parameters of one row block, in the JAX layout: kernels are
    (in, out)."""

    norm1_scale: torch.Tensor
    norm1_bias: torch.Tensor
    qkv_kernel: torch.Tensor     # (C, 3C), no bias
    proj_kernel: torch.Tensor    # (C, C)
    proj_bias: torch.Tensor
    norm2_scale: torch.Tensor
    norm2_bias: torch.Tensor
    fc1_kernel: torch.Tensor     # (C, hidden)
    fc1_bias: torch.Tensor
    fc2_kernel: torch.Tensor     # (hidden, C)
    fc2_bias: torch.Tensor


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, back in x's dtype."""
    return layer_norm_f32(x.float(), scale, bias).to(x.dtype)


def _mlp_half(rows: torch.Tensor, p: RowBlockParams) -> torch.Tensor:
    """rows + MLP(LN2(rows)) in the rows' dtype."""
    dt = rows.dtype
    h = _layer_norm(rows, p.norm2_scale, p.norm2_bias)
    h = gelu(h @ p.fc1_kernel.to(dt) + p.fc1_bias.to(dt))
    return rows + (h @ p.fc2_kernel.to(dt) + p.fc2_bias.to(dt))


def _plain_attn(rows: torch.Tensor, p: RowBlockParams, num_heads: int) -> torch.Tensor:
    """MHA(LN1(rows)), the plain attention."""
    normed = _layer_norm(rows, p.norm1_scale, p.norm1_bias)
    return mha_rows(normed, p.qkv_kernel, p.proj_kernel, p.proj_bias, num_heads)


def _plain_block(rows: torch.Tensor, p: RowBlockParams, num_heads: int) -> torch.Tensor:
    """The plain block on rows (R, N, C): rows + MHA(LN(rows)), then
    + MLP(LN(.)), in the rows' dtype with f32 LN statistics and softmax."""
    return _mlp_half(rows + _plain_attn(rows, p, num_heads), p)


def _bilinear_attn(rows: torch.Tensor, p: RowBlockParams, num_heads: int) -> torch.Tensor:
    """B4 on LN1(rows), the weights cast to the rows' dtype first (as the
    JAX package's ``pallas_attn`` branch casts them)."""
    dt = rows.dtype
    normed = _layer_norm(rows, p.norm1_scale, p.norm1_bias)
    return flash_row_attention(normed.contiguous(), p.qkv_kernel.to(dt),
                               p.proj_kernel.to(dt), p.proj_bias.to(dt), num_heads)


def _chunked_vjp(fn, rows: torch.Tensor, weights, g: torch.Tensor, chunk: int):
    """The VJP of ``fn(x, r0, *weights)`` (the output for the rows x =
    rows[r0:r0 + chunk]) at cotangent ``g``, a chunk of rows at a time under
    autograd: ``(d rows, [d weight])``, the weight gradients summed over the
    chunks in f32 and cast to each weight's dtype."""
    leaves = [w.detach().requires_grad_() for w in weights]
    dws = [torch.zeros(w.shape, dtype=torch.float32, device=w.device) for w in weights]
    dxs = []
    with torch.enable_grad():
        for r0 in range(0, rows.shape[0], chunk):
            x = rows[r0:r0 + chunk].detach().requires_grad_()
            dx, *dw = torch.autograd.grad(fn(x, r0, *leaves), [x, *leaves],
                                          g[r0:r0 + chunk])
            dxs.append(dx)
            for acc, d in zip(dws, dw):
                acc += d
    return torch.cat(dxs), [d.to(w.dtype) for d, w in zip(dws, weights)]


class _BilinearBlock(torch.autograd.Function):
    """The ``"pallas_attn"`` block: LN1, B4, the residual, LN2 and the MLP,
    lean in memory under autograd (the plain LN2 and MLP after B4 would
    keep about 44 C bytes a token, more than the card holds at the
    flagship's training shapes).  The forward runs with no graph and keeps
    only the rows and B4's output.  The backward works a chunk of rows at
    a time: it recomputes LN1 and the plain attention (whose VJP is B4's,
    as in the JAX package) and the MLP half at mid = rows + B4's output
    (the forward's own value), and back-propagates.  B4 launches once, in
    the forward."""

    @staticmethod
    def forward(ctx, rows, num_heads, params_type, *params):
        p = params_type(*params)
        attn = _bilinear_attn(rows, p, num_heads)
        ctx.save_for_backward(rows, attn, *params)
        ctx.num_heads, ctx.params_type = num_heads, params_type
        return _mlp_half(rows + attn, p)

    @staticmethod
    def backward(ctx, g):
        rows, attn, *params = ctx.saved_tensors
        H = ctx.num_heads
        N = rows.shape[1]

        def block(x, r0, *leaves):
            p = ctx.params_type(*leaves)
            plain = _plain_attn(x, p, H)
            # B4's value, the plain attention's gradient
            a = attn[r0:r0 + x.shape[0]] + (plain - plain.detach())
            return _mlp_half(x + a, p)

        dx, dps = _chunked_vjp(block, rows, params, g,
                              max(1, fused_block.MAX_SCORE_BYTES // (H * N * N * 4)))
        return (dx, None, None, *dps)


def row_transformer_block(rows: torch.Tensor, p: RowBlockParams, num_heads: int, *,
                          attention_impl: str = "xla") -> torch.Tensor:
    """Pre-LN transformer block on rows (R, N, C):
    rows + MHA(LN(rows)); then + MLP(LN(.))."""
    check_attention_impl(attention_impl)
    if attention_impl == "pallas":
        return fused_row_block(rows.contiguous(), p, num_heads)
    if attention_impl == "pallas_int8":
        return fused_row_block_int8(rows.contiguous(), p, num_heads)
    if attention_impl == "pallas_attn":
        return _BilinearBlock.apply(rows, num_heads, type(p), *p)

    R, N, _ = rows.shape
    chunk = max(1, fused_block.MAX_SCORE_BYTES // (num_heads * N * N * 4))
    parts = [rows[r0:r0 + chunk] for r0 in range(0, R, chunk)]
    remat = len(parts) > 1 and torch.is_grad_enabled()
    outs = [checkpoint(_plain_block, x, p, num_heads, use_reentrant=False) if remat
            else _plain_block(x, p, num_heads) for x in parts]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


class _RowAttention(nn.Module):
    """qkv (no bias) + out-projection, named as the reference's ``attn``."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class _RowBlock(nn.Module):
    """Parameters of one row block under the reference's names:
    norm1, attn.{qkv, proj}, norm2, mlp.{0, 3}."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 attention_impl: str = "xla"):
        super().__init__()
        check_attention_impl(attention_impl)
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _RowAttention(dim)
        self.norm2 = nn.LayerNorm(dim)
        # the Dropout(0.0) only keeps the reference's state_dict names
        # (mlp.0, mlp.3); the block applies no dropout
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim))

    def params(self) -> RowBlockParams:
        return RowBlockParams(
            norm1_scale=self.norm1.weight, norm1_bias=self.norm1.bias,
            qkv_kernel=self.attn.qkv.weight.t(),
            proj_kernel=self.attn.proj.weight.t(), proj_bias=self.attn.proj.bias,
            norm2_scale=self.norm2.weight, norm2_bias=self.norm2.bias,
            fc1_kernel=self.mlp[0].weight.t(), fc1_bias=self.mlp[0].bias,
            fc2_kernel=self.mlp[3].weight.t(), fc2_bias=self.mlp[3].bias)

    def _rows(self, rows: torch.Tensor) -> torch.Tensor:
        return row_transformer_block(rows, self.params(), self.num_heads,
                                     attention_impl=self.attention_impl)


class TemporalSequenceAttention(_RowBlock):
    """TSA: attention along the H axis, one row per (batch, w) column.
    Input NHWC (B, H, W, C); rows (B*W, H, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        rows = self._rows(x.transpose(1, 2).reshape(B * W, H, C))
        return rows.reshape(B, W, H, C).transpose(1, 2)


class FrequencySequenceAttention(_RowBlock):
    """FSA: attention along the W axis, one row per (batch, h).
    Input NHWC; rows (B*H, W, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        return self._rows(x.reshape(B * H, W, C)).reshape(B, H, W, C)


class ShiftedWindowAttention(_RowBlock):
    """SW-MSA: pad to window multiples, cyclic shift, windowed attention.
    Like the reference (and the JAX default), shifted windows attend across
    the wrap-around seam: no shift mask."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 use_shift_mask: bool = False, attention_impl: str = "xla"):
        super().__init__(dim, num_heads, mlp_ratio, attention_impl)
        if use_shift_mask:
            raise NotImplementedError(
                "use_shift_mask=True (masked SWA) is not ported yet")
        self.window_size = window_size
        self.shift_size = shift_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, ss = self.window_size, self.shift_size
        pad_h = (ws - H % ws) % ws
        pad_w = (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        windows = self._rows(window_partition(x, ws))
        x = window_reverse(windows, ws, B, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_h or pad_w:
            x = x[:, :H, :W]
        return x
