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
only the rows and B4's output.

A mask (the Swin shift mask of SWA) or active dropout sends a block to the
plain route whatever ``attention_impl`` says, as in the JAX package: the
kernels have neither.  The shift mask comes in its factored form (a
4-pattern table and a pattern index a window, ``ops/windowing.py``) and is
gathered a chunk of windows at a time, so that the dense per-window mask
never exists.  Dropout (at the reference's three sites: the attention
weights, after the GELU, after fc2) is active in train mode with a seed:
each chunk builds its own ``torch.Generator`` from a seed derived outside
it (:func:`sub_seed`), so that a recompute under ``torch.utils.checkpoint``
(which replays only the default generators) draws the same masks.

``"int8"`` (``ops/int8.py``, serving only) runs each block's four dense
products in int8 with dynamic activation scales, or the static scales a
row block carries in ``act_scales`` (set by ``optimization/quantization.py``,
kept out of the state_dict); with ``act_stats`` set to a dict, a block
records the running max of the scales it used (calibration).  Masked SWA
under ``"int8"`` takes the float plain route, as in JAX.

Under tensor parallelism (``parallel/sharding.shard_model``: a row block's
``tp`` is a model axis of more than one rank) each rank holds the q, k and
v columns of its ``H / m`` heads, the matching rows of ``proj_kernel``,
its columns of fc1 (and of its bias) and rows of fc2:
  - the plain route (``"xla"``, and every masked or dropout block on any
    route) runs Megatron's form: the local heads' attention, the local
    out-projection summed over the axis, then ``+ proj_bias`` and the
    residual; LN2, the local fc1 columns and GELU, the local fc2 rows
    summed over the axis, then ``+ fc2_bias`` and the residual.  Dropout
    draws each mask whole from the block's generator and keeps its slice;
  - the kernel routes (``"pallas"``, ``"pallas_int8"``, ``"pallas_attn"``,
    ``"int8"``) gather the block's weights over the axis and run the whole
    block on every model rank (B1 fuses proj, LN2 and the MLP in one
    launch: there is no point for a sum to go); the weight gradients come
    back narrowed to the shards.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import fused_block
from ..ops.fused_block import fused_row_block, fused_row_block_int8, layer_norm_f32
from ..ops.int8 import int8_row_block
from ..ops.row_attention import dropout, flash_row_attention, mha_rows
from ..ops.windowing import swin_mask_table, window_partition, window_reverse
from ..parallel.comm import copy_to, gather_shard, reduce_from
from .layers import gelu, init_weights

ATTENTION_IMPLS = ("pallas", "pallas_int8", "pallas_attn", "xla", "int8")
# SWA's row chunk: (chunk, H, N, N) f32 scores in 32 MiB, at least 16 windows
SWA_CHUNK_BYTES = 32 * 1024 * 1024


def check_attention_impl(impl: str) -> None:
    if impl not in ATTENTION_IMPLS:
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported (the JAX package's routes, all "
            f"ported: {ATTENTION_IMPLS})")


def sub_seed(seed: int, *keys: int) -> int:
    """The seed of a part (a block, an attention, a chunk) of a dropout
    draw, from its parent's seed and the part's keys: the same arguments
    give the same seed (numpy's SeedSequence), below 2^63."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0] >> 1)


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


def _mlp_half(rows: torch.Tensor, p: RowBlockParams, dropout_rate: float = 0.0,
              generator=None, tp=None) -> torch.Tensor:
    """rows + MLP(LN2(rows)) in the rows' dtype; with ``generator``, dropout
    after the GELU and after fc2.  Under tensor parallelism (``tp``) fc1's
    columns and fc2's rows are this rank's, and fc2's product is summed
    over the axis, in f32, before its bias."""
    dt = rows.dtype
    h = _layer_norm(rows, p.norm2_scale, p.norm2_bias)
    if tp is not None:
        h = copy_to(h, tp)
    h = gelu(h @ p.fc1_kernel.to(dt) + p.fc1_bias.to(dt))
    if generator is not None:
        h = dropout(h, dropout_rate, generator) if tp is None else \
            dropout(h, dropout_rate, generator, (2, tp.index, tp.size))
    h = h @ p.fc2_kernel.to(dt)
    if tp is not None:
        h = reduce_from(h.float(), tp).to(dt)
    h = h + p.fc2_bias.to(dt)
    if generator is not None:
        h = dropout(h, dropout_rate, generator)
    return rows + h


def _plain_attn(rows: torch.Tensor, p: RowBlockParams, num_heads: int) -> torch.Tensor:
    """MHA(LN1(rows)), the plain attention."""
    normed = _layer_norm(rows, p.norm1_scale, p.norm1_bias)
    return mha_rows(normed, p.qkv_kernel, p.proj_kernel, p.proj_bias, num_heads)


def _plain_block(rows: torch.Tensor, p: RowBlockParams, num_heads: int, mask=None,
                 mask_idx=None, dropout_rate: float = 0.0, seed=None, tp=None) -> torch.Tensor:
    """The plain block on rows (R, N, C): rows + MHA(LN(rows)), then
    + MLP(LN(.)), in the rows' dtype with f32 LN statistics and softmax.
    ``mask``: an additive (R or 1, 1, N, N) mask, or with ``mask_idx`` (R,)
    a pattern table (K, 1, N, N) gathered here.  ``seed``: dropout at
    ``dropout_rate`` from a generator built here, drawn at the weights, then
    after the GELU, then after fc2.  ``tp``: Megatron tensor parallelism
    over that model axis, ``p`` holding this rank's shards (its
    ``num_heads / tp.size`` heads) and every dropout mask drawn whole."""
    if mask_idx is not None:
        mask = mask[mask_idx]
    gen = None if seed is None else torch.Generator(device=rows.device).manual_seed(seed)
    normed = _layer_norm(rows, p.norm1_scale, p.norm1_bias)
    heads = num_heads
    if tp is not None:
        normed = copy_to(normed, tp)
        heads = num_heads // tp.size
    attn = mha_rows(normed, p.qkv_kernel, p.proj_kernel, p.proj_bias, heads, mask,
                    dropout_rate, gen, tp)
    return _mlp_half(rows + attn, p, dropout_rate, gen, tp)


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
                          attention_impl: str = "xla", mask=None, dropout_rate: float = 0.0,
                          dropout_seed: Optional[int] = None,
                          chunk_rows: Optional[int] = None, tp=None) -> torch.Tensor:
    """Pre-LN transformer block on rows (R, N, C):
    rows + MHA(LN(rows)); then + MLP(LN(.)).

    ``mask``: additive, (R or 1, 1, N, N) f32, or the factored ``(table
    (K, 1, N, N), idx (R,))``.  Dropout is active with ``dropout_rate`` > 0
    and a ``dropout_seed``.  Either sends the block to the plain route, a
    chunk of ``chunk_rows`` rows at a time (default: a score plane of
    MAX_SCORE_BYTES at all ``num_heads`` heads), chunk i drawing from
    ``sub_seed(dropout_seed, i)``.  ``"int8"`` here is the plain route: the
    modules run its int8 block.  ``tp`` (a model axis of more than one
    rank, ``p`` its rank's shards) runs the plain route as Megatron tensor
    parallelism whatever the route, in the same chunks."""
    check_attention_impl(attention_impl)
    mask_idx = None
    if isinstance(mask, tuple):
        mask, mask_idx = mask
    use_dropout = dropout_rate > 0.0 and dropout_seed is not None
    if mask is None and not use_dropout and tp is None:
        if attention_impl == "pallas":
            return fused_row_block(rows.contiguous(), p, num_heads)
        if attention_impl == "pallas_int8":
            return fused_row_block_int8(rows.contiguous(), p, num_heads)
        if attention_impl == "pallas_attn":
            if torch.is_grad_enabled() and (rows.requires_grad
                                            or any(t.requires_grad for t in p)):
                return _BilinearBlock.apply(rows, num_heads, type(p), *p)
            # _BilinearBlock.forward's function, with no autograd.Function
            # around it (an exported program holds B4's custom op)
            return _mlp_half(rows + _bilinear_attn(rows, p, num_heads), p)

    R, N, _ = rows.shape
    chunk = chunk_rows or max(1, fused_block.MAX_SCORE_BYTES // (num_heads * N * N * 4))
    rate = dropout_rate if use_dropout else 0.0
    if R <= chunk:
        return _plain_block(rows, p, num_heads, mask, mask_idx, rate,
                            sub_seed(dropout_seed, 0) if use_dropout else None, tp)
    per_row = mask is not None and mask_idx is None and mask.shape[0] == R
    remat = torch.is_grad_enabled()     # else the chunks go into one output
    out = None if remat else torch.empty_like(rows)
    outs = []
    for i, r0 in enumerate(range(0, R, chunk)):
        s = slice(r0, r0 + chunk)
        m, mi = mask, None
        if mask_idx is not None:
            mi = mask_idx[s]
        elif per_row:
            m = mask[s]
        args = (rows[s], p, num_heads, m, mi, rate,
                sub_seed(dropout_seed, i) if use_dropout else None, tp)
        y = checkpoint(_plain_block, *args, use_reentrant=False) if remat else _plain_block(*args)
        if out is None:
            outs.append(y)
        else:
            out[s] = y
    if out is not None:
        return out
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None):
    """softmax(q k^T / sqrt(D)) v on (..., N, D) tensors (the JAX package's
    standalone helper, the reference's unused one): the scores in f32; a
    boolean ``mask`` keeps its True entries (``masked_fill(~mask, -inf)``),
    any other is added.  Returns (output in v's dtype, f32 weights)."""
    scores = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf")) if mask.dtype == torch.bool \
            else scores + mask
    weights = torch.softmax(scores, dim=-1)
    return weights.to(v.dtype) @ v, weights


class _RowAttention(nn.Module):
    """qkv (no bias) + out-projection, named as the reference's ``attn``."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class MultiHeadAttention(_RowAttention):
    """Standalone multi-head self-attention over (B, N, C) sequences, the
    JAX package's module (the reference's ``MultiHeadAttention``): qkv, the
    plain attention, the out-projection.  A boolean ``mask`` keeps its True
    entries (``masked_fill(~mask, -inf)``), any other is added to the
    scores; (B or 1, 1, N, N).  Dropout on the weights in train mode when
    a ``generator`` (on x's device) is given; a new module is in eval mode,
    as the JAX module is deterministic by default."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dim)
        self.num_heads = num_heads
        self.dropout = dropout
        init_weights(self, generator if generator is not None else torch.Generator())
        self.eval()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mask is not None:
            mask = torch.where(mask, 0.0, float("-inf")) if mask.dtype == torch.bool \
                else mask.float()
        active = self.training and self.dropout > 0.0 and generator is not None
        return mha_rows(x, self.qkv.weight.t(), self.proj.weight.t(), self.proj.bias,
                        self.num_heads, mask, self.dropout if active else 0.0,
                        generator if active else None)


class _RowBlock(nn.Module):
    """Parameters of one row block under the reference's names:
    norm1, attn.{qkv, proj}, norm2, mlp.{0, 3}.  ``act_scales`` and
    ``act_stats`` (the int8 route's static scales and calibration record)
    are plain attributes, out of the state_dict."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 attention_impl: str = "xla", dropout: float = 0.0):
        super().__init__()
        check_attention_impl(attention_impl)
        hidden = int(dim * mlp_ratio)
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.dropout = dropout
        # the model axis this block's weights are split over (tensor
        # parallelism, set by parallel.sharding.shard_model), or None
        self.tp = None
        self.act_scales: Optional[dict] = None
        self.act_stats: Optional[dict] = None
        self.norm1 = nn.LayerNorm(dim)
        self.attn = _RowAttention(dim)
        self.norm2 = nn.LayerNorm(dim)
        # the Dropout(0.0) only keeps the reference's state_dict names
        # (mlp.0, mlp.3); the block draws its dropout itself, from seeds
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim))

    def params(self, whole: bool = False) -> RowBlockParams:
        """The block's parameters in the JAX layout: under tensor
        parallelism this rank's shards, or with ``whole`` the weights
        gathered over the model axis (gradients narrowed back)."""
        g = lambda t, dim, parts=1: t                    # noqa: E731
        if whole and self.tp is not None:
            g = lambda t, dim, parts=1: gather_shard(t, self.tp, dim, parts)  # noqa: E731
        return RowBlockParams(
            norm1_scale=self.norm1.weight, norm1_bias=self.norm1.bias,
            qkv_kernel=g(self.attn.qkv.weight, 0, 3).t(),
            proj_kernel=g(self.attn.proj.weight, 1).t(), proj_bias=self.attn.proj.bias,
            norm2_scale=self.norm2.weight, norm2_bias=self.norm2.bias,
            fc1_kernel=g(self.mlp[0].weight, 0).t(), fc1_bias=g(self.mlp[0].bias, 0),
            fc2_kernel=g(self.mlp[3].weight, 1).t(), fc2_bias=self.mlp[3].bias)

    def _int8_block(self, rows: torch.Tensor) -> torch.Tensor:
        out, used = int8_row_block(rows, self.params(whole=True), self.num_heads,
                                   self.act_scales)
        if self.act_stats is not None:
            for k, v in used.items():
                self.act_stats[k] = v if k not in self.act_stats \
                    else torch.maximum(self.act_stats[k], v)
        return out

    def _rows(self, rows: torch.Tensor, dropout_seed: Optional[int] = None, mask=None,
              chunk_rows: Optional[int] = None) -> torch.Tensor:
        rate = self.dropout if self.training else 0.0
        plain = mask is not None or (rate > 0.0 and dropout_seed is not None)
        if self.attention_impl == "int8" and mask is None:
            return self._int8_block(rows)
        # tensor parallelism: Megatron on the plain route, else the whole
        # block on the gathered weights
        tp = self.tp if plain or self.attention_impl == "xla" else None
        return row_transformer_block(
            rows, self.params(whole=tp is None), self.num_heads,
            attention_impl=self.attention_impl, mask=mask, dropout_rate=rate,
            dropout_seed=dropout_seed, chunk_rows=chunk_rows, tp=tp)


class TemporalSequenceAttention(_RowBlock):
    """TSA: attention along the H axis, one row per (batch, w) column.
    Input NHWC (B, H, W, C); rows (B*W, H, C)."""

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        rows = self._rows(x.transpose(1, 2).reshape(B * W, H, C), dropout_seed)
        return rows.reshape(B, W, H, C).transpose(1, 2)


class FrequencySequenceAttention(_RowBlock):
    """FSA: attention along the W axis, one row per (batch, h).
    Input NHWC; rows (B*H, W, C)."""

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        return self._rows(x.reshape(B * H, W, C), dropout_seed).reshape(B, H, W, C)


@functools.lru_cache(maxsize=32)
def _shift_mask(H: int, W: int, ws: int, ss: int, device: torch.device):
    """:func:`swin_mask_table` on ``device``: table (4, 1, N, N) f32 and the
    pattern index (nW,) int64, made once per padded size and device."""
    table, idx = swin_mask_table(H, W, ws, ss)
    return (torch.from_numpy(table)[:, None].to(device),
            torch.from_numpy(idx).long().to(device))


class ShiftedWindowAttention(_RowBlock):
    """SW-MSA: pad to window multiples, cyclic shift, windowed attention.
    Like the reference (and the JAX default), shifted windows attend across
    the wrap-around seam unless ``use_shift_mask=True``, which applies the
    Swin mask (of the padded map) through the plain route."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 shift_size: int = 0, mlp_ratio: float = 4.0,
                 use_shift_mask: bool = False, attention_impl: str = "xla",
                 dropout: float = 0.0):
        super().__init__(dim, num_heads, mlp_ratio, attention_impl, dropout)
        self.window_size = window_size
        self.shift_size = shift_size
        self.use_shift_mask = use_shift_mask

    def forward(self, x: torch.Tensor, dropout_seed: Optional[int] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, ss = self.window_size, self.shift_size
        pad_h = (ws - H % ws) % ws
        pad_w = (ws - W % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        Hp, Wp = H + pad_h, W + pad_w
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
        mask = None
        if self.use_shift_mask and ss > 0:
            table, idx = _shift_mask(Hp, Wp, ws, ss, x.device)
            mask = (table, idx.repeat(B))
        N = ws * ws
        swa_chunk = max(16, SWA_CHUNK_BYTES // (self.num_heads * N * N * 4))
        windows = self._rows(window_partition(x, ws), dropout_seed, mask, swa_chunk)
        x = window_reverse(windows, ws, B, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_h or pad_w:
            x = x[:, :H, :W]
        return x
