"""Fused pre-LN row transformer block (counterpart of
``tfswa_tpu/ops/pallas/fused_block.py`` ``fused_row_block``).

For rows (R, N, C): rows + MHA(LN1(rows)), then + MLP(LN2(.)), with the TPU
kernel's arithmetic: LN statistics in f32, Wq pre-scaled by log2(e)/sqrt(D),
a max-free exp2 softmax with scores clamped at ``SCORE_CLAMP``, and the
same bf16 rounding points (see ``csrc/fused_block.cu``).

Four kernels, each with its wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``):
  - B1, serving form: :func:`fused_row_block_parts` /
    :func:`fused_row_block_reference_parts`;
  - B1-train, the forward that also exports ``mid``, ``acc`` and ``den``:
    :func:`fused_row_block_train` / :func:`fused_row_block_train_reference`;
  - B2, the whole-block VJP: :func:`fused_row_block_bwd_parts` /
    :func:`fused_row_block_bwd_reference_parts` (``csrc/fused_block_bwd.cu``;
    also the attention backward's operands and result), and
    :func:`fused_row_block_bwd` / :func:`fused_row_block_bwd_reference`;
  - B3, the serving form with int8 scores (``int8_attn=True`` of the TPU
    kernel): :func:`fused_row_block_int8` /
    :func:`fused_row_block_int8_reference`.  It has no VJP: under grad the
    wrapper raises.
Each has a bf16 form (``csrc/fused_block.cu``, ``csrc/fused_block_bwd.cu``:
tensor-core products) and an f32 form (``csrc/fused_block_f32.cu``,
``csrc/fused_block_bwd_f32.cu``: products in 3xTF32 on the tensor cores,
scores as f32 FMA chains, the TPU kernel with cd = float32), counted apart: ``<wrapper>.launches`` (bf16) and
``<wrapper>.launches_f32``.  A CPU tensor goes to the plain version; a
contiguous bf16 or f32 CUDA tensor launches the kernel of its dtype;
anything else raises.  The plain versions compute in f32 with the
kernels' rounding to ``rows.dtype`` (none in f32).

:func:`fused_row_block`, what the model calls, is differentiable: with grad
mode on and a tensor that requires a gradient it runs B1-train and saves
its residuals, and its backward runs B2 (``_FusedRowBlock``); otherwise it
runs the serving form.  The plain versions chunk over rows, so that the
(rows, H, N, N) planes they materialise stay bounded at full-width shapes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

# Max-free exp2 softmax overflow guard, in log2 units: exp2(110) * N stays
# below f32 max for N <= 2^17 keys.
SCORE_CLAMP = 110.0
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# ln 2 rounded to bf16: what XLA multiplies a bf16 argument of exp2 by
LN2_BF16 = 0.69140625
INV_SQRT_2PI = 0.3989422804014327
# What the CUDA kernels take: a width C that is a multiple of WIDTH_ALIGN
# (a bf16 row is whole 16-byte cp.async copies) up to MAX_WIDTH, any head
# count H that divides C, and an MLP hidden width that is a multiple of
# HIDDEN_ALIGN units (likewise; a last chunk of the kernels' hidden chunks
# may be ragged).  The product kernels are instantiated for PROD_WIDTHS (C
# rounded up to the next, the tiles zero past C) and the attention kernels
# for the padded head dims of head_plan (csrc/block_common.cuh).
WIDTH_ALIGN = 8
MAX_WIDTH = 512
PROD_WIDTHS = (32, 64, 128, 256, 384, 512)
HIDDEN_ALIGN = 8
# dynamic shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448
# the f32 kernels' shared memory is static: at most 48 KB a block
STATIC_SMEM_BYTES = 49152
# the row dtypes the kernels take: bf16 and f32 (3xTF32 on the tensor cores)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# The plain versions materialise f32 score planes; they chunk over rows so
# that at most this many bytes of one plane exist at once (the backward
# keeps four such planes alive, so it takes a quarter of the rows).
MAX_SCORE_BYTES = 1 << 28


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of an f32 tensor (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _ln_stats(x: torch.Tensor, eps: float = 1e-5):
    """(x - mean) * rstd and rstd over the last axis, f32."""
    mean = x.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(dim=-1, keepdim=True) + eps)
    return (x - mean) * rstd, rstd


def _ln_bwd(d_nhat: torch.Tensor, nhat: torch.Tensor, rstd: torch.Tensor) -> torch.Tensor:
    """d wrt the LN input, given d wrt nhat = (x - mean) * rstd."""
    m1 = d_nhat.mean(dim=-1, keepdim=True)
    m2 = (d_nhat * nhat).mean(dim=-1, keepdim=True)
    return rstd * (d_nhat - m1 - nhat * m2)


class HeadPlan(NamedTuple):
    """The widths of the bf16 kernels' attention at width C with H heads
    (csrc/block_common.cuh head_plan): each head's D channels padded to DP
    (D rounded up to a power of two, at least 4) in a q|k|v buffer of 3 CA
    columns, CA = H DP rounded up to 32 (HK = CA / DP heads, those past H
    all zeros)."""

    D: int
    DP: int
    CA: int
    HK: int


def prod_width(C: int) -> int:
    """The width the product kernels are instantiated for at C."""
    return next(w for w in PROD_WIDTHS if w >= C)


def head_plan(C: int, num_heads: int) -> HeadPlan:
    D = C // num_heads
    DP = 4
    while DP < D:
        DP *= 2
    CA = -(-num_heads * DP // 32) * 32
    return HeadPlan(D, DP, CA, CA // DP)


def pad_heads(t: torch.Tensor, C: int, num_heads: int) -> torch.Tensor:
    """The last axis of ``t``, k blocks of C channels in the block's layout
    (head h's channel d at h D + d), in the padded layout of
    :func:`head_plan` (k blocks of CA, zeros past each head's D channels
    and in the heads past H).  ``t`` itself where the layouts agree."""
    D, DP, CA, HK = head_plan(C, num_heads)
    if CA == C:
        return t
    k = t.shape[-1] // C
    out = t.new_zeros(*t.shape[:-1], k, HK, DP)
    out[..., :num_heads, :D] = t.unflatten(-1, (k, num_heads, D))
    return out.flatten(-3).contiguous()


def unpad_heads(t: torch.Tensor, C: int, num_heads: int) -> torch.Tensor:
    """The inverse of :func:`pad_heads`: a padded kernel buffer (q|k|v, the
    int8 q|k, d_oe) in the block's layout, as the plain versions take it."""
    D, DP, CA, HK = head_plan(C, num_heads)
    if CA == C:
        return t
    k = t.shape[-1] // CA
    return t.unflatten(-1, (k, HK, DP))[..., :num_heads, :D].flatten(-3)


def _qk_scale(C: int, num_heads: int) -> float:
    return (C // num_heads) ** -0.5 * LOG2E


def _block_weights(p, C: int, num_heads: int, dtype: torch.dtype):
    """Weights in the compute dtype, Wq pre-scaled (in f32, then rounded):
    (ln1_s, ln1_b, w_qkv (C, 3C), w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2)."""
    scale = _qk_scale(C, num_heads)
    w_qkv = torch.cat([p.qkv_kernel[:, :C].float() * scale,
                       p.qkv_kernel[:, C:].float()], dim=1)
    ws = (p.norm1_scale, p.norm1_bias, w_qkv, p.proj_kernel, p.proj_bias,
          p.norm2_scale, p.norm2_bias, p.fc1_kernel, p.fc1_bias,
          p.fc2_kernel, p.fc2_bias)
    return tuple(w.to(dtype).contiguous() for w in ws)


def _qkv_heads(normed, w_qkv, rnd, H: int, qkv, t0: int):
    """q, k, v (3, Rc, H, N, D) of a chunk of rows from its rounded LN1
    output: rnd(normed @ Wqkv'), or the given ``qkv`` (its tokens t0.. of an
    (R*N, 3C) tensor)."""
    Rc, N, C = normed.shape
    t = rnd(normed @ w_qkv) if qkv is None else qkv[t0:t0 + Rc * N].float()
    return t.view(Rc, N, 3, H, C // H).permute(2, 0, 3, 1, 4)


def quantize_rows(t: torch.Tensor):
    """B3's symmetric int8 quantisation, one scale per index of the leading
    axis over all other elements: ``s = max|t| / 127`` in f32 and
    ``round(t / s)`` (a true division, rounded half to even).  Returns the
    int8 values as f32 and ``s``.  A slice that is all zero has s = 0 and
    gets 0, produced explicitly (the TPU kernel computes 0/0 and casts the
    NaN to int8).  The divisor 127 is a tensor: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, which is not the true
    division the TPU kernel and the CUDA kernel do."""
    m = t.abs().amax(dim=tuple(range(1, t.dim())), keepdim=True)
    s = m / torch.full_like(m, 127.0)
    nz = s > 0
    return torch.where(nz, torch.round(t / torch.where(nz, s, 1.0)), 0.0), s


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _reference_forward(rows: torch.Tensor, p, num_heads: int, train: bool, qkv=None,
                       int8_attn: bool = False, stage: str = "full",
                       score_bf16: bool = False, p_f32: bool = False, clamp: bool = True):
    """The plain forward in f32 arithmetic with the kernel's rounding to
    ``rows.dtype``: (out, acc) and, with ``train``, (mid, den) as well.
    ``qkv`` (R*N, 3C), if given, replaces the recomputed q|k|v.
    ``int8_attn`` (B3) takes the scores from q and k quantised per row
    (:func:`quantize_rows`): int8 products summed exactly (at most
    32 * 127^2 < 2^24, so an f32 sum of them is exact in any order), times
    sq * sk.  v, p and the AV sums stay as in B1.

    The kernel lab's forms (``ops/lab_block.py``): ``stage`` other than
    "full" cuts the block and returns ``(cut, None)``, the cut in
    ``rows.dtype`` (see ``lab_block.STAGES``); ``score_bf16`` takes p from
    the bf16-rounded clamped score as the JAX package computes exp2 of a
    bf16 value: XLA lowers it as exp(bf16(x * LN2_BF16)), p then rounded to
    ``rows.dtype`` (and to bf16 even with ``p_f32``); ``p_f32`` leaves p
    unrounded; ``clamp=False`` drops the SCORE_CLAMP guard."""
    R, N, C = rows.shape
    H = num_heads
    D = C // H
    dt = rows.dtype
    (ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
     b_2) = (w.float() for w in _block_weights(p, C, H, dt))

    def rnd(t):
        return t.to(dt).float()

    chunk = max(1, MAX_SCORE_BYTES // (H * N * N * 4))
    outs, attns, mids, dens = [], [], [], []
    for r0 in range(0, R, chunk):
        x = rows[r0:r0 + chunk].float()
        Rc = x.shape[0]
        n1 = rnd(layer_norm_f32(x, ln1_s, ln1_b))
        q, k, v = _qkv_heads(n1, w_qkv, rnd, H, qkv, r0 * N)  # (Rc, H, N, D) each
        if stage == "qkv":
            outs.append((q + k + v).transpose(1, 2).reshape(Rc, N, C).to(dt))
            continue
        if int8_attn:
            (qi, sq), (ki, sk) = quantize_rows(q), quantize_rows(k)
            s = (qi @ ki.transpose(-1, -2)) * (sq * sk)
        else:
            s = q @ k.transpose(-1, -2)
        if stage == "scores":            # sum over heads of s[.., query n, key c], c < min(C, N)
            w = min(C, N)
            cut = torch.zeros(Rc, N, C, device=rows.device)
            for h in range(H):
                cut[..., :w] = cut[..., :w] + s[:, h, :, :w]
            outs.append(cut.to(dt))
            continue
        sc = s.clamp(max=SCORE_CLAMP) if clamp else s
        if score_bf16:
            prob = rnd(torch.exp(_bf16(_bf16(sc) * LN2_BF16)))
        else:
            prob = torch.exp2(sc)
            prob = prob if p_f32 else rnd(prob)
        if stage == "exp2":              # [r, key j, h*D + d] = p_h[r, query d, key j]
            outs.append(prob[:, :, :D, :].permute(0, 3, 1, 2).reshape(Rc, N, C).to(dt))
            continue
        den = prob.sum(dim=-1, keepdim=True)
        acc = (prob @ v) / den
        if stage == "av":                # the f32 attention output summed over queries
            red = acc.sum(dim=2).reshape(Rc, 1, C)
            outs.append(red.expand(Rc, N, C).to(dt))
            continue
        acc = rnd(acc.transpose(1, 2).reshape(Rc, N, C))
        y = x + (acc @ w_o + b_o)
        if stage == "attn":
            outs.append(y.to(dt))
            continue
        n2 = rnd(layer_norm_f32(y, ln2_s, ln2_b))
        h1 = rnd(F.gelu(n2 @ w_1 + b_1))
        outs.append((y + (h1 @ w_2 + b_2)).to(dt))
        attns.append(acc.to(dt))
        if train:
            mids.append(y.to(dt))
            dens.append(den[..., 0])
    if stage != "full":
        return torch.cat(outs), None
    if train:
        return torch.cat(outs), torch.cat(attns), torch.cat(mids), torch.cat(dens)
    return torch.cat(outs), torch.cat(attns)


def fused_row_block_reference_parts(rows: torch.Tensor, p, num_heads: int, qkv=None):
    """Plain PyTorch version of B1: the block's output and its attention
    output before the out-projection, both (R, N, C) in ``rows.dtype``.
    ``qkv``: see :func:`fused_row_block_bwd_reference`."""
    return _reference_forward(rows, p, num_heads, train=False, qkv=qkv)


def fused_row_block_reference(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """The block's output from :func:`fused_row_block_reference_parts`."""
    return fused_row_block_reference_parts(rows, p, num_heads)[0]


def fused_row_block_int8_reference_parts(rows: torch.Tensor, p, num_heads: int, qkv=None):
    """Plain PyTorch version of B3: the block's output and its attention
    output, as :func:`fused_row_block_reference_parts` with the scores of
    int8 q and k.  ``qkv``: see :func:`fused_row_block_bwd_reference`."""
    return _reference_forward(rows, p, num_heads, train=False, qkv=qkv, int8_attn=True)


def fused_row_block_int8_reference(rows: torch.Tensor, p, num_heads: int,
                                   qkv=None) -> torch.Tensor:
    """The block's output from :func:`fused_row_block_int8_reference_parts`."""
    return fused_row_block_int8_reference_parts(rows, p, num_heads, qkv)[0]


def fused_row_block_train_reference(rows: torch.Tensor, p, num_heads: int, qkv=None):
    """Plain PyTorch version of B1-train: ``(out, mid, acc, den)``, where
    ``mid`` is the residual stream after the attention half rounded to
    ``rows.dtype``, ``acc`` the attention output before the out-projection
    and ``den`` (R, H, N) f32 the softmax denominators (the sum of the
    rounded p per query).  ``qkv``: see :func:`fused_row_block_bwd_reference`."""
    out, acc, mid, den = _reference_forward(rows, p, num_heads, train=True, qkv=qkv)
    return out, mid, acc, den


class BwdParts(NamedTuple):
    """What B2 computes: ``dx`` (R, N, C) in ``rows.dtype`` and ``dp`` (a
    RowBlockParams of f32 gradients), and the attention backward's operands
    and result: ``d_oe`` (R, N, C; the bf16 kernel's (R, N, CA), see
    :func:`fused_row_block_bwd_parts`) and ``d_den`` (R, N, H) f32, both
    with values of ``rows.dtype``, and ``dqkv`` (R, N, 3C) in
    ``rows.dtype``, the gradients of the (pre-scaled) q, k and v."""

    dx: torch.Tensor
    dp: object
    d_oe: torch.Tensor
    d_den: torch.Tensor
    dqkv: torch.Tensor


def fused_row_block_bwd_reference_parts(rows: torch.Tensor, mid: torch.Tensor,
                                        acc: torch.Tensor, den: torch.Tensor,
                                        g: torch.Tensor, p, num_heads: int, qkv=None,
                                        d_oe=None, d_den=None) -> BwdParts:
    """Plain PyTorch version of B2: the block's VJP at cotangent ``g``,
    written out (not ``torch.autograd``) in f32 arithmetic with the TPU
    kernel's rounding to ``rows.dtype``:
      - LN2 statistics from the rounded ``mid``; ``d_mid`` in f32, rounded
        only as a product operand;
      - d_oe = rnd(d_acc / den), d_den = rnd(-(1/den) * sum_D(d_acc * acc));
      - p in f32 for d_s = where(s < SCORE_CLAMP, d_p * p * ln 2, 0) with
        d_p = d_oe v^T + d_den, rounded for d_v;
      - d_q, d_k, d_v summed in f32, then rounded.
    Returns :class:`BwdParts`; ``dp`` in the parameters' layout (d qkv[:, :C]
    re-scaled).

    ``qkv`` (R*N, 3C) in ``rows.dtype``, if given, is used instead of the
    recomputed q|k|v, and ``d_oe`` (R, N, C) and ``d_den`` (R, N, H), if
    given, instead of the computed ones.  A check on the card passes the
    kernel's own: a rounding of q or k that flips between two summation
    orders moves a peaked softmax by percents and a score past SCORE_CLAMP
    across it, so only shared q, k, v leave the attention's own arithmetic
    to compare (and shared d_oe, d_den the attention backward's alone)."""
    if (d_oe is None) != (d_den is None):
        raise ValueError("fused_row_block_bwd_reference_parts: give d_oe and d_den together")
    R, N, C = rows.shape
    H = num_heads
    D = C // H
    dt = rows.dtype
    hidden = p.fc1_kernel.shape[1]
    (ln1_s, ln1_b, w_qkv, w_o, _, ln2_s, ln2_b, w_1, b_1, w_2,
     _) = (w.float() for w in _block_weights(p, C, H, dt))

    def rnd(t):
        return t.to(dt).float()

    def tsum(a, b):                                       # sum over tokens of a^T b
        return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])

    z = lambda *s: torch.zeros(*s, dtype=torch.float32, device=rows.device)  # noqa: E731
    dln1s, dln1b, dob, dln2s, dln2b, df2b = (z(C) for _ in range(6))
    dwqkv, dwo, dfc1, df1b, dfc2 = z(C, 3 * C), z(C, C), z(C, hidden), z(hidden), z(hidden, C)
    dxs, d_oes, d_dens, dqkvs = [], [], [], []
    chunk = max(1, MAX_SCORE_BYTES // (4 * H * N * N * 4))
    for r0 in range(0, R, chunk):
        sl = slice(r0, r0 + chunk)
        x, gf, midf, accf = (t[sl].float() for t in (rows, g, mid, acc))
        Rc = x.shape[0]
        # LN2 + MLP recompute from mid, then its VJP (out = mid + h2)
        nhat2, rstd2 = _ln_stats(midf)
        n2c = rnd(nhat2 * ln2_s + ln2_b)
        h1pre = n2c @ w_1 + b_1
        gl = 0.5 * (1.0 + torch.erf(h1pre * 0.5 ** 0.5))
        h1c = rnd(h1pre * gl)
        gc = rnd(gf)
        d_h1 = gc @ w_2.t()
        dfc2 += tsum(h1c, gc)
        df2b += gf.sum(dim=(0, 1))
        d_h1pre = d_h1 * (gl + h1pre * torch.exp(-0.5 * h1pre * h1pre) * INV_SQRT_2PI)
        d_h1c = rnd(d_h1pre)
        df1b += d_h1pre.sum(dim=(0, 1))
        dfc1 += tsum(n2c, d_h1c)
        d_n2 = d_h1c @ w_1.t()
        dln2s += (d_n2 * nhat2).sum(dim=(0, 1))
        dln2b += d_n2.sum(dim=(0, 1))
        d_mid = gf + _ln_bwd(d_n2 * ln2_s, nhat2, rstd2)
        # attention half: mid = x + acc @ wo + ob
        d_midc = rnd(d_mid)
        dob += d_mid.sum(dim=(0, 1))
        dwo += tsum(accf, d_midc)
        d_acc = d_midc @ w_o.t()
        # LN1 / q / k / v recompute
        nhat1, rstd1 = _ln_stats(x)
        normed = rnd(nhat1 * ln1_s + ln1_b)
        q, k, v = _qkv_heads(normed, w_qkv, rnd, H, qkv, r0 * N)
        heads = lambda t: t.view(Rc, N, H, D).transpose(1, 2)  # noqa: E731
        if d_oe is None:
            r_h = 1.0 / den[sl].unsqueeze(-1)                 # (Rc, H, N, 1)
            d_acc_h = heads(d_acc)
            d_oe_h = rnd(d_acc_h * r_h)
            d_den_h = rnd(-r_h * (d_acc_h * heads(accf)).sum(dim=-1, keepdim=True))
        else:
            d_oe_h = heads(d_oe[sl].float())
            d_den_h = d_den[sl].float().transpose(1, 2).unsqueeze(-1)
        s = q @ k.transpose(-1, -2)                           # (Rc, H, Nq, Nk)
        prob = torch.exp2(s.clamp(max=SCORE_CLAMP))
        d_p = d_oe_h @ v.transpose(-1, -2) + d_den_h
        d_sc = rnd(torch.where(s < SCORE_CLAMP, d_p * prob * LN2, 0.0))
        del d_p, s
        d_q = d_sc @ k
        d_k = d_sc.transpose(-1, -2) @ q
        d_v = rnd(prob).transpose(-1, -2) @ d_oe_h
        del d_sc, prob
        dqkv = rnd(torch.stack([d_q, d_k, d_v]).permute(1, 3, 0, 2, 4).reshape(Rc, N, 3 * C))
        d_normed = dqkv @ w_qkv.t()
        dwqkv += tsum(normed, dqkv)
        dln1s += (d_normed * nhat1).sum(dim=(0, 1))
        dln1b += d_normed.sum(dim=(0, 1))
        dxs.append((d_mid + _ln_bwd(d_normed * ln1_s, nhat1, rstd1)).to(dt))
        d_oes.append(d_oe_h.transpose(1, 2).reshape(Rc, N, C).to(dt))
        d_dens.append(d_den_h[..., 0].transpose(1, 2))
        dqkvs.append(dqkv.to(dt))
    dwqkv[:, :C] *= _qk_scale(C, H)
    dp = type(p)(dln1s, dln1b, dwqkv, dwo, dob, dln2s, dln2b, dfc1, df1b, dfc2, df2b)
    return BwdParts(torch.cat(dxs), dp, torch.cat(d_oes), torch.cat(d_dens), torch.cat(dqkvs))


def fused_row_block_bwd_reference(rows: torch.Tensor, mid: torch.Tensor,
                                  acc: torch.Tensor, den: torch.Tensor,
                                  g: torch.Tensor, p, num_heads: int, qkv=None):
    """``(dx, dp)`` of :func:`fused_row_block_bwd_reference_parts`: dx in
    ``rows.dtype`` and a RowBlockParams of f32 gradients in the parameters'
    layout."""
    res = fused_row_block_bwd_reference_parts(rows, mid, acc, den, g, p, num_heads, qkv)
    return res.dx, res.dp


def _attn_smem_bytes(C: int, num_heads: int) -> int:
    """Shared memory of the bf16 attention launches at width C with H heads
    (csrc/fused_block.cu, csrc/fused_block_bwd.cu): up to DP = 32
    attn_kernel two 128-key tiles of 64 bf16 channels and two of 32 int8
    channels (rows padded by 16 bytes) and a 1 KB sum, attn_bwd_kv_kernel
    (the larger of the attention backward's two) two 128-token tiles of two
    tensors' 32 channels (16 where D < 16) and their d_den; above,
    attn_wide_kernel 128 queries' q (bf16 or int8), two AK-key tiles of k
    and of an OW-channel part of v, and 8 x OW f32 sums (OW = min(DP, 128),
    AK = 32 at DP = 512, else 64), and attn_bwd_{q,kv}_wide_kernel 64 own
    rows of two tensors' DP channels and two AK-token tiles of two tensors
    (AK 16, 32, 64 at DP 512, 256, less) and their d_den."""
    DP = head_plan(C, num_heads).DP
    if DP <= 32:
        return max(2 * 2 * 128 * 72 + 2 * 128 * 48 + 4 * 8 * 32,
                   2 * 2 * 128 * 72 + 4 * 2 * 4 * 128)
    ow = min(DP, 128)
    ak = 32 if DP >= 512 else 64
    fwd = (max(2 * (128 + 2 * ak) * (DP + 8), (128 + 2 * ak) * (DP + 16))
           + 2 * 2 * ak * (ow + 8) + 4 * 8 * ow)
    akb = 16 if DP >= 512 else 32 if DP >= 256 else 64
    bwd = 2 * (2 * 64 * (DP + 8) + 2 * 2 * akb * (DP + 8)) + 4 * 2 * akb
    return max(fwd, bwd)


def kernel_smem_bytes(C: int, hidden: Optional[int] = None,
                      dtype: torch.dtype = torch.bfloat16,
                      num_heads: Optional[int] = None) -> int:
    """Shared memory of the largest launch of B1 and B2 at width C, MLP
    width ``hidden`` (default 4 C) and ``num_heads`` heads (default: the
    largest over every H dividing C) in ``dtype``.  float32, from the
    layouts of csrc/block_f32.cuh, fused_block_f32.cu and
    fused_block_bwd_f32.cu (static shared memory, words of 4 bytes, rows
    padded by 4 or 8): gemm_kernel a ring of three k-slices of a 128 x 16 A
    tile and a 16 x 64 B tile, atb_kernel three of 16 x 64 each; attn_kernel
    64 keys of a 32-channel chunk of k (raw) and of v (split: big and
    small), and B3's 64 int8 key rows; attn_bwd_{q,kv}_kernel 32 tokens of
    two split tensors and one raw, and their d_den; the forms for D <= 8
    (attn_ffma_kernel, attn_bwd_{q,kv}_ffma_kernel) 128 tokens of two
    tensors' 8 channels.  None depends on C, the MLP width or N.
    bfloat16, from the layouts in csrc/, at CP = prod_width(C) and T = 64
    tokens a tile (32 at CP >= 384; RG = T / 16 row groups, CS = 8 / RG
    column parts): ln_qkv_kernel holds 64 rows of bf16 n1 and two 32-row
    slices of 96 weight columns; post_kernel T rows of f32 y, of bf16 acc /
    n2 and of a 128-unit GELU chunk, and two 32-row weight slices;
    mlp_bwd_kernel T rows of bf16 g, n2 and mid and of a 64-unit d_h1
    chunk, two 32-row weight slices, and f32 sums: the block's vector
    partials (4 CP + hidden), 4 RG CP + 64 RG of column sums and (2 + 2 CS)
    T of row statistics (rows padded by 8); ln1_bwd_kernel T rows of bf16
    dqkv (3 CP) and x, two 32-row weight slices, and f32 sums: the block's
    two vector partials (2 CP), 2 RG CP of column sums and (2 + 2 CS) T of
    row statistics; the attention's (:func:`_attn_smem_bytes`).  No
    launch's shared memory depends on N."""
    if dtype == torch.float32:
        gemm = 4 * 3 * (128 * (16 + 4) + 16 * (64 + 8))
        atb = 4 * 3 * 2 * 16 * (64 + 8)
        attn = 4 * (64 * 36 + 2 * 64 * 36 + 12)
        attn_bwd = 4 * (2 * 2 * 32 * 36 + 32 * 36 + 32)
        return max(gemm, atb, attn, attn_bwd)
    hidden = 4 * C if hidden is None else hidden
    cp = prod_width(C)
    t = 32 if cp >= 384 else 64
    rg = t // 16
    cs = 8 // rg
    heads = [num_heads] if num_heads else [h for h in range(1, C + 1) if C % h == 0]
    ln_qkv = 2 * (64 * (cp + 8) + 2 * 32 * (96 + 8))
    attn = max(_attn_smem_bytes(C, h) for h in heads)
    post = 4 * t * (cp + 8) + 2 * (t * (cp + 8) + 2 * 32 * (max(cp, 128) + 8) + t * (128 + 8))
    mlp_bwd = (2 * (3 * t * (cp + 8) + t * (64 + 8) + 2 * 32 * (max(cp, 64) + 8))
               + 4 * (4 * cp + hidden + 4 * rg * cp + rg * 64 + 2 * t + 2 * cs * t))
    ln1_bwd = (2 * (t * (3 * cp + 8) + t * (cp + 8) + 2 * 32 * (cp + 8))
               + 4 * (2 * cp + 2 * rg * cp + 2 * t + 2 * cs * t))
    return max(ln_qkv, attn, post, mlp_bwd, ln1_bwd)


def check_shape(name: str, R: int, N: int, C: int, num_heads: int, hidden: int,
                dtype: torch.dtype = torch.bfloat16) -> None:
    """The shapes the CUDA kernels of ``dtype`` take: raise ValueError on
    any other."""
    if C <= 0 or C % WIDTH_ALIGN or C > MAX_WIDTH:
        raise ValueError(f"{name}: no kernel for C={C} (C a multiple of {WIDTH_ALIGN} up to "
                         f"{MAX_WIDTH})")
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"{name}: no kernel for {num_heads} heads at C={C} (the head count "
                         "divides C)")
    if hidden <= 0 or hidden % HIDDEN_ALIGN:
        raise ValueError(f"{name}: no kernel for an MLP of {hidden} units (a multiple of "
                         f"{HIDDEN_ALIGN})")
    limit = STATIC_SMEM_BYTES if dtype == torch.float32 else MAX_SMEM_BYTES
    if kernel_smem_bytes(C, hidden, dtype, num_heads) > limit:
        raise ValueError(f"{name}: C={C}, an MLP of {hidden} units, does not fit the "
                         "kernels' shared memory")
    if R * N * max(3 * head_plan(C, num_heads).CA, hidden) >= 2 ** 31:
        raise ValueError(f"{name}: too many tokens for 32-bit counts")


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    fn = lib.fused_block_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd")
    fn = lib.fused_block_backward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sz = lib.fused_block_backward_scratch_bytes
        sz.argtypes = [ctypes.c_int] * 5
        sz.restype = ctypes.c_size_t
        off = lib.fused_block_backward_part_offsets
        off.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        off.restype = None
    return lib


def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("fused_block_f32")
    fn = lib.fused_block_forward_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib_f32() -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd_f32")
    fn = lib.fused_block_backward_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sz = lib.fused_block_backward_f32_scratch_bytes
        sz.argtypes = [ctypes.c_int] * 5
        sz.restype = ctypes.c_size_t
        off = lib.fused_block_backward_f32_part_offsets
        off.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
        off.restype = None
    return lib


def _on_stream(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``dev`` the current device and its current
    stream (the libraries launch on the current device)."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _check_cuda(name: str, rows: torch.Tensor, num_heads: int, p, like=(),
                den=None, dtypes=KERNEL_DTYPES, pointers: bool = True) -> None:
    """What the CUDA kernels take (rows of one of ``dtypes``): raise on
    anything else, before any of ``p`` (a RowBlockParams) is read but its
    shapes.  ``pointers=False`` leaves out the 16-byte alignment (a traced
    tensor, as torch.export's, has no memory)."""
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if rows.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name}: the kernel takes {names}, got {rows.dtype}")
    if rows.dim() != 3 or not rows.is_contiguous() or (pointers and rows.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be a contiguous, 16-byte aligned (R, N, C) tensor")
    R, N, C = rows.shape
    check_shape(name, R, N, C, num_heads, p.fc1_kernel.shape[1], rows.dtype)
    for t in like:
        if (t.shape != rows.shape or t.dtype != rows.dtype or t.device != rows.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: saved tensors must be contiguous, 16-byte aligned "
                             "and of the rows' dtype")
    if den is not None and (den.shape != (R, num_heads, N) or den.dtype != torch.float32
                            or den.device != rows.device or not den.is_contiguous()):
        raise ValueError(f"{name}: den must be a contiguous f32 (R, H, N) tensor")
    if any(w.device != rows.device for w in p):
        raise ValueError(f"{name}: parameters are not on the rows' device")


class _Launch(NamedTuple):
    """What one launch of fused_block_forward wrote: the block's output, its
    attention output, the q|k|v buffer (a check feeds it to the plain
    versions); B1-train's mid and den; B3's (R, 2) f32 row scales of q and
    k and its int8 q | k.  None where the form does not write it.  The bf16
    kernels' q|k|v (R*N, 3 CA) and q | k (R*N, 2 CA) are in the padded head
    layout of :func:`head_plan` (:func:`unpad_heads` gives the block's
    (R*N, 3C), (R*N, 2C)); the f32 kernels' are in the block's layout."""

    out: torch.Tensor
    attn: torch.Tensor
    qkv: torch.Tensor
    mid: Optional[torch.Tensor]
    den: Optional[torch.Tensor]
    scales: Optional[torch.Tensor]
    qk: Optional[torch.Tensor]


def _forward_kernel(rows: torch.Tensor, p, num_heads: int, train: bool = False,
                    int8: bool = False) -> _Launch:
    """One launch of fused_block_forward (bf16 rows) or
    fused_block_forward_f32 (f32 rows): B1, B1-train (``train``) or B3
    (``int8``)."""
    name = ("fused_row_block_train" if train else
            "fused_row_block_int8" if int8 else "fused_row_block")
    if train and int8:
        raise ValueError(f"{name}: the int8-score form is serving only")
    _check_cuda(name, rows, num_heads, p)
    weights = _block_weights(p, rows.shape[2], num_heads, rows.dtype)
    if rows.dtype == torch.float32:
        return _forward_kernel_f32(name, rows, weights, num_heads, train, int8)
    R, N, C = rows.shape
    hidden = weights[7].shape[1]
    dev = rows.device
    plan = head_plan(C, num_heads)
    weights = (*weights[:2], pad_heads(weights[2], C, num_heads), *weights[3:])

    def buf(shape, dtype, on=True):
        return torch.empty(shape, dtype=dtype, device=dev) if on else None

    res = _Launch(out=torch.empty_like(rows), attn=buf((R, N, C), rows.dtype),
                  qkv=buf((R * N, 3 * plan.CA), rows.dtype),
                  mid=buf((R, N, C), rows.dtype, train),
                  den=buf((R, num_heads, N), torch.float32, train),
                  scales=buf((R, 2), torch.float32, int8),
                  qk=buf((R * N, 2 * plan.CA), torch.int8, int8))

    def ptr(t):
        return None if t is None else t.data_ptr()

    # scratch: the rows' largest |k_h|, then the attention's fix-up list (2 R + 1 ints)
    kmax = buf((R * plan.HK + 2 * R + 1,), torch.float32)
    err = _on_stream(dev, _lib().fused_block_forward,
                     rows.data_ptr(), *(w.data_ptr() for w in weights),
                     ptr(res.qkv), ptr(kmax), ptr(res.attn), ptr(res.out), ptr(res.mid),
                     ptr(res.den), ptr(res.scales), ptr(res.qk), R, N, C, num_heads, hidden)
    if err != 0:
        raise RuntimeError(f"fused_block_forward ({name}) failed: CUDA error {err}")
    return res


def _forward_kernel_f32(name: str, rows: torch.Tensor, weights, num_heads: int, train: bool,
                        int8: bool) -> _Launch:
    """One launch of fused_block_forward_f32 on checked f32 rows and the
    weights of :func:`_block_weights` in f32.  B1-train's mid is the
    kernel's y, which B1 and B3 keep in a scratch buffer."""
    R, N, C = rows.shape
    hidden = weights[7].shape[1]
    M = R * N

    def buf(shape, dtype=torch.float32, on=True):
        return torch.empty(shape, dtype=dtype, device=rows.device) if on else None

    res = _Launch(out=torch.empty_like(rows), attn=buf((R, N, C)), qkv=buf((M, 3 * C)),
                  mid=buf((R, N, C), on=train), den=buf((R, num_heads, N), on=train),
                  scales=buf((R, 2), on=int8), qk=buf((M, 2 * C), torch.int8, int8))
    y = res.mid if train else buf((R, N, C))
    stats, hbuf = buf((4 * M,)), buf((M, hidden))

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _on_stream(rows.device, _lib_f32().fused_block_forward_f32,
                     rows.data_ptr(), *(w.data_ptr() for w in weights), res.qkv.data_ptr(),
                     stats.data_ptr(), y.data_ptr(), hbuf.data_ptr(), res.attn.data_ptr(),
                     res.out.data_ptr(), ptr(res.den), ptr(res.scales), ptr(res.qk),
                     R, N, C, num_heads, hidden)
    if err != 0:
        raise RuntimeError(f"fused_block_forward_f32 ({name}) failed: CUDA error {err}")
    return res


def _check_op_args(name: str, rows: torch.Tensor, num_heads: int, p) -> None:
    """What the kernels take, checked before a CUDA tensor reaches its
    custom op (the alignment left out: a tensor being exported has no
    memory; the launch checks it)."""
    if rows.device.type != "cpu":
        _check_cuda(name, rows, num_heads, p, pointers=False)


def _count(wrapper, dtype: torch.dtype) -> None:
    """One more launch of ``wrapper``'s kernel of ``dtype``."""
    if dtype == torch.float32:
        wrapper.launches_f32 += 1
    else:
        wrapper.launches += 1


def fused_row_block_int8(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """B3, the block's output with int8 scores, the wrapper the
    ``"pallas_int8"`` route calls, through the custom op
    ``tfswa::fused_row_block_int8`` (``ops/custom_ops.py``): the plain
    version on a CPU tensor.
    Counts each launch in ``fused_row_block_int8.launches`` (bf16) or
    ``.launches_f32``.  Serving only,
    as in the JAX package (no VJP): when grad mode is on and ``rows`` or a
    parameter requires a gradient it raises, rather than return a result
    that no gradient reaches."""
    if torch.is_grad_enabled() and (rows.requires_grad or any(t.requires_grad for t in p)):
        raise RuntimeError("fused_row_block_int8 (attention_impl='pallas_int8') is "
                           "serving only and has no gradient: train with 'pallas', "
                           "'pallas_attn' or 'xla'")
    _check_op_args("fused_row_block_int8", rows, num_heads, p)
    from .custom_ops import fused_row_block_int8 as op

    return op(rows, list(p), num_heads)


def fused_row_block_int8_run(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """B3 with no autograd check: the plain version on a CPU tensor, the
    kernel (counted) on a CUDA one; what ``tfswa::fused_row_block_int8``
    runs."""
    if rows.device.type == "cpu":
        return fused_row_block_int8_reference(rows, p, num_heads)
    out = _forward_kernel(rows, p, num_heads, int8=True).out
    _count(fused_row_block_int8, rows.dtype)
    return out


def fused_row_block_parts(rows: torch.Tensor, p, num_heads: int):
    """B1, serving form: the whole pre-LN block over rows (R, N, C); ``p``
    is a RowBlockParams.  Returns the block's output and its attention
    output before the out-projection (what a check of the attention alone
    compares), both (R, N, C).  Counts each launch in
    ``fused_row_block.launches`` (bf16) or ``.launches_f32``."""
    if rows.device.type == "cpu":
        return fused_row_block_reference_parts(rows, p, num_heads)
    res = _forward_kernel(rows, p, num_heads)
    _count(fused_row_block, rows.dtype)
    return res.out, res.attn


def fused_row_block_train(rows: torch.Tensor, p, num_heads: int):
    """B1-train: ``(out, mid, acc, den)`` as
    :func:`fused_row_block_train_reference` gives them.  Counts each launch
    in ``fused_row_block_train.launches`` (bf16) or ``.launches_f32``."""
    if rows.device.type == "cpu":
        return fused_row_block_train_reference(rows, p, num_heads)
    res = _forward_kernel(rows, p, num_heads, train=True)
    _count(fused_row_block_train, rows.dtype)
    return res.out, res.mid, res.attn, res.den


def fused_row_block_bwd_parts(rows: torch.Tensor, mid: torch.Tensor, acc: torch.Tensor,
                              den: torch.Tensor, g: torch.Tensor, p, num_heads: int) -> BwdParts:
    """B2: the block's VJP from B1-train's residuals, :class:`BwdParts` as
    :func:`fused_row_block_bwd_reference_parts` gives them (on the card
    ``d_oe``, ``d_den`` and ``dqkv`` are views of the launch's scratch
    buffer; the bf16 kernel's ``d_oe`` is (R, N, CA) in the padded head
    layout of :func:`head_plan`, which :func:`unpad_heads` turns into the
    block's (R, N, C)).  Counts each launch in
    ``fused_row_block_bwd.launches`` (bf16) or ``.launches_f32``."""
    if rows.device.type == "cpu":
        return fused_row_block_bwd_reference_parts(rows, mid, acc, den, g, p, num_heads)
    res = _bwd_kernel(rows, mid, acc, den, g, p, num_heads)
    _count(fused_row_block_bwd, rows.dtype)
    return res


def _bwd_kernel(rows: torch.Tensor, mid: torch.Tensor, acc: torch.Tensor, den: torch.Tensor,
                g: torch.Tensor, p, num_heads: int) -> BwdParts:
    """One launch of fused_block_backward (bf16 rows) or
    fused_block_backward_f32 (f32 rows).  The bf16 kernel recomputes q|k|v
    with W_qkv's heads padded (:func:`head_plan`) and takes W_qkv^T in the
    block's layout; its d_oe is in the padded layout."""
    H = num_heads
    _check_cuda("fused_row_block_bwd", rows, H, p, like=(mid, acc, g), den=den)
    R, N, C = rows.shape
    weights = _block_weights(p, C, H, rows.dtype)
    ln1_s, ln1_b, w_qkv, w_o, _, ln2_s, ln2_b, w_1, b_1, w_2, _ = weights
    hidden = w_1.shape[1]
    # transposed copies, so that every product reads its weight by columns
    w_qkv_t, w_o_t, w_1_t, w_2_t = (w.t().contiguous() for w in (w_qkv, w_o, w_1, w_2))
    f32 = rows.dtype == torch.float32
    if not f32:
        w_qkv = pad_heads(w_qkv, C, H)
    lib = _bwd_lib_f32() if f32 else _bwd_lib()
    sfx = "_f32" if f32 else ""
    size = getattr(lib, f"fused_block_backward{sfx}_scratch_bytes")(R, N, C, H, hidden)
    scratch = torch.empty(size, dtype=torch.uint8, device=rows.device)
    sizes = [C, C, 3 * C * C, C * C, C, C, C, C * hidden, hidden, hidden * C, C]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=rows.device)
    dx = torch.empty_like(rows)
    err = _on_stream(rows.device, getattr(lib, f"fused_block_backward{sfx}"),
                     rows.data_ptr(), mid.data_ptr(), acc.data_ptr(), den.data_ptr(),
                     g.data_ptr(), ln1_s.data_ptr(), ln1_b.data_ptr(), w_qkv.data_ptr(),
                     w_qkv_t.data_ptr(), w_o_t.data_ptr(), ln2_s.data_ptr(), ln2_b.data_ptr(),
                     w_1.data_ptr(), w_1_t.data_ptr(), b_1.data_ptr(), w_2_t.data_ptr(),
                     scratch.data_ptr(), dx.data_ptr(), grads.data_ptr(), R, N, C, H, hidden)
    if err != 0:
        raise RuntimeError(f"fused_block_backward{sfx} failed: CUDA error {err}")
    leaves = [t.view(s) for t, s in zip(
        torch.split(grads, sizes),
        [(C,), (C,), (C, 3 * C), (C, C), (C,), (C,), (C,), (C, hidden), (hidden,),
         (hidden, C), (C,)])]
    leaves[2][:, :C] *= _qk_scale(C, H)
    offsets = (ctypes.c_size_t * 3)()
    getattr(lib, f"fused_block_backward{sfx}_part_offsets")(R, N, C, H, hidden,
                                                            ctypes.addressof(offsets))

    def part(i, width, dtype):
        n = R * N * width * torch.finfo(dtype).bits // 8
        return scratch[offsets[i]:offsets[i] + n].view(dtype).view(R, N, width)

    d_oe = part(0, C if f32 else head_plan(C, H).CA, rows.dtype)
    return BwdParts(dx, type(p)(*leaves), d_oe, part(1, H, torch.float32),
                    part(2, 3 * C, rows.dtype))


def fused_row_block_bwd(rows: torch.Tensor, mid: torch.Tensor, acc: torch.Tensor,
                        den: torch.Tensor, g: torch.Tensor, p, num_heads: int):
    """B2: ``(dx, dp)`` of :func:`fused_row_block_bwd_parts`."""
    res = fused_row_block_bwd_parts(rows, mid, acc, den, g, p, num_heads)
    return res.dx, res.dp


class _FusedRowBlock(torch.autograd.Function):
    """B1-train forward, saving (rows, mid, acc, den), and B2 backward."""

    @staticmethod
    def forward(ctx, rows, num_heads, params_type, *params):
        out, mid, acc, den = fused_row_block_train(rows, params_type(*params), num_heads)
        ctx.save_for_backward(rows, mid, acc, den, *params)
        ctx.num_heads, ctx.params_type = num_heads, params_type
        return out

    @staticmethod
    def backward(ctx, g):
        rows, mid, acc, den, *params = ctx.saved_tensors
        dx, dp = fused_row_block_bwd(rows, mid, acc, den, g.contiguous(),
                                     ctx.params_type(*params), ctx.num_heads)
        return (dx, None, None, *(d.to(t.dtype) for d, t in zip(dp, params)))


def fused_row_block(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """The block's output, the wrapper the model calls.  Differentiable:
    when grad mode is on and ``rows`` or a parameter requires a gradient it
    runs B1-train and its backward B2; otherwise B1's serving form, through
    the custom op ``tfswa::fused_row_block`` (``ops/custom_ops.py``)."""
    if torch.is_grad_enabled() and (rows.requires_grad or any(t.requires_grad for t in p)):
        return _FusedRowBlock.apply(rows, num_heads, type(p), *p)
    _check_op_args("fused_row_block", rows, num_heads, p)
    from .custom_ops import fused_row_block as op

    return op(rows, list(p), num_heads)


for _wrapper in (fused_row_block, fused_row_block_int8, fused_row_block_train,
                 fused_row_block_bwd):
    _wrapper.launches = 0
    _wrapper.launches_f32 = 0
