"""int8 compute, the ``attention_impl="int8"`` route (counterpart of
``tfswa_tpu/ops/int8.py``).

  - :func:`quantize_symmetric`: symmetric int8, per channel (weights) or
    per tensor (activations); ``round`` is half to even, as ``jnp.round``.
  - :func:`int8_product`: (M, K) int8 @ (K, N) int8 -> int32, exact.  On a
    CUDA tensor it is ``torch._int_mm`` (cuBLASLt's int8 GEMM, the
    counterpart of the XLA ``dot_general`` with an int32 accumulator that
    the JAX package runs outside any kernel); it takes M > 16 and K, N
    multiples of 8, which every flagship width meets, and raises on other
    shapes.  On a CPU tensor it is the plain version,
    :func:`int8_product_reference`: the same product as an f32 matmul of
    the int8 values, exact while K <= 1040 (|sum| <= 127^2 K < 2^24).
  - :func:`int8_matmul`, :func:`int8_dense`, :func:`int8_mha_rows`: the JAX
    functions of the same names.
  - :func:`int8_row_block`: the row block with its four dense products
    (qkv, out-projection, fc1, fc2) in int8; LN, the attention core (f32
    scores, softmax and P V) and GELU in float.

Activation scales are dynamic (absmax / 127 of the activation) unless a
static, calibrated scale is given.  The JAX block quantises the qkv and
out-projection activations a row chunk at a time, with a hard 32 MiB
budget of (chunk, H, N, N) f32 scores: ``chunk = max(1, min(R, 2^25 //
(H N^2 4)))``, one row at N = 1024 or 862.  The scales here are taken per
chunk too (a vectorised absmax, not a loop over chunks); the products then
run once over all rows, which is exact in int32, and the per-chunk scale
multiplies afterwards: the values are the JAX per-chunk products'.  The
attention core runs in row batches sized by memory
(``fused_block.MAX_SCORE_BYTES``), which changes no value.  fc1 and fc2
take one scale over all rows, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .fused_block import MAX_SCORE_BYTES, layer_norm_f32
from .row_attention import attention_core

# the JAX block's activation-scale chunk: (chunk, H, N, N) f32 scores in 32 MiB
INT8_CHUNK_BYTES = 32 * 1024 * 1024
# the largest contraction whose f32 sum of int8 products is exact
PLAIN_MAX_K = 1040


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as a true division (PyTorch's CUDA division by a Python
    scalar multiplies by the reciprocal)."""
    return t / torch.full_like(t, 127.0)


def quantize_symmetric(x: torch.Tensor, axis=None, scale=None):
    """Symmetric int8: ``axis=None`` one scale over the tensor; a tuple of
    axes reduces over them (keepdim).  A given ``scale`` (static
    calibration) skips the absmax.  Returns (int8 values, f32 scale)."""
    xf = x.float()
    if scale is None:
        absmax = xf.abs().amax() if axis is None else xf.abs().amax(dim=axis, keepdim=True)
        scale = _div127(absmax.clamp_min(1e-12))
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=xf.device)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def int8_product_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`int8_product`: the f32 product of the
    int8 values, exact for K <= PLAIN_MAX_K, as int32."""
    if xq.shape[1] > PLAIN_MAX_K:
        raise ValueError(f"int8_product_reference: K = {xq.shape[1]} > {PLAIN_MAX_K}, "
                         "where an f32 sum of int8 products stops being exact")
    return (xq.float() @ wq.float()).to(torch.int32)


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: ``torch._int_mm``
    on a CUDA tensor, the plain version on a CPU one.  ``wq`` goes in
    column-major: with a row-major one, cuBLASLt's int8 GEMM on the H100
    refused K = 32 unless M was a multiple of 32 (CUBLAS_STATUS_NOT_SUPPORTED);
    column-major it took every M tried."""
    if xq.device.type == "cpu":
        return int8_product_reference(xq, wq)
    (M, K), N = xq.shape, wq.shape[1]
    if M <= 16 or K % 8 or N % 8:
        raise ValueError(f"int8_product: torch._int_mm takes M > 16 and K, N multiples of "
                         f"8, got M={M}, K={K}, N={N}")
    return torch._int_mm(xq.contiguous(), wq.t().contiguous().t())


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, M) int8 -> (..., M) f32: the exact int32 sum
    times ``x_scale * w_scale`` (w_scale per output column; x_scale a
    scalar or broadcastable per row, as the JAX package's per-chunk one)."""
    K = xq.shape[-1]
    acc = int8_product(xq.reshape(-1, K), wq).reshape(*xq.shape[:-1], -1)
    return acc.float() * (x_scale * w_scale.reshape(-1))


def int8_dense(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
               act_scale=None):
    """x -> int8 product with ``w`` (in, out), quantised per output column
    -> f32 (+ bias).  Returns (out, the activation scale used)."""
    wq, w_scale = quantize_symmetric(w, axis=tuple(range(w.dim() - 1)))
    xq, x_scale = quantize_symmetric(x, scale=act_scale)
    out = int8_matmul(xq, wq, x_scale, w_scale)
    if bias is not None:
        out = out + bias.float()
    return out, x_scale


def _core_in_batches(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """:func:`attention_core` over rows, in batches whose f32 score plane
    stays within MAX_SCORE_BYTES."""
    R, N, _ = q.shape
    batch = max(1, MAX_SCORE_BYTES // (num_heads * N * N * 4))
    if R <= batch:
        return attention_core(q, k, v, num_heads)
    out = torch.empty_like(q)
    for r0 in range(0, R, batch):
        s = slice(r0, r0 + batch)
        out[s] = attention_core(q[s], k[s], v[s], num_heads)
    return out


def _chunk_scales(x: torch.Tensor, chunk: int, scale=None):
    """Per-row activation scales (R, 1, 1) of (R, N, C) f32 ``x``, each the
    scale of its row chunk (absmax / 127 over the chunk), and the largest
    of them; a static ``scale`` is used for every row."""
    if scale is not None:
        s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
        return s, s
    R = x.shape[0]
    row_max = x.abs().amax(dim=(1, 2))
    chunk_max = F.pad(row_max, (0, (-R) % chunk)).view(-1, chunk).amax(dim=1)
    s = _div127(chunk_max.clamp_min(1e-12))
    return s.repeat_interleave(chunk)[:R].view(R, 1, 1), s.amax()


def _chunked_dense(x: torch.Tensor, w: torch.Tensor, bias, chunk: int, scale=None):
    """:func:`int8_dense` with per-chunk activation scales: (out, largest
    scale used)."""
    wq, w_scale = quantize_symmetric(w, axis=(0,))
    x_scale, used = _chunk_scales(x, chunk, scale)
    xq = torch.clamp(torch.round(x / x_scale), -127, 127).to(torch.int8)
    out = int8_matmul(xq, wq, x_scale, w_scale)
    if bias is not None:
        out = out + bias.float()
    return out, used


def _int8_attention(nf: torch.Tensor, p, num_heads: int, chunk: int, sc: dict):
    """qkv (int8) -> the f32 core -> out-projection (int8) on f32 rows:
    (out, {"qkv", "proj"} scales used)."""
    C = nf.shape[2]
    used = {}
    qkv, used["qkv"] = _chunked_dense(nf, p.qkv_kernel, None, chunk, sc.get("qkv"))
    out = _core_in_batches(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads)
    del qkv
    out, used["proj"] = _chunked_dense(out, p.proj_kernel, p.proj_bias, chunk,
                                       sc.get("proj"))
    return out, used


def int8_mha_rows(rows: torch.Tensor, qkv_kernel: torch.Tensor, proj_kernel: torch.Tensor,
                  proj_bias: torch.Tensor, num_heads: int, act_scales: Optional[dict] = None):
    """The plain attention with its qkv and out-projection products in int8,
    one activation scale each over all rows; the core in f32.  Returns
    (out f32, {"qkv", "proj"} scales used)."""
    from types import SimpleNamespace

    p = SimpleNamespace(qkv_kernel=qkv_kernel, proj_kernel=proj_kernel, proj_bias=proj_bias)
    return _int8_attention(rows.float(), p, num_heads, rows.shape[0], act_scales or {})


def int8_row_block(rows: torch.Tensor, p, num_heads: int,
                   act_scales: Optional[Dict[str, torch.Tensor]] = None):
    """The pre-LN row block on rows (R, N, C) with its dense products in
    int8 (``attention_impl="int8"``): rows + proj(core(qkv(LN1))), then
    + fc2(GELU(fc1(LN2))), the LNs in the rows' dtype with f32 statistics,
    the int8 products' outputs in f32.  ``act_scales`` ({"qkv", "proj",
    "fc1", "fc2"}) are static scales; those missing are dynamic.  Returns
    (out in the rows' dtype, the scales used: per site, the largest)."""
    sc = act_scales or {}
    dt = rows.dtype
    R, N, _ = rows.shape
    chunk = max(1, min(R, INT8_CHUNK_BYTES // max(num_heads * N * N * 4, 1)))
    normed = layer_norm_f32(rows.float(), p.norm1_scale, p.norm1_bias).to(dt)
    attn, used = _int8_attention(normed.float(), p, num_heads, chunk, sc)
    del normed
    rows = rows + attn.to(dt)
    del attn
    h = layer_norm_f32(rows.float(), p.norm2_scale, p.norm2_bias).to(dt)
    h, used["fc1"] = int8_dense(h.float(), p.fc1_kernel, p.fc1_bias, act_scale=sc.get("fc1"))
    h = F.gelu(h)
    h, used["fc2"] = int8_dense(h, p.fc2_kernel, p.fc2_bias, act_scale=sc.get("fc2"))
    return rows + h.to(dt), used
