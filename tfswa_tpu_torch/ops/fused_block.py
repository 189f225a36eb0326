"""Fused pre-LN row transformer block (counterpart of
``tfswa_tpu/ops/pallas/fused_block.py`` ``fused_row_block``, serving form).

For rows (R, N, C): rows + MHA(LN1(rows)), then + MLP(LN2(.)), with the TPU
kernel's arithmetic: LN statistics in f32, Wq pre-scaled by log2(e)/sqrt(D),
a max-free exp2 softmax with scores clamped at ``SCORE_CLAMP``, and the
same bf16 rounding points (see ``csrc/fused_block.cu``).

- :func:`fused_row_block` is the wrapper.  A CPU tensor goes to the plain
  version; a contiguous bf16 CUDA tensor launches the CUDA kernel
  (``csrc/fused_block.cu``); anything else raises.
- :func:`fused_row_block_reference` is the plain PyTorch version.  It chunks
  over rows, so that the (rows, H, N, N) scores it does materialise stay
  bounded at full-width shapes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# Max-free exp2 softmax overflow guard, in log2 units: exp2(110) * N stays
# below f32 max for N <= 2^17 keys.
SCORE_CLAMP = 110.0
LOG2E = 1.4426950408889634
KERNEL_HEAD_DIMS = (4, 8, 16, 32)
# The plain versions materialise f32 scores; they chunk over rows so that at
# most this many bytes of scores exist at once.
MAX_SCORE_BYTES = 1 << 28


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of an f32 tensor (biased variance)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _block_weights(p, C: int, num_heads: int, dtype: torch.dtype):
    """Weights in the compute dtype, Wq pre-scaled (in f32, then rounded):
    (ln1_s, ln1_b, w_qkv (C, 3C), w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2, b_2)."""
    scale = (C // num_heads) ** -0.5 * LOG2E
    w_qkv = torch.cat([p.qkv_kernel[:, :C].float() * scale,
                       p.qkv_kernel[:, C:].float()], dim=1)
    ws = (p.norm1_scale, p.norm1_bias, w_qkv, p.proj_kernel, p.proj_bias,
          p.norm2_scale, p.norm2_bias, p.fc1_kernel, p.fc1_bias,
          p.fc2_kernel, p.fc2_bias)
    return tuple(w.to(dtype).contiguous() for w in ws)


def fused_row_block_reference_parts(rows: torch.Tensor, p, num_heads: int):
    """Plain PyTorch version of the fused block, in f32 arithmetic with the
    kernel's rounding to ``rows.dtype`` at the same points.  Returns the
    block's output and its attention output before the out-projection,
    both (R, N, C) in ``rows.dtype``."""
    R, N, C = rows.shape
    H = num_heads
    D = C // H
    dt = rows.dtype
    (ln1_s, ln1_b, w_qkv, w_o, b_o, ln2_s, ln2_b, w_1, b_1, w_2,
     b_2) = (w.float() for w in _block_weights(p, C, H, dt))

    def rnd(t):
        return t.to(dt).float()

    chunk = max(1, MAX_SCORE_BYTES // (H * N * N * 4))
    outs, attns = [], []
    for r0 in range(0, R, chunk):
        x = rows[r0:r0 + chunk].float()
        Rc = x.shape[0]
        n1 = rnd(layer_norm_f32(x, ln1_s, ln1_b))
        qkv = rnd(n1 @ w_qkv).view(Rc, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                      # (Rc, H, N, D)
        prob = rnd(torch.exp2((q @ k.transpose(-1, -2)).clamp(max=SCORE_CLAMP)))
        acc = (prob @ v) / prob.sum(dim=-1, keepdim=True)
        acc = rnd(acc.transpose(1, 2).reshape(Rc, N, C))
        y = x + (acc @ w_o + b_o)
        n2 = rnd(layer_norm_f32(y, ln2_s, ln2_b))
        h1 = rnd(F.gelu(n2 @ w_1 + b_1))
        outs.append((y + (h1 @ w_2 + b_2)).to(dt))
        attns.append(acc.to(dt))
    return torch.cat(outs), torch.cat(attns)


def fused_row_block_reference(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """The block's output from :func:`fused_row_block_reference_parts`."""
    return fused_row_block_reference_parts(rows, p, num_heads)[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    fn = lib.fused_block_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def fused_row_block_parts(rows: torch.Tensor, p, num_heads: int):
    """The whole pre-LN block over rows (R, N, C); ``p`` is a RowBlockParams.
    Returns the block's output and its attention output before the
    out-projection (what a check of the attention alone compares), both
    (R, N, C).  Counts each kernel launch in ``fused_row_block.launches``."""
    if rows.device.type == "cpu":
        return fused_row_block_reference_parts(rows, p, num_heads)
    if rows.device.type != "cuda":
        raise ValueError(f"fused_row_block: no kernel for device {rows.device}")
    if rows.dtype != torch.bfloat16:
        raise TypeError(f"fused_row_block: the kernel takes bfloat16, got {rows.dtype}")
    if rows.dim() != 3 or not rows.is_contiguous():
        raise ValueError("fused_row_block: rows must be a contiguous (R, N, C) tensor")
    R, N, C = rows.shape
    if C % num_heads or C // num_heads not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused_row_block: head dim {C}/{num_heads} not in "
                         f"{KERNEL_HEAD_DIMS}")
    if R * N >= 2 ** 31:
        raise ValueError("fused_row_block: too many tokens for 32-bit counts")
    weights = _block_weights(p, C, num_heads, rows.dtype)
    for w in weights:
        if w.device != rows.device:
            raise ValueError("fused_row_block: parameters are not on the rows' device")
    hidden = weights[7].shape[1]
    qkv = torch.empty((R * N, 3 * C), dtype=rows.dtype, device=rows.device)
    attn = torch.empty((R, N, C), dtype=rows.dtype, device=rows.device)
    out = torch.empty_like(rows)
    # the library launches on the current device: make it the rows' device
    with torch.cuda.device(rows.device):
        err = _lib().fused_block_forward(
            rows.data_ptr(), *(w.data_ptr() for w in weights),
            qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
            R, N, C, num_heads, hidden,
            torch.cuda.current_stream(rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_forward failed: CUDA error {err}")
    fused_row_block.launches += 1
    return out, attn


def fused_row_block(rows: torch.Tensor, p, num_heads: int) -> torch.Tensor:
    """The block's output from :func:`fused_row_block_parts`: the wrapper the
    model calls."""
    return fused_row_block_parts(rows, p, num_heads)[0]


fused_row_block.launches = 0
