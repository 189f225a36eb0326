"""The kernel lab's forms of the fused row block (counterpart of
``tools/kernel_lab.py`` ``_kernel_prod`` and its stage and flag forms,
launched there by ``_call_kernel``).

The lab cuts B1 (``ops/fused_block.py``) at a stage, or changes one step
of its score -> p line, so that the time of each part of B1 can be read
on the card.  Over rows (R, N, C) with H heads of D = C / H, q, k, v and s
as in B1 (Wq pre-scaled by log2(e)/sqrt(D), all rounded to ``rows.dtype``),
the output (R, N, C) in ``rows.dtype`` is, by ``stage``:

  qkv     f32(q) + k + v
  scores  [r, n, c] = sum_h s_h[r, query n, key c] for c < min(C, N), else
          0: raw scores, no clamp
  exp2    [r, key j, h*D + d] = p_h[r, query d, key j]: the rounded
          exp2(min(s, SCORE_CLAMP)) of the first D queries (needs N >= D)
  av      [r, n, c] = sum over queries q of acc[r, q, c], the f32
          normalised attention output before its rounding, for every n
  attn    x + (rnd(acc) @ Wo + bo)
  full    B1's output

and the flags change the score -> p line of the ``attn`` and ``full``
stages: ``score_bf16`` rounds the clamped score to bf16 before exp2 (the
JAX package's ``exp2bf16`` and ``sbf16`` forms, one function; exp2 of a
bf16 value as XLA computes it, see ``_reference_forward``), ``p_f32``
leaves p unrounded into AV and the denominator, ``clamp=False`` drops the
clamp (scores past 128 then overflow exp2, as in the JAX form).

:func:`lab_row_block` is the wrapper: the plain version on a CPU tensor,
the kernel (``csrc/fused_block.cu`` ``fused_block_lab_forward``, built
from B1's own kernels) on a contiguous bf16 CUDA tensor; anything else
raises.  It counts each launch in ``lab_row_block.launches``.  It has no
gradient, as the JAX forms have none (no differentiation rule for Pallas'
``reciprocal``): under grad it raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .fused_block import _block_weights, _check_cuda, _reference_forward

STAGES = ("qkv", "scores", "exp2", "av", "attn", "full")
# the flag bits of fused_block_lab_forward (csrc/fused_block.cu)
SCORE_BF16, P_F32, NO_CLAMP = 1, 2, 4


def _lab_flags(rows: torch.Tensor, num_heads: int, stage: str, score_bf16: bool,
               p_f32: bool, clamp: bool) -> int:
    """The flag bits of a lab form; raises on a form the lab does not have."""
    if stage not in STAGES:
        raise ValueError(f"lab_row_block: stage {stage!r} not in {STAGES}")
    flags = SCORE_BF16 * bool(score_bf16) | P_F32 * bool(p_f32) | NO_CLAMP * (not clamp)
    if flags and stage not in ("attn", "full"):
        raise ValueError("lab_row_block: the flags act on the attn and full stages only")
    if stage == "exp2" and rows.shape[1] < rows.shape[2] // num_heads:
        raise ValueError("lab_row_block: stage 'exp2' needs N >= C / num_heads")
    return flags


def lab_row_block_reference(rows: torch.Tensor, p, num_heads: int, stage: str = "full",
                            score_bf16: bool = False, p_f32: bool = False,
                            clamp: bool = True, qkv=None) -> torch.Tensor:
    """Plain PyTorch version of the lab form, the shared plain body of B1
    cut at ``stage`` with the flags.  ``qkv`` (R*N, 3C), if given, replaces
    the recomputed q|k|v (a check on the card passes the kernel's own)."""
    _lab_flags(rows, num_heads, stage, score_bf16, p_f32, clamp)
    return _reference_forward(rows, p, num_heads, train=False, qkv=qkv, stage=stage,
                              score_bf16=score_bf16, p_f32=p_f32, clamp=clamp)[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    fn = lib.fused_block_lab_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        sz = lib.fused_block_lab_scratch_bytes
        sz.argtypes = [ctypes.c_int] * 5
        sz.restype = ctypes.c_size_t
    return lib


def lab_row_block_parts(rows: torch.Tensor, p, num_heads: int, stage: str = "full",
                        score_bf16: bool = False, p_f32: bool = False,
                        clamp: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``fused_block_lab_forward`` on the card, uncounted:
    the lab form's output and the (R*N, 3C) q|k|v it used (what a check
    feeds the plain version).  Raises on a tensor the kernel does not take
    and when the launch fails."""
    flags = _lab_flags(rows, num_heads, stage, score_bf16, p_f32, clamp)
    _check_cuda("lab_row_block", rows, num_heads, p)
    R, N, C = rows.shape
    weights = _block_weights(p, C, num_heads, rows.dtype)
    hidden = weights[7].shape[1]
    dev = rows.device
    lib = _lib()
    st = STAGES.index(stage)
    out = torch.empty_like(rows)
    qkv = torch.empty((R * N, 3 * C), dtype=rows.dtype, device=dev)
    attn = torch.empty_like(rows) if stage in ("attn", "full") else None
    scratch = torch.empty(lib.fused_block_lab_scratch_bytes(R, N, C, num_heads, st),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_block_lab_forward(
            rows.data_ptr(), *(w.data_ptr() for w in weights), qkv.data_ptr(),
            None if attn is None else attn.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            R, N, C, num_heads, hidden, st, flags,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_block_lab_forward (stage {stage}, flags {flags}) "
                           f"failed: CUDA error {err}")
    return out, qkv


def lab_row_block(rows: torch.Tensor, p, num_heads: int, stage: str = "full",
                  score_bf16: bool = False, p_f32: bool = False,
                  clamp: bool = True) -> torch.Tensor:
    """The lab form's output (R, N, C) (module docstring).  Counts each
    launch in ``lab_row_block.launches``."""
    if torch.is_grad_enabled() and (rows.requires_grad or any(t.requires_grad for t in p)):
        raise RuntimeError("lab_row_block has no gradient (as the kernel lab's forms in "
                           "the JAX package): differentiate fused_row_block instead")
    if rows.device.type == "cpu":
        return lab_row_block_reference(rows, p, num_heads, stage, score_bf16, p_f32, clamp)
    out = lab_row_block_parts(rows, p, num_heads, stage, score_bf16, p_f32, clamp)[0]
    lab_row_block.launches += 1
    return out


lab_row_block.launches = 0
