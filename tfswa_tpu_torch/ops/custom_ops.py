"""The serving kernels as ``torch.library`` ops, so that an exported
program (``torch.export``, a TorchScript trace) holds them as calls:

  - ``tfswa::fused_row_block`` (B1), ``tfswa::fused_row_block_int8`` (B3):
    ``(rows, params, num_heads) -> out``, ``params`` the 11 tensors of a
    RowBlockParams in its order;
  - ``tfswa::flash_row_attention`` (B4):
    ``(rows, qkv_kernel, proj_kernel, proj_bias, num_heads) -> out``.

Each takes bf16 or f32 rows.  Its CPU implementation is the plain version,
its CUDA implementation the kernel (the wrappers of ``ops/fused_block.py``
and ``ops/row_attention.py``, which count the launches), and its fake
implementation gives the output's shape and dtype only (nothing is built).
The ops are registered when ``tfswa_tpu_torch`` is imported, so a program
loaded back after that import runs them.  The model's no-grad kernel
routes (``fused_block.fused_row_block``, ``fused_row_block_int8``,
``row_attention.flash_row_attention``) always call them, eager or being
exported; under autograd the routes keep their ``torch.autograd.Function``s.

They are defined on a ``torch.library.Library`` with a kernel per device
rather than through ``torch.library.custom_op``, whose wrapper costs a
call tens of microseconds more and its first call in a process about two
seconds of imports.
"""
from __future__ import annotations

import torch

from . import fused_block, row_attention

_LIB = torch.library.Library("tfswa", "DEF")
_LIB.define("fused_row_block(Tensor rows, Tensor[] params, int num_heads) -> Tensor")
_LIB.define("fused_row_block_int8(Tensor rows, Tensor[] params, int num_heads) -> Tensor")
_LIB.define("flash_row_attention(Tensor rows, Tensor qkv_kernel, Tensor proj_kernel, "
            "Tensor proj_bias, int num_heads) -> Tensor")


def _params(params):
    from ..models.attention import RowBlockParams

    return RowBlockParams(*params)


def _fused_row_block(rows, params, num_heads):
    # the plain version on a CPU tensor, the kernel on a CUDA one
    return fused_block.fused_row_block_parts(rows, _params(params), num_heads)[0]


def _fused_row_block_int8(rows, params, num_heads):
    return fused_block.fused_row_block_int8_run(rows, _params(params), num_heads)


def _flash_row_attention(rows, qkv_kernel, proj_kernel, proj_bias, num_heads):
    return row_attention.flash_row_attention_run(rows, qkv_kernel, proj_kernel, proj_bias,
                                                 num_heads)


def _like_rows(rows, *args):
    return torch.empty_like(rows)


for _name, _impl in (("fused_row_block", _fused_row_block),
                     ("fused_row_block_int8", _fused_row_block_int8),
                     ("flash_row_attention", _flash_row_attention)):
    for _key in ("CPU", "CUDA"):
        _LIB.impl(_name, _impl, _key)
    torch.library.register_fake(f"tfswa::{_name}", _like_rows, lib=_LIB)

fused_row_block = torch.ops.tfswa.fused_row_block
fused_row_block_int8 = torch.ops.tfswa.fused_row_block_int8
flash_row_attention = torch.ops.tfswa.flash_row_attention
