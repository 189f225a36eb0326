"""Weights between the JAX package's variables and the port's state_dict.

The port's module tree uses the reference's state_dict names.  The JAX
model's variables ``{"params": ..., "batch_stats": ...}``, given as numpy
arrays, map onto them by the inverse of the JAX package's torch-interop
transforms:
  - conv kernel (kh, kw, Cin, Cout)   -> weight (Cout, Cin, kh, kw)
  - deconv kernel (kh, kw, Cin, Cout) -> weight (Cin, Cout, kh, kw)
  - dense kernel (in, out)            -> weight (out, in)
  - BatchNorm scale/bias, mean/var    -> weight/bias, running_mean/running_var
:func:`variables_from_state_dict` goes the other way, for a state_dict or a
dict of gradients by parameter name, so that tests can compare leaf by leaf.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

_CONV = lambda a: np.transpose(a, (3, 2, 0, 1))      # noqa: E731
_DECONV = lambda a: np.transpose(a, (2, 3, 0, 1))    # noqa: E731
_LINEAR = np.transpose
_SAME = lambda a: a                                  # noqa: E731
_INVERSE = {_CONV: lambda a: np.transpose(a, (2, 3, 1, 0)),
            _DECONV: lambda a: np.transpose(a, (2, 3, 0, 1)),
            _LINEAR: np.transpose, _SAME: _SAME}

Entry = Tuple[str, Tuple[str, ...], object]


def _conv(t: str, f: Tuple[str, ...], transform=_CONV) -> Iterator[Entry]:
    yield f"{t}.weight", ("params",) + f + ("kernel",), transform
    yield f"{t}.bias", ("params",) + f + ("bias",), _SAME


def _bn(t: str, f: Tuple[str, ...]) -> Iterator[Entry]:
    yield f"{t}.weight", ("params",) + f + ("scale",), _SAME
    yield f"{t}.bias", ("params",) + f + ("bias",), _SAME
    yield f"{t}.running_mean", ("batch_stats",) + f + ("mean",), _SAME
    yield f"{t}.running_var", ("batch_stats",) + f + ("var",), _SAME


def _row_block(t: str, f: Tuple[str, ...]) -> Iterator[Entry]:
    p = lambda leaf: ("params",) + f + (leaf,)       # noqa: E731
    yield f"{t}.norm1.weight", p("norm1_scale"), _SAME
    yield f"{t}.norm1.bias", p("norm1_bias"), _SAME
    yield f"{t}.attn.qkv.weight", p("qkv_kernel"), _LINEAR
    yield f"{t}.attn.proj.weight", p("proj_kernel"), _LINEAR
    yield f"{t}.attn.proj.bias", p("proj_bias"), _SAME
    yield f"{t}.norm2.weight", p("norm2_scale"), _SAME
    yield f"{t}.norm2.bias", p("norm2_bias"), _SAME
    yield f"{t}.mlp.0.weight", p("fc1_kernel"), _LINEAR
    yield f"{t}.mlp.0.bias", p("fc1_bias"), _SAME
    yield f"{t}.mlp.3.weight", p("fc2_kernel"), _LINEAR
    yield f"{t}.mlp.3.bias", p("fc2_bias"), _SAME


def _tfswa_block(t: str, f: str) -> Iterator[Entry]:
    yield from _conv(f"{t}.input_proj.0", (f, "input_proj_conv"))
    yield from _bn(f"{t}.input_proj.1", (f, "input_proj_bn"))
    yield from _conv(f"{t}.fusion.0", (f, "fusion_conv"))
    yield from _bn(f"{t}.fusion.1", (f, "fusion_bn"))
    for attn in ("tsa", "fsa", "swa"):
        yield from _row_block(f"{t}.{attn}", (f, attn))


def mapping(depths: Sequence[int]) -> Iterator[Entry]:
    """(state_dict name, JAX variable path, transform) for the whole model."""
    yield from _conv("stem.0", ("stem_conv",))
    yield from _bn("stem.1", ("stem_bn",))
    for s in range(3):
        for i in range(depths[s]):
            yield from _tfswa_block(f"encoder_stages.{s}.{i}", f"enc{s}_block{i}")
        yield from _conv(f"downsample_layers.{s}.downsample.0", (f"down{s}", "conv"))
        yield from _bn(f"downsample_layers.{s}.downsample.1", (f"down{s}", "bn"))
    for i in range(depths[3]):
        yield from _tfswa_block(f"bottleneck.{i}", f"bottleneck_block{i}")
    for d, s in enumerate((2, 1, 0)):
        yield from _conv(f"upsample_layers.{d}.upsample.0", (f"up{d}", "deconv"),
                         _DECONV)
        yield from _bn(f"upsample_layers.{d}.upsample.1", (f"up{d}", "bn"))
        for i in range(depths[s]):
            yield from _tfswa_block(f"decoder_stages.{d}.{i}", f"dec{d}_block{i}")
    yield from _conv("output_head.0", ("head_conv1",))
    yield from _bn("output_head.1", ("head_bn",))
    yield from _conv("output_head.3", ("head_conv2",))


def state_dict_from_jax(variables_np: Mapping, depths: Sequence[int]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` numpy tree -> the port's state_dict
    (float32; ``num_batches_tracked`` set to 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, path, transform in mapping(depths):
        node = variables_np
        for key in path:
            if key not in node:
                raise KeyError(f"missing JAX leaf: {'/'.join(path)}")
            node = node[key]
        arr = np.array(transform(np.asarray(node, dtype=np.float32)))
        sd[name] = torch.from_numpy(arr)
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd


def variables_from_state_dict(tensors: Mapping[str, torch.Tensor],
                              depths: Sequence[int]) -> Dict:
    """The port's state_dict, or any dict of tensors by state_dict name (e.g.
    parameter gradients), -> the JAX ``{"params", "batch_stats"}`` layout as a
    nested dict of float32 numpy arrays.  Names missing from ``tensors`` are
    left out, so a dict of gradients gives only ``"params"``."""
    out: Dict = {}
    for name, path, transform in mapping(depths):
        if name not in tensors:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        arr = tensors[name].detach().float().cpu().numpy()
        node[path[-1]] = np.ascontiguousarray(_INVERSE[transform](arr))
    return out
