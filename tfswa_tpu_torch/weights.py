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

The int8 route's activation scales, which the JAX model keeps in its
``act_scales`` / ``act_stats`` collections (per row block ``{"scales":
{"qkv", "proj", "fc1", "fc2"}}``), map onto the port's per-block scales by
row-block module name (:func:`act_scales_from_jax`, :func:`act_scales_to_jax`);
:func:`conv_bn_pairs` names each BatchNorm with the conv it follows, and
:func:`top_modules` the port module of each of the JAX model's top-level
modules (``tools/visualize``'s table).
"""
from __future__ import annotations

import os
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


def _bf16_numpy():
    """numpy's bfloat16 dtype (``ml_dtypes``, which JAX's arrays use)."""
    try:
        import ml_dtypes
    except ImportError as exc:
        raise ImportError("a bfloat16 leaf as a numpy array needs the ml_dtypes "
                          "package") from exc
    return ml_dtypes.bfloat16


def _leaf_to_torch(arr: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor: bfloat16 stays bfloat16 (bit for bit),
    any other dtype becomes float32."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy leaf: bfloat16 stays bfloat16 (bit for bit),
    any other dtype becomes float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(_bf16_numpy())
    return t.float().numpy()


def state_dict_from_jax(variables_np: Mapping, depths: Sequence[int]) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "batch_stats"}`` numpy tree -> the port's state_dict
    (float32, a bfloat16 leaf bfloat16: ``param_dtype="bfloat16"``;
    ``num_batches_tracked`` set to 0)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, path, transform in mapping(depths):
        node = variables_np
        for key in path:
            if key not in node:
                raise KeyError(f"missing JAX leaf: {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        if arr.dtype.name != "bfloat16":
            arr = arr.astype(np.float32)
        sd[name] = _leaf_to_torch(np.array(transform(arr)))
        if name.endswith(".running_var"):
            sd[name[: -len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.int64)
    return sd


def variables_from_state_dict(tensors: Mapping[str, torch.Tensor],
                              depths: Sequence[int]) -> Dict:
    """The port's state_dict, or any dict of tensors by state_dict name (e.g.
    parameter gradients), -> the JAX ``{"params", "batch_stats"}`` layout as a
    nested dict of float32 numpy arrays (a bfloat16 tensor a bfloat16 array,
    ``ml_dtypes``'s, as JAX's bf16 leaves are).  Names missing from
    ``tensors`` are left out, so a dict of gradients gives only
    ``"params"``."""
    out: Dict = {}
    for name, path, transform in mapping(depths):
        if name not in tensors:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        arr = _leaf_to_numpy(tensors[name])
        node[path[-1]] = np.ascontiguousarray(_INVERSE[transform](arr))
    return out


def top_modules(depths: Sequence[int]) -> Dict[str, str]:
    """{port module name: JAX top-level module} for each top-level entry of
    the JAX model's ``params``, in the model's order: the port module is
    the longest dotted prefix that every state_dict name of that entry
    shares (``stem_conv`` -> ``stem.0``, ``enc0_block0`` ->
    ``encoder_stages.0.0``, ``down0`` -> ``downsample_layers.0.downsample``)."""
    groups: Dict[str, list] = {}
    for name, path, _ in mapping(depths):
        if path[0] == "params":
            groups.setdefault(path[1], []).append(name.split(".")[:-1])
    return {".".join(os.path.commonprefix(names)): top for top, names in groups.items()}


def row_blocks(depths: Sequence[int]) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(row-block module name, JAX module path) of every TSA, FSA and SWA."""
    for name, path, _ in mapping(depths):
        if name.endswith(".norm1.weight"):
            yield name[: -len(".norm1.weight")], path[1:-1]


def conv_bn_pairs(depths: Sequence[int]) -> Iterator[Tuple[str, str]]:
    """(conv module name, BatchNorm module name) of every BatchNorm, from the
    JAX package's pairing by name (``X_bn`` with ``X_conv`` / ``X_conv1`` /
    ``X_deconv``; a bare ``bn`` with its module's ``conv`` / ``deconv``)."""
    convs = {}
    for name, path, _ in mapping(depths):
        if path[-1] == "kernel" and len(path) >= 2:
            convs[path[1:-1]] = name[: -len(".weight")]
    for name, path, _ in mapping(depths):
        if path[0] != "batch_stats" or path[-1] != "mean":
            continue
        *parent, bn = path[1:-1]
        stems = ("conv", "deconv") if bn == "bn" else tuple(
            bn[: -len("_bn")] + tail for tail in ("_conv", "_conv1", "_deconv"))
        conv = next(convs[tuple(parent) + (c,)] for c in stems
                    if tuple(parent) + (c,) in convs)
        yield conv, name[: -len(".running_mean")]


def act_scales_from_jax(tree: Mapping, depths: Sequence[int]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX ``act_scales`` (or ``act_stats``) collection -> {row-block name:
    {site: f32 scalar tensor}} for the blocks it holds."""
    out = {}
    for name, path in row_blocks(depths):
        node = tree
        for key in path:
            node = node.get(key) if isinstance(node, Mapping) else None
        if node is not None:
            out[name] = {k: torch.tensor(float(np.asarray(v)), dtype=torch.float32)
                         for k, v in node["scales"].items()}
    return out


def act_scales_to_jax(scales: Mapping[str, Mapping], depths: Sequence[int]) -> Dict:
    """The inverse of :func:`act_scales_from_jax`: a nested dict in the
    JAX collection's layout, numpy f32 scalars."""
    out: Dict = {}
    for name, path in row_blocks(depths):
        if name not in scales:
            continue
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node["scales"] = {k: np.float32(float(v)) for k, v in scales[name].items()}
    return out
