"""Sharding rules over the (data, model) mesh (counterpart of
``tfswa_tpu/parallel/sharding.py``).

Megatron tensor parallelism of the row blocks, keyed on the leaf's name as
in the JAX package (:func:`param_spec` gives JAX's specs, as tuples):
  - qkv_kernel (C, 3C)  -> (None, "model")  column-parallel, split by head
    (each model rank holds the q, k and v of its H / m heads);
  - fc1_kernel (C, 4C)  -> (None, "model")  column-parallel;
  - fc1_bias   (4C,)    -> ("model",);
  - proj_kernel (C, C)  -> ("model", None)  row-parallel;
  - fc2_kernel (4C, C)  -> ("model", None)  row-parallel;
  - everything else (convs, norms, biases, BatchNorm stats) replicated.
JAX splits qkv_kernel's columns contiguously, which mixes q and k across
ranks; GSPMD keeps the math whatever the layout, but the port computes by
hand, so it splits by head.  In the port's state_dict the same weights are
:data:`TP_SPLITS`; :func:`shard_state_dict` cuts a whole state_dict (say
``weights.state_dict_from_jax`` of a JAX tree) into one rank's shards, and
:func:`unshard_state_dicts` puts the ranks' shards back.

The batch is split over "data": each rank runs ``B / d`` rows
(:func:`batch_sharding` gives its shard).  :func:`shard_model` puts a
whole model on the mesh; :func:`gather_state_dict` and
:func:`load_whole_state_dict` go between it and the whole (JAX) layout, in
which checkpoints are written.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from ..weights import mapping
from .comm import gather_shards, shard_of

_TP_RULES = {
    "qkv_kernel": (None, "model"),
    "fc1_kernel": (None, "model"),
    "fc1_bias": ("model",),
    "proj_kernel": ("model", None),
    "fc2_kernel": ("model", None),
}


# state_dict name suffix -> (dim, blocks): the row-block weights split over
# the model axis.  qkv.weight (3C, C) is q | k | v, each split by head (the
# q, k and v of a rank's heads); proj (C, C) by its input columns, fc1 and
# its bias by output rows, fc2 by input columns (Megatron's column- and
# row-parallel pairs; the JAX names are qkv_kernel, proj_kernel,
# fc1_kernel, fc1_bias and fc2_kernel).
TP_SPLITS = {"attn.qkv.weight": (0, 3), "attn.proj.weight": (1, 1),
             "mlp.0.weight": (0, 1), "mlp.0.bias": (0, 1), "mlp.3.weight": (1, 1)}


def tp_split(name: str) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of a row-block weight split by tensor parallelism, or
    None for a replicated one."""
    for suffix, split in TP_SPLITS.items():
        if name.endswith("." + suffix) and any(f".{a}." in "." + name
                                                for a in ("tsa", "fsa", "swa")):
            return split
    return None


def shard_state_dict(sd: Mapping[str, torch.Tensor], index: int,
                     size: int) -> Dict[str, torch.Tensor]:
    """Rank ``index`` of ``size`` model ranks: its shard of each split
    weight (:data:`TP_SPLITS`), every other tensor as it is."""
    out = {}
    for name, t in sd.items():
        split = tp_split(name)
        out[name] = t if split is None or size == 1 else \
            shard_of(t, split[0], split[1], index, size).clone()
    return out


def unshard_state_dicts(shards: Sequence[Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The whole state_dict from every model rank's :func:`shard_state_dict`,
    in rank order."""
    out = {}
    for name, t in shards[0].items():
        split = tp_split(name)
        if split is None or len(shards) == 1:
            out[name] = t
            continue
        dim, parts = split
        pieces = [s[name].reshape(*t.shape[:dim], parts, t.shape[dim] // parts,
                                  *t.shape[dim + 1:]) for s in shards]
        whole = torch.cat(pieces, dim=dim + 1)
        shape = list(t.shape)
        shape[dim] *= len(shards)
        out[name] = whole.reshape(shape)
    return out


def _leaf_name(key) -> str:
    return key.key if hasattr(key, "key") else str(key)


def param_spec(path: Tuple, leaf: Any = None, tensor_parallel: bool = True) -> Tuple:
    """The partition spec (JAX's, as a tuple) of one parameter, keyed on
    its leaf name: () for a replicated one."""
    name = _leaf_name(path[-1])
    if tensor_parallel and name in _TP_RULES:
        return _TP_RULES[name]
    return ()


def variables_shardings(state_dict: Mapping[str, Any], depths,
                        tensor_parallel: bool = True) -> Dict[str, Tuple]:
    """{state_dict name: JAX spec} of a port state_dict (its names mapped
    to the JAX leaves by ``weights.mapping``)."""
    leaf = {name: path for name, path, _ in mapping(depths)}
    return {name: param_spec(leaf[name], None, tensor_parallel) if name in leaf else ()
            for name in state_dict}


class BatchShard(NamedTuple):
    """A rank's part of the global batch: shard ``index`` of ``num_shards``
    contiguous, equal row blocks."""

    num_shards: int
    index: int


def batch_sharding(mesh) -> BatchShard:
    """The leading (batch) dim split over "data": model peers share a shard."""
    return BatchShard(mesh.data.size, mesh.data.index)


def replicated(mesh) -> BatchShard:
    """Every rank holds every row."""
    return BatchShard(1, 0)


def shard_batch(batch, mesh):
    """This rank's rows of a global batch (a tensor, an array, or a dict or
    tuple of them) on the rank's device."""
    n, i = batch_sharding(mesh)

    def part(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} does not split over {n} data ranks")
        b = t.shape[0] // n
        return t[i * b:(i + 1) * b].to(mesh.device)

    if isinstance(batch, dict):
        return {k: part(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(x, mesh) for x in batch)
    return part(batch)


def shard_model(model, mesh):
    """Put a whole TFSWAUNet on the mesh, in place: BatchNorm statistics
    averaged over "data" (``model.bn_axis``), and with more than one model
    rank each row block's split weights (``weights.TP_SPLITS``) cut to this
    rank's shards and the block's ``tp`` set to the model axis.  Moves the
    model to the rank's device; returns it."""
    m = mesh.model
    model.bn_axis = mesh.data
    if m.size > 1:
        for name, mod in model.named_modules():
            if not hasattr(mod, "tp"):
                continue
            hidden = mod.mlp[0].weight.shape[0]
            if mod.num_heads % m.size or hidden % m.size:
                raise ValueError(f"{name}: {mod.num_heads} heads and an MLP of {hidden} "
                                 f"do not split over {m.size} model ranks")
            if mod.tp is not None:
                raise ValueError(f"{name} is already sharded")
            for pname, p in list(mod.named_parameters()):
                split = tp_split(f"{name}.{pname}")
                if split is None:
                    continue
                owner = mod.get_submodule(pname.rsplit(".", 1)[0])
                local = shard_of(p.data, split[0], split[1], m.index, m.size).clone()
                setattr(owner, pname.rsplit(".", 1)[1],
                        torch.nn.Parameter(local, requires_grad=p.requires_grad))
            mod.tp = m
    model.mesh = mesh
    return model.to(mesh.device)


def gather_state_dict(model) -> Dict[str, torch.Tensor]:
    """The whole (JAX-layout) state_dict of a model on a mesh: split
    weights gathered over the model axis (a collective: every rank of the
    axis calls it), the rest as they are."""
    tensors = model.state_dict()
    axis = model.tp_axis
    if axis is None:
        return tensors
    out = {}
    for name, t in tensors.items():
        split = tp_split(name)
        out[name] = t if split is None else gather_shards(t.contiguous(), axis, *split)
    return out


def load_whole_state_dict(model, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Load a whole (JAX-layout) state_dict into a model, cut to this
    rank's shards when the model is on a mesh with more than one model
    rank."""
    axis = model.tp_axis
    if axis is not None:
        state_dict = shard_state_dict(state_dict, axis.index, axis.size)
    model.load_state_dict(state_dict)
