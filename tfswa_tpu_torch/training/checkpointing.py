"""Checkpoints with the JAX package's epoch / best / latest layout
(counterpart of ``tfswa_tpu/training/checkpointing.py``).

    ckpt_dir/
      epoch_{n:06d}/checkpoint.pt   one file a checkpoint (below)
      best/checkpoint.pt            copy of the best checkpoint so far
      latest/checkpoint.pt          copy of the most recent one
      config.json                   the full Config

Where the JAX package writes orbax trees, a checkpoint here is one
``torch.save`` file in the reference's naming, which
``evaluation.load_separator_from_checkpoint`` reads:
  - ``model_state_dict``: the parameters and the BatchNorm batch stats
    (``running_mean``, ``running_var``, ``num_batches_tracked``);
  - ``optimizer``: ``ClippedAdamW.state_dict()``, its update count and
    AdamW's moments and step;
  - ``meta``: epoch, global_step, best_val_loss;
  - ``config``: the ModelConfig as a flat dict.
Only the newest ``keep`` epoch directories stay.

Under a mesh the tree is always in the whole (JAX) layout: every rank
builds it (:func:`checkpoint_tree` gathers the tensor-parallel shards of
the weights and of AdamW's moments over the model axis) and rank 0 alone
writes it; every rank reads it back and :func:`load_checkpoint_tree` cuts
it to its shards.  So a checkpoint written under any mesh loads under any
other, or on one card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Optional, Tuple

import torch

from ..config import Config
from ..parallel.comm import gather_shards, shard_of
from ..parallel.sharding import gather_state_dict, load_whole_state_dict, tp_split

CHECKPOINT_FILE = "checkpoint.pt"


def _map_moments(opt: Dict, model, fn) -> Dict:
    """A ``ClippedAdamW.state_dict()`` with the moments of each
    tensor-parallel parameter passed through ``fn(tensor, (dim, blocks))``."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    adam = dict(opt["adamw"])
    adam["state"] = {i: dict(st) for i, st in adam["state"].items()}
    for i, st in adam["state"].items():
        split = tp_split(names[int(i)])
        if split is not None:
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = fn(st[k], split)
    return dict(opt, adamw=adam)


def checkpoint_tree(state) -> Dict:
    """The model's state_dict and the optimizer's state in the whole
    layout: under tensor parallelism gathered over the model axis (a
    collective, which every rank of the axis calls)."""
    opt = state.tx.state_dict()
    axis = state.model.tp_axis
    if axis is not None:
        opt = _map_moments(opt, state.model, lambda t, split: gather_shards(
            t.contiguous(), axis, *split))
    return {"model_state_dict": gather_state_dict(state.model), "optimizer": opt}


def load_checkpoint_tree(state, tree: Dict) -> None:
    """Load a checkpoint's model and optimizer state (whole layout) into
    ``state``, cut to this rank's shards under tensor parallelism."""
    load_whole_state_dict(state.model, tree["model_state_dict"])
    opt = tree["optimizer"]
    axis = state.model.tp_axis
    if axis is not None:
        opt = _map_moments(opt, state.model, lambda t, split: shard_of(
            t, split[0], split[1], axis.index, axis.size).clone())
    state.tx.load_state_dict(opt)


def _replace_dir(tmp: str, path: str) -> None:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


class CheckpointManager:
    """Saves and restores the train state with best / latest tracking."""

    def __init__(self, ckpt_dir: str, config: Optional[Config] = None, keep: int = 5):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep = keep
        self.model_config = dataclasses.asdict(config.model) if config is not None else {}
        if config is not None:
            with open(os.path.join(self.ckpt_dir, "config.json"), "w") as fh:
                json.dump(config.to_dict(), fh, indent=2)

    def save(self, state, epoch: int, global_step: int, best_val_loss: float,
             is_best: bool = False) -> str:
        """Write the epoch's checkpoint, copy it to ``latest`` (and to
        ``best`` when flagged), drop the epochs past ``keep``.  Each
        directory is written beside its place and then moved there.  Under
        tensor parallelism the other model ranks call
        :func:`checkpoint_tree` meanwhile (its gather is a collective)."""
        tree = checkpoint_tree(state)
        tree.update(meta={"epoch": epoch, "global_step": global_step,
                          "best_val_loss": best_val_loss},
                    config=self.model_config)
        path = os.path.join(self.ckpt_dir, f"epoch_{epoch:06d}")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, CHECKPOINT_FILE))
        _replace_dir(tmp, path)
        for name, flag in (("latest", True), ("best", is_best)):
            if flag:
                dst = os.path.join(self.ckpt_dir, name)
                shutil.rmtree(dst + ".tmp", ignore_errors=True)
                shutil.copytree(path, dst + ".tmp")
                _replace_dir(dst + ".tmp", dst)
        self._gc()
        return path

    def _gc(self) -> None:
        epochs = sorted(d for d in os.listdir(self.ckpt_dir)
                        if d.startswith("epoch_") and not d.endswith(".tmp"))
        for d in epochs[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)

    def restore(self, which: str = "latest") -> Tuple[Dict, Dict]:
        """(checkpoint dict, its meta) of ``which``: "latest", "best" or an
        epoch directory's name, tensors on the CPU."""
        return read_checkpoint(self.ckpt_dir, which)


def read_checkpoint(ckpt_dir: str, which: str = "latest") -> Tuple[Dict, Dict]:
    """(checkpoint dict, its meta) of ``ckpt_dir/which``, tensors on the CPU."""
    path = os.path.join(os.path.abspath(ckpt_dir), which, CHECKPOINT_FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree, tree.get("meta", {})


def restore_variables(checkpoint_path: str) -> Tuple[Dict, Optional[Dict]]:
    """(model state_dict, the Config dict of ``config.json`` or None) for
    inference, from an epoch directory or from a checkpoint directory that
    holds ``best`` or ``latest`` (``best`` first)."""
    path = checkpoint_path
    for name in ("best", "latest"):
        if os.path.isdir(os.path.join(checkpoint_path, name)):
            path = os.path.join(checkpoint_path, name)
            break
    tree = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)
    cfg = None
    for cfg_dir in (checkpoint_path, os.path.dirname(path)):
        cfg_path = os.path.join(cfg_dir, "config.json")
        if os.path.isfile(cfg_path):
            with open(cfg_path) as fh:
                cfg = json.load(fh)
            break
    return tree["model_state_dict"], cfg
