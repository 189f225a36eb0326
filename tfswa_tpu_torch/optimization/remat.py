"""Gradient checkpointing (rematerialisation) helpers (counterpart of
``tfswa_tpu/optimization/remat.py``).

The model applies it itself through ``ModelConfig.remat`` (each TFSWABlock
under ``torch.utils.checkpoint``, ``models/tfswa_unet.py``, with the save
policy in ``TFSWAUNet.remat_policy``); this module holds the config
object, ``checkpoint_fn`` / ``checkpoint_sequential``, the save policies,
the activation-memory estimate and the device memory counters.

The JAX package's save policies map onto torch's selective activation
checkpointing (``torch.utils.checkpoint.create_selective_checkpoint_contexts``),
which keeps the outputs of the ops a policy names and recomputes the rest:
  - ``"none"``: nothing of the function's inside is kept (plain
    ``torch.utils.checkpoint``);
  - ``"dots"`` (``checkpoint_dots``, which keeps every ``dot_general``):
    the outputs of the matrix products ``aten.mm``, ``addmm``, ``bmm`` and
    ``baddbmm`` (not convolutions, which JAX's policy does not keep either);
  - ``"dots_no_batch"`` (``checkpoint_dots_with_no_batch_dims``): those
    without a batch dimension, ``mm`` and ``addmm`` (a product of a 3-d
    tensor and a matrix reaches them flattened, as its dot_general has no
    batch dimension);
  - ``"everything"`` (``everything_saveable``): every value is kept, so
    nothing is recomputed: the function runs with no checkpoint at all.
An op run under ``torch.no_grad`` keeps nothing under any policy: it makes
no residual, and the recompute may skip it (BatchNorm's running-stat
update, which ``frozen_stats`` leaves out).
The hand-written kernels launch outside torch's dispatcher: under any
policy their launches run again in the recompute.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..utils.profiling import device_memory_report

_aten = torch.ops.aten
# the ops each policy keeps (op overload packets); None: all, no checkpoint
SAVED_OPS = {
    "none": frozenset(),
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}),
    "dots_no_batch": frozenset({_aten.mm, _aten.addmm}),
    "everything": None,
}
POLICIES = tuple(SAVED_OPS)


def check_policy(policy: str) -> None:
    if policy not in SAVED_OPS:
        raise ValueError(f"unknown remat policy {policy}; options {list(POLICIES)}")


def _keeps(policy: str):
    saved = SAVED_OPS[policy]

    def keep(ctx, op, *args, **kwargs):
        # an op under no_grad keeps no residual (and a recompute may skip
        # it: BatchNorm's running-stat update under frozen_stats)
        if torch.is_grad_enabled() and op.overloadpacket in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return keep


def policy_contexts(policy: str, recompute_ctx=None):
    """``context_fn`` of ``torch.utils.checkpoint`` for ``policy``: the
    (forward, recompute) contexts, ``recompute_ctx`` (a context manager, or
    None) entered in the recompute as well."""
    check_policy(policy)
    extra = recompute_ctx if recompute_ctx is not None else contextlib.nullcontext()
    if policy == "none":
        return contextlib.nullcontext(), extra
    fwd, rec = create_selective_checkpoint_contexts(_keeps(policy))

    @contextlib.contextmanager
    def both():
        with rec, extra:
            yield

    return fwd, both()


def recomputes(policy: str) -> bool:
    """Whether a checkpoint under ``policy`` recomputes anything (all but
    "everything")."""
    check_policy(policy)
    return SAVED_OPS[policy] is not None


def checkpoint_fn(fn: Callable, policy: str = "none") -> Callable:
    """``fn`` recomputed in the backward but for what ``policy`` keeps (the
    JAX ``checkpoint_fn``'s names; an unknown name raises ValueError)."""
    if not recomputes(policy):
        return fn
    context_fn = functools.partial(policy_contexts, policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return wrapped


def checkpoint_sequential(fns: Sequence[Callable], segments: int = 2) -> Callable:
    """A chain of functions in ``segments`` segments, each recomputed in the
    backward instead of keeping its inside (the JAX function)."""
    fns = list(fns)
    seg_size = max(1, (len(fns) + segments - 1) // segments)

    def run(fs, x):
        for f in fs:
            x = f(x)
        return x

    segs = [fns[i:i + seg_size] for i in range(0, len(fns), seg_size)]

    def forward(x):
        for fs in segs:
            x = checkpoint(run, fs, x, use_reentrant=False)
        return x

    return forward


@dataclasses.dataclass
class CheckpointConfig:
    """Config-object API: ``apply`` returns a copy of a ModelConfig with
    remat set to ``enabled``, whatever the policy (as the JAX object does:
    the config has no policy field; a model takes one in
    ``TFSWAUNet.remat_policy``)."""

    enabled: bool = True
    policy: str = "none"

    def apply(self, model_config):
        return dataclasses.replace(model_config, remat=self.enabled)


def estimate_activation_memory(batch: int, freq_bins: int, time_frames: int,
                               dims: Sequence[int], depths: Sequence[int],
                               bytes_per_el: int = 4) -> dict:
    """The JAX package's analytic estimate of the blocks' activation memory,
    with and without remat: about 6 activations of (B, H, W, C) a block,
    and with remat one a block (a sixth)."""
    per_stage = []
    h, w = freq_bins, time_frames
    for level, (d, c) in enumerate(zip(depths, dims)):
        per_stage.append(d * 6 * batch * h * w * c)
        if level < len(dims) - 1:
            h, w = (h + 1) // 2, (w + 1) // 2
    total = sum(per_stage) * bytes_per_el
    with_remat = total / 6.0
    return {"no_remat_gb": total / 1e9, "with_remat_gb": with_remat / 1e9,
            "savings_gb": (total - with_remat) / 1e9,
            "savings_pct": 100.0 * (1 - with_remat / max(total, 1))}


def get_memory_stats() -> dict:
    """Live memory of each CUDA device, GB, under the JAX function's keys;
    empty without one."""
    return {dev: {"bytes_in_use_gb": r["in_use_gb"], "peak_bytes_in_use_gb": r["peak_gb"],
                  "bytes_limit_gb": r["limit_gb"]}
            for dev, r in device_memory_report().items()}
