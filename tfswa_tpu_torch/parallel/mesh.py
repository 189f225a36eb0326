"""The (data, model) mesh of ranks (counterpart of
``tfswa_tpu/parallel/mesh.py``).

Rank r sits at (r // m, r % m) of a (d, m) mesh, the order of the JAX
package's ``np.asarray(devices).reshape(d, m)``.  A rank keeps one
:class:`Axis` a mesh axis: the ranks that share its other coordinate,
their process group, and its own index along the axis.  The data axis
splits the batch; the model axis splits the row blocks' weights
(``parallel/sharding.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig
from .distributed import process_info, rank_device


class Axis:
    """One mesh axis as a rank sees it: ``name``, ``size``, the rank's
    ``index`` along it, the global ``ranks`` on it and their process
    ``group`` (None outside a process group, where every collective over
    the axis is a no-op).  A deep copy of a model keeps its axes."""

    def __init__(self, name: str, size: int, index: int, ranks: Tuple[int, ...],
                 group=None):
        self.name, self.size, self.index = name, size, index
        self.ranks, self.group = tuple(ranks), group

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size}, index={self.index})"


class Mesh:
    """A (data, model) mesh of ranks: ``shape`` {"data": d, "model": m},
    this rank's ``data`` and ``model`` axes, its ``rank`` and ``device``."""

    def __init__(self, d: int, m: int, rank: int, device: torch.device, groups: bool):
        self.shape = {"data": d, "model": m}
        self.rank, self.device = rank, device
        i, k = divmod(rank, m)
        data_ranks = [[j * m + c for j in range(d)] for c in range(m)]
        model_ranks = [[r * m + c for c in range(m)] for r in range(d)]
        data_group = model_group = None
        if groups:
            # every rank creates every group, in the same order
            for c, ranks in enumerate(data_ranks):
                g = dist.new_group(ranks)
                data_group = g if c == k else data_group
            for r, ranks in enumerate(model_ranks):
                g = dist.new_group(ranks)
                model_group = g if r == i else model_group
        self.data = Axis("data", d, i, data_ranks[k], data_group)
        self.model = Axis("model", m, k, model_ranks[i], model_group)

    def __deepcopy__(self, memo):
        return self

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}, "
                f"rank={self.rank}, device={self.device})")


def create_mesh(shape: Optional[Tuple[int, int]] = None, device="cuda") -> Mesh:
    """Build a (data, model) mesh over every rank of the process group (one
    rank outside a group).  ``shape`` None puts every rank on the data
    axis; ``(d, m)`` with d == -1 takes d from the world size.  Raises
    ``ValueError`` when d * m is not the world size.  ``device``: "cuda"
    (the rank's card) unless the CPU is asked for."""
    rank, world = process_info()
    d, m = shape if shape is not None else (world, 1)
    if d == -1:
        if world % m:
            raise ValueError(f"{world} ranks are not divisible by model axis {m}")
        d = world // m
    if d < 1 or m < 1 or d * m != world:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, the world has {world}")
    return Mesh(d, m, rank, rank_device(device), dist.is_initialized())


def mesh_from_config(cfg: MeshConfig, device="cuda") -> Mesh:
    return create_mesh((cfg.data_axis, cfg.model_axis), device=device)
