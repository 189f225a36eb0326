"""Accounting for sharded runs (counterpart of
``tfswa_tpu/parallel/analysis.py``), read from a ``torch.profiler`` trace
where the JAX package reads the partitioned HLO:

  - :func:`collective_stats`: per-op count and bytes (from the shapes and
    dtypes the trace records) of the c10d collectives a rank issued;
  - :func:`analyze` (``analyze_jitted``'s place): run a call once under
    the profiler and the FLOP counter.  One rank's FLOPs of a call
    (``compiled_flops``' place) are ``utils/profiling.flops_of``'s count:
    PyTorch's matrix products and convolutions; a hand-written kernel
    launched through ctypes is not seen, so count the plain route;
  - :func:`largest_tensor_bytes`: the largest single allocation in a trace
    taken with ``profile_memory=True``;
  - :func:`ring_all_reduce_link_bytes`, as the JAX package has it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# what a backend names each collective in the trace ("<backend>:<op>")
_BACKENDS = ("nccl", "gloo")
_DTYPE_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2, "int": 4,
                "long int": 8, "short int": 2, "signed char": 1, "unsigned char": 1,
                "bool": 1, "c10::complex<float>": 8}


@dataclass
class CollectiveStats:
    """Per-op count and payload bytes of the collectives in one trace."""

    counts: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


def _raw_events(trace):
    """(name, input shapes, input dtypes) of every event of a
    ``torch.profiler.profile`` (read from its raw results, which is much
    faster than building ``events()``), or of a list of ``FunctionEvent``."""
    results = getattr(getattr(trace, "profiler", None), "kineto_results", None)
    if results is not None:
        return [(e.name(), e.shapes(), e.dtypes()) for e in results.events()]
    return [(e.name, e.input_shapes, getattr(e, "input_dtypes", None)) for e in trace]


def collective_stats(trace) -> CollectiveStats:
    """Count the collectives of a ``torch.profiler.profile`` (or a list of
    its events) and their payload bytes: for an all-reduce, what each rank
    contributes and receives once (a ring moves 2 (d - 1) / d of it
    through each rank's links).  Bytes need ``record_shapes=True``."""
    stats = CollectiveStats()
    for name, shapes, dtypes in _raw_events(trace):
        backend, _, op = name.partition(":")
        if backend not in _BACKENDS or not op:
            continue
        dtypes = list(dtypes or [])
        nbytes = 0
        for i, shape in enumerate(shapes or []):
            if shape:
                dtype = dtypes[i] if i < len(dtypes) else "float"
                nbytes += math.prod(shape) * _DTYPE_BYTES.get(dtype, 4)
        stats.counts[op] = stats.counts.get(op, 0) + 1
        stats.bytes[op] = stats.bytes.get(op, 0) + nbytes
    return stats


def analyze(fn, *args) -> Tuple[Optional[float], CollectiveStats, object]:
    """Run ``fn(*args)`` once under the profiler (CPU activity, shapes
    recorded) and the FLOP counter; (this rank's FLOPs, its collective
    stats, the result)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with counter:
            out = fn(*args)
    return float(counter.get_total_flops()) or None, collective_stats(prof), out


def largest_tensor_bytes(trace) -> int:
    """Bytes of the largest single allocation in a trace taken with
    ``profile_memory=True``: a path that materialises a whole score plane
    shows as one huge allocation long before the device runs out."""
    prof = getattr(trace, "profiler", trace)
    results = getattr(prof, "kineto_results", None)
    if results is None:
        return 0
    return max((e.nbytes() for e in results.events() if e.name() == "[memory]"), default=0)


def ring_all_reduce_link_bytes(payload_bytes: int, n_devices: int) -> float:
    """Per-rank link traffic of a ring all-reduce of ``payload_bytes``:
    reduce-scatter + all-gather move 2 (d - 1) / d of the payload through
    each rank's links."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * payload_bytes
