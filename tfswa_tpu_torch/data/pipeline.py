"""Host -> device data pipeline: threaded batch loading and device
prefetch (counterpart of ``tfswa_tpu/data/pipeline.py``).

An IO-thread pool (the WAV reads release the GIL in numpy) fills a queue of
host batches; ``prefetch_to_device`` copies them from pinned host memory to
the device ``size`` batches ahead, so the copies overlap the device's work.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from .musdb import collate


class DataLoader:
    """Minimal map-style loader: shuffling, batching, threaded workers.

    Yields host numpy batches (mixture (B, 2, S), {stem: (B, 2, S)}).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        """``batch_size`` is the global batch size.  With ``num_shards``
        processes each passes its ``shard_index``: every process builds the
        same global batch order (same seed -> same shuffle; per-(seed,
        epoch, idx) segment sampling -> same samples) and loads only its
        contiguous batch_size / num_shards slice."""
        if batch_size % max(num_shards, 1):
            raise ValueError(
                f"global batch_size {batch_size} must divide over "
                f"{num_shards} processes"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.num_shards = max(1, num_shards)
        self.shard_index = shard_index
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        batches = []
        local = self.batch_size // self.num_shards
        for i in range(0, n, self.batch_size):
            idx = order[i : i + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            if self.num_shards > 1:
                # this process's contiguous slice of the global batch
                idx = idx[self.shard_index * local:
                          (self.shard_index + 1) * local]
                if len(idx) == 0:
                    continue
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator:
        self._epoch += 1
        if hasattr(self.dataset, "set_epoch"):
            # advance the dataset's per-(seed, epoch, idx) sampling stream so
            # random segments differ across epochs but not across worker counts
            self.dataset.set_epoch(self._epoch)
        batches = self._batch_indices()
        if self.num_workers == 0:
            for idx in batches:
                yield collate([self.dataset[int(i)] for i in idx])
            return

        out_q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = threading.Event()
        errors = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idx in batches:
                        samples = list(pool.map(lambda i: self.dataset[int(i)], idx))
                        if not put(collate(samples)):
                            return
            except Exception as exc:      # handed to the consumer, which raises it
                errors.append(exc)
            finally:
                put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                yield batch
        finally:
            stop.set()
            thread.join()
        if errors:
            raise errors[0]


def _to_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(iterator: Iterator, size: int = 2, device="cuda") -> Iterator:
    """Copy host batches (mixture, {stem: targets}) to ``device``, ``size``
    batches ahead of consumption: from pinned memory with
    ``non_blocking=True`` on a CUDA device, so that the copies overlap the
    device's work."""
    device = torch.device(device)

    def put(batch):
        mixture, targets = batch
        return (_to_tensor(mixture, device),
                {k: _to_tensor(v, device) for k, v in targets.items()})

    buf = []
    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
