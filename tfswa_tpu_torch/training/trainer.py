"""Trainer: the training loop (counterpart of
``tfswa_tpu/training/trainer.py``).

One epoch is ``steps_per_epoch`` steps of: a batch from the threaded
loader, copied to the device ahead of use; waveform augmentation, then
mixup, on the device; the train step (``make_train_step``).  Then, every
``val_every_n_epochs``, the validation losses, and at the first validation
and every 5th after it the SDR evaluation: full-track separation of the
first ``sdr_eval_num_tracks`` validation tracks and SDR / SI-SDR against
their stems.  The best checkpoint is chosen by -avg SDR where that was
evaluated, else by the validation loss.  Metrics go to
``log_dir/metrics.jsonl`` always, and to TensorBoard when it imports.

The SDR evaluation's separator shares the training model (no copy of the
weights): the model is switched to eval mode for it, so that BatchNorm
reads the running stats, leaves them alone and the row blocks take the
serving route, and back to train mode after it.

Under a mesh (``Trainer(mesh=)``) every rank runs the same loop: its
loaders read the rows of its data coordinate (model peers read the same
rows), the steps are the sharded ones, the SDR evaluation separates
through the mesh, and rank 0 alone writes the checkpoints (the whole
layout, gathered on every rank) and the metrics.  The MFU counts this
rank's FLOPs (3 x one plain-route forward of its rows, counted once on the
first batch) against one card's peak.
"""
from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.augment import build_augmentations
from ..data.pipeline import DataLoader, prefetch_to_device
from ..evaluation.inference import SourceSeparator
from ..evaluation.metrics import sdr as sdr_metric, si_sdr as si_sdr_metric
from ..ops.stft import STFTProcessor
from ..parallel.comm import all_reduce_
from ..parallel.distributed import process_info
from ..parallel.sharding import BatchShard, batch_sharding
from ..utils.profiling import StepTimer, device_memory_report, flops_of
from .checkpointing import (CheckpointManager, checkpoint_tree, load_checkpoint_tree,
                            read_checkpoint)
from .train_state import (_check_trainable, _spectrograms, create_train_state,
                          make_eval_step, make_train_step)


class MetricLogger:
    """JSONL metric stream, and TensorBoard when its import succeeds."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, tag_values: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time(), **tag_values}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in tag_values.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


class _NullLogger:
    """The metric log of a rank other than 0, which writes nothing."""

    def log(self, tag_values: Dict[str, float], step: int) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """Owns the loaders, the model and its optimizer, the steps, the
    checkpoints and the metric log.  ``device`` is "cuda" unless the caller
    asks for "cpu"; with a ``mesh`` (``parallel.create_mesh``) it is the
    rank's device."""

    def __init__(self, config: Config, train_dataset, val_dataset=None, device="cuda",
                 mesh=None):
        # create_train_state refuses the serving-only routes (int8: rounding
        # has no gradient) before anything is built
        _check_trainable(config.model.attention_impl)
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.stems = tuple(config.data.stems)
        self.stft_processor = STFTProcessor(config.stft)
        data = config.data
        # each rank loads the rows of its data coordinate: model peers the
        # same ones (one process a card, so not by process index)
        shard = BatchShard(1, 0) if mesh is None else batch_sharding(mesh)
        self.train_loader = DataLoader(train_dataset, batch_size=data.batch_size, shuffle=True,
                                       num_workers=data.num_workers, seed=config.train.seed,
                                       num_shards=shard.num_shards, shard_index=shard.index)
        # every validation item counts, as in JAX: a rank's slice of the
        # last batch may be short or empty (``validate`` weighs by rows)
        self.val_loader = DataLoader(
            val_dataset, batch_size=data.batch_size, shuffle=False,
            num_workers=data.num_workers, drop_last=False,
            num_shards=shard.num_shards, shard_index=shard.index,
        ) if val_dataset is not None else None
        self.val_dataset = val_dataset
        self.steps_per_epoch = config.train.steps_per_epoch or max(1, len(self.train_loader))

        self.model, self.state = create_train_state(config, self.steps_per_epoch, device,
                                                    mesh=mesh)
        self.audio_aug, self.mixup, self.spec_aug = build_augmentations(data, self.stft_processor)
        self._aug_rng = np.random.default_rng(config.train.seed + 1 + shard.index)
        train = config.train
        data_axis = None if mesh is None else mesh.data
        self._train_step = make_train_step(
            self.model, self.stft_processor, self.stems, l1_weight=train.l1_weight,
            mrstft_weight=train.mrstft_weight, use_mrstft=train.use_mrstft_loss,
            spec_augment=self.spec_aug, rng_seed=train.seed + 2,
            mask_mode=train.train_mask_mode, freq_policy=train.freq_policy,
            data_axis=data_axis)
        # each rank's own losses: validate() sums them over "data"
        self._eval_step = make_eval_step(
            self.model, self.stft_processor, self.stems, l1_weight=train.l1_weight,
            mask_mode=train.train_mask_mode, freq_policy=train.freq_policy)

        # rank 0 alone writes checkpoints and metrics
        self.is_main_process = process_info()[0] == 0
        self.ckpt = CheckpointManager(train.checkpoint_dir, config=config,
                                      keep=train.keep_checkpoints) \
            if self.is_main_process else None
        self.logger = MetricLogger(train.log_dir) if self.is_main_process else _NullLogger()
        self.current_epoch = 0
        self.global_step = 0
        self.best_metric = float("inf")
        self._sdr_separator: Optional[SourceSeparator] = None
        self._step_timer: Optional[StepTimer] = None

    # -------------------------------------------------------------- epochs
    def _device_batches(self, loader):
        return prefetch_to_device(iter(loader), size=self.config.data.prefetch,
                                  device=self.device)

    def _train_step_flops(self, mixtures: torch.Tensor) -> Optional[float]:
        """This rank's FLOPs of a train step on ``mixtures``: 3 x one
        plain-route forward (the kernels' launches are not counted by the
        FLOP counter), of one row times the rows (the FLOPs are linear in
        them).  Under tensor parallelism the plain route's forward is
        Megatron's, a collective that every model rank calls here."""
        plain = self.model.clone(attention_impl="xla").eval()
        x = _spectrograms(self.stft_processor, mixtures[:1], {},
                          self.config.train.freq_policy)[0]
        with torch.no_grad():
            flops = flops_of(plain, x)
        return None if flops is None else 3.0 * flops * mixtures.shape[0]

    def _epoch_batches(self):
        """Exactly ``steps_per_epoch`` batches: the loader is cycled (fresh
        random segments each pass) when the epoch is longer than it."""
        done = 0
        while done < self.steps_per_epoch:
            yielded = 0
            for batch in self._device_batches(self.train_loader):
                yield batch
                done += 1
                yielded += 1
                if done >= self.steps_per_epoch:
                    return
            if yielded == 0:      # an empty loader cannot make progress
                return

    def _augment(self, mixtures, targets):
        if self.audio_aug is not None:
            mixtures, targets = self.audio_aug(self._aug_rng, mixtures, targets)
        if self.mixup is not None:
            mixtures, targets = self.mixup(self._aug_rng, mixtures, targets)
        return mixtures, targets

    def train_epoch(self) -> Dict[str, float]:
        """One epoch of train steps; the mean of each loss, step time and
        rates, and the device memory (``mem/*``).  Losses stay on the
        device until a log line or the epoch's end reads them."""
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        t0 = time.time()
        if self._step_timer is not None:
            self._step_timer.restart()
        for mixtures, targets in self._epoch_batches():
            mixtures, targets = self._augment(mixtures, targets)
            if self._step_timer is None:
                self._step_timer = StepTimer(flops_per_step=self._train_step_flops(mixtures),
                                             items_per_step=int(mixtures.shape[0]))
            self.state, loss_dict = self._train_step(self.state, mixtures, targets)
            self._step_timer.tick()
            count += 1
            self.global_step += 1
            for k, v in loss_dict.items():
                sums[k] = sums[k] + v if k in sums else v
            if self.global_step % self.config.train.log_every_n_steps == 0:
                host = {f"train/{k}": float(v) for k, v in loss_dict.items()}
                host["train/steps_per_sec"] = count / (time.time() - t0)
                for k, v in self._step_timer.metrics().items():
                    host[f"train/{k}"] = v
                self.logger.log(host, self.global_step)
        out = {k: float(v) / max(count, 1) for k, v in sums.items()}
        out.update(self._step_timer.metrics() if self._step_timer else {})
        for k, v in next(iter(device_memory_report().values()), {}).items():
            out[f"mem/{k}"] = v
        return out

    def validate(self) -> Dict[str, float]:
        """Mean validation losses (eval-mode BN, no gradient): the mean
        over the global batches of each batch's mean loss, as one device
        has it.  Under a mesh each rank weighs its rows' losses by their
        count, and one ``all_reduce`` over "data" sums them: a rank whose
        slice of the last batch is empty adds nothing."""
        if self.val_loader is None or len(self.val_loader) == 0:
            return {}
        keys = (*(f"l1_{s}" for s in self.stems), "l1_loss", "total_loss")
        # per global batch: the losses times the rows, then the rows (f64:
        # exact for one device, where the rows divide back out)
        sums = torch.zeros(len(self.val_loader), len(keys) + 1, dtype=torch.float64,
                           device=self.device)
        for i, (mixtures, targets) in enumerate(self._device_batches(self.val_loader)):
            losses = self._eval_step(self.state, mixtures, targets)
            rows = mixtures.shape[0]
            sums[i, :-1] = torch.stack([losses[k].double() for k in keys]) * rows
            sums[i, -1] = rows
        if self.mesh is not None:
            all_reduce_(sums, self.mesh.data)
        means = (sums[:, :-1] / sums[:, -1:]).mean(dim=0)
        return dict(zip(keys, means.tolist()))

    def evaluate_sdr(self) -> Dict[str, float]:
        """SDR and SI-SDR of full-track separation (``sdr_eval_*`` segments
        and overlap) of the first ``sdr_eval_num_tracks`` validation
        tracks, on the device; the mask convention follows the training
        one ("trainer" for parity, "mag_direct" for direct).  A track that
        fails is warned about and left out."""
        if self.val_dataset is None or not hasattr(self.val_dataset, "get_full_track"):
            return {}
        cfg = self.config.train
        if self._sdr_separator is None:
            self._sdr_separator = SourceSeparator(
                self.model, self.stft_processor, segment_length=cfg.sdr_eval_segment_seconds,
                overlap=cfg.sdr_eval_overlap,
                mask_mode="trainer" if cfg.train_mask_mode == "parity" else "mag_direct",
                stem_names=self.stems, device=self.device, mesh=self.mesh)
        n = min(cfg.sdr_eval_num_tracks, len(self.val_dataset.track_names))
        per_stem: Dict[str, list] = {s: [] for s in self.stems}
        si_per_stem: Dict[str, list] = {s: [] for s in self.stems}
        self.model.eval()
        try:
            for i in range(n):
                try:
                    mixture, refs = self.val_dataset.get_full_track(i)
                    ests = self._sdr_separator.separate(mixture)
                    for s in self.stems:
                        ref = torch.from_numpy(np.asarray(refs[s]).mean(axis=0)).to(self.device)
                        est = torch.from_numpy(np.asarray(ests[s])[0]).to(self.device)
                        per_stem[s].append(float(sdr_metric(est, ref)))
                        si_per_stem[s].append(float(si_sdr_metric(est, ref)))
                except Exception as exc:  # noqa: BLE001 (as the JAX trainer: skip bad tracks)
                    warnings.warn(f"SDR eval failed on track {i}: {exc!r}")
        finally:
            self.model.train()
        out = {}
        for s in self.stems:
            if per_stem[s]:
                out[f"sdr/{s}"] = float(np.mean(per_stem[s]))
                out[f"si_sdr/{s}"] = float(np.mean(si_per_stem[s]))
        if out:
            out["sdr/avg"] = float(np.mean([out[f"sdr/{s}"] for s in self.stems
                                            if f"sdr/{s}" in out]))
        return out

    # ----------------------------------------------------------------- run
    def train(self) -> Dict[str, float]:
        """The epoch loop: train, validation with its SDR cadence, the best
        metric, checkpoints.  Returns the last epoch's train metrics."""
        cfg = self.config.train
        final_metrics: Dict[str, float] = {}
        val_count = 0
        for epoch in range(self.current_epoch, cfg.max_epochs):
            self.current_epoch = epoch
            train_metrics = self.train_epoch()
            self.logger.log({f"epoch_train/{k}": v for k, v in train_metrics.items()},
                            self.global_step)
            final_metrics = train_metrics

            metric_for_best = None
            if self.val_loader is not None and (epoch + 1) % cfg.val_every_n_epochs == 0:
                val_count += 1
                val_metrics = self.validate()
                self.logger.log({f"val/{k}": v for k, v in val_metrics.items()},
                                self.global_step)
                metric_for_best = val_metrics.get("total_loss")
                # the first validation, then every 5th
                if val_count == 1 or val_count % 5 == 0:
                    sdr_metrics = self.evaluate_sdr()
                    if sdr_metrics:
                        self.logger.log(sdr_metrics, self.global_step)
                        metric_for_best = -sdr_metrics.get(
                            "sdr/avg", -metric_for_best if metric_for_best else 0.0)

            is_best = metric_for_best is not None and metric_for_best < self.best_metric
            if is_best:
                self.best_metric = metric_for_best
            if self.ckpt is not None:
                self.ckpt.save(self.state, epoch=epoch, global_step=self.global_step,
                               best_val_loss=self.best_metric, is_best=is_best)
            else:
                checkpoint_tree(self.state)     # the other ranks' part of rank 0's gather
        self.logger.close()
        return final_metrics

    # -------------------------------------------------------------- resume
    def load_checkpoint(self, which: str = "latest") -> None:
        """Restore the parameters, BatchNorm stats, optimizer moments and
        count, the step, epoch, global step and best metric of ``which``
        ("latest", "best" or an epoch directory), on every rank (written
        in the whole layout, cut to the rank's shards)."""
        tree, meta = read_checkpoint(self.config.train.checkpoint_dir, which)
        load_checkpoint_tree(self.state, tree)
        self.global_step = int(meta.get("global_step", 0))
        self.state.step = self.global_step
        self.current_epoch = int(meta.get("epoch", -1)) + 1
        self.best_metric = float(meta.get("best_val_loss", math.inf))
