"""Synthetic source-separation dataset (copy of ``tfswa_tpu/data/synthetic.py``, numpy only).

The reference tests on torch.randn tensors and pure sines
(reference: test_phase3.py:35-41); this gives the same capability as a real
dataset object so the Trainer/evaluator run end-to-end with zero external
data.  Each "track" is a deterministic mix of sine stacks (vocals-like
harmonics) and filtered noise (accompaniment-like).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


class SyntheticDataset:
    """API-compatible with MUSDB18Dataset (len / getitem / get_full_track)."""

    def __init__(
        self,
        num_tracks: int = 8,
        track_seconds: float = 12.0,
        segment_seconds: float = 6.0,
        sample_rate: int = 44100,
        stems: Sequence[str] = ("vocals", "other"),
        random_segments: bool = True,
        seed: int = 0,
    ):
        self.num_tracks = num_tracks
        self.sample_rate = sample_rate
        self.track_samples = int(track_seconds * sample_rate)
        self.segment_samples = int(segment_seconds * sample_rate)
        self.stems = tuple(stems)
        self.random_segments = random_segments
        self._seed = seed
        self._epoch = 0

    def _track_sources(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self._seed * 1000 + idx)
        t = np.arange(self.track_samples) / self.sample_rate
        # vocals: harmonic stack with vibrato
        f0 = rng.uniform(110, 440)
        vib = 1 + 0.01 * np.sin(2 * np.pi * 5 * t)
        vocals = sum(
            (0.5 ** k) * np.sin(2 * np.pi * f0 * (k + 1) * vib * t)
            for k in range(4)
        )
        # accompaniment: colored noise + low sine
        noise = rng.standard_normal(self.track_samples)
        kernel = np.hanning(64)
        kernel /= kernel.sum()
        other = np.convolve(noise, kernel, mode="same") * 2.0
        other += 0.3 * np.sin(2 * np.pi * rng.uniform(55, 110) * t)
        sources = {
            "vocals": np.stack([vocals, vocals]).astype(np.float32) * 0.3,
            "other": np.stack([other, other]).astype(np.float32) * 0.3,
        }
        if len(self.stems) == 4:
            drums = (rng.standard_normal((2, self.track_samples)) *
                     (np.sin(2 * np.pi * 2 * t) > 0.9)).astype(np.float32) * 0.3
            bass = np.stack([np.sin(2 * np.pi * 60 * t)] * 2).astype(np.float32) * 0.2
            sources = {
                "vocals": sources["vocals"],
                "drums": drums,
                "bass": bass,
                "other": sources["other"],
            }
        return sources

    def __len__(self) -> int:
        if self.random_segments:
            return self.num_tracks
        per_track = max(1, self.track_samples // self.segment_samples)
        return self.num_tracks * per_track

    def set_epoch(self, epoch: int) -> None:
        """Advance the segment-sampling stream (called by DataLoader per epoch)."""
        self._epoch = epoch

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        if self.random_segments:
            ti = idx % self.num_tracks
            # per-(seed, epoch, idx) stream: thread-safe under loader worker
            # threads and identical for any worker count (see musdb.py note)
            rng = np.random.default_rng((self._seed, self._epoch, idx))
            start = int(
                rng.integers(0, max(1, self.track_samples - self.segment_samples))
            )
        else:
            per_track = max(1, self.track_samples // self.segment_samples)
            ti, seg = divmod(idx, per_track)
            start = seg * self.segment_samples
        sources = self._track_sources(ti)
        seg_sources = {
            k: v[:, start : start + self.segment_samples] for k, v in sources.items()
        }
        mixture = sum(seg_sources.values())
        targets = {k: seg_sources[k] for k in self.stems}
        return mixture, targets

    def get_full_track(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        sources = self._track_sources(idx)
        mixture = sum(sources.values())
        return mixture, {k: sources[k] for k in self.stems}

    @property
    def track_names(self) -> List[str]:
        return [f"synthetic_{i:03d}" for i in range(self.num_tracks)]
