"""MUSDB18(-HQ) dataset: chunked stem reads (counterpart of
``tfswa_tpu/data/musdb.py``, numpy only).

  - binary stem mode: targets ['vocals', 'other'] with other = drums + bass
    + other;
  - per-stem positioned reads through the port's numpy WAV reader
    (``data/wav.py``), mixture = sum of the four sources;
  - the train / valid / test split with musdb's 14 validation tracks;
  - a sequential validation index: evenly spaced starts, at most
    ``max_segments_per_track`` a track;
  - ``get_full_track`` for the evaluation.

The .stem.mp4 (non-HQ) layout goes through the optional ``musdb``
package, imported only when no HQ wav tree is found.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .wav import wav_info, wav_read

# Standard musdb validation tracks (musdb.DB split='valid').
VALIDATION_TRACKS = [
    "Actions - One Minute Smile",
    "Alexander Ross - Goodbye Bolero",
    "ANiMAL - Rockshow",
    "Clara Berry And Wooldog - Waltz For My Victims",
    "Fergessen - Nos Palpitants",
    "James May - On The Line",
    "Johnny Lokke - Promises & Lies",
    "Leaf - Summerghost",
    "Meaxic - Take A Step",
    "Patrick Talbot - A Reason To Leave",
    "Skelpolu - Human Mistakes",
    "Traffic Experiment - Sirens",
    "Triviul - Angelsaint",
    "Young Griffo - Pennies",
]

ALL_SOURCES = ("vocals", "drums", "bass", "other")


def load_chunk(path: str, start: int, num_frames: int, num_channels: int = 2) -> np.ndarray:
    """Seek-read a (channels, num_frames) float32 slice from a wav; zero-pad
    short reads; mono -> stereo."""
    return wav_read(path, start, num_frames, num_channels)


def audio_file_frames(path: str) -> int:
    """Total frames in a wav file."""
    return wav_info(path)[0]


class MUSDB18Dataset:
    """Map-style dataset yielding (mixture (2, S), {stem: (2, S)}).

    Args mirror the reference (reference: musdb_dataset.py:74-143).  The
    ``min_mean_abs`` arg is accepted for API parity but — like the
    reference — not used as a filter (reference: musdb_dataset.py:86,111).
    """

    def __init__(
        self,
        root: str,
        split: str = "train",
        stems: Sequence[str] = ("vocals", "other"),
        segment_seconds: float = 6.0,
        sample_rate: int = 44100,
        random_segments: bool = True,
        segment_overlap: float = 0.5,
        max_segments_per_track: int = 8,
        min_mean_abs: float = 0.0,
        seed: int = 0,
    ):
        self.root = root
        self.split = split
        self.stems = tuple(stems)
        self.sample_rate = sample_rate
        self.segment_samples = int(segment_seconds * sample_rate)
        self.random_segments = random_segments
        self.segment_overlap = segment_overlap
        self.max_segments_per_track = max_segments_per_track
        self.min_mean_abs = min_mean_abs
        self._seed = seed
        self._epoch = 0

        self.tracks = self._discover_tracks()
        if not self.tracks:
            raise FileNotFoundError(
                f"No MUSDB18-HQ tracks found under {root} for split {split}"
            )
        self._track_lengths = [self._track_length(t) for t in self.tracks]
        if not random_segments:
            self._index = self._build_sequential_index()

    # ----------------------------------------------------------- discovery
    def _discover_tracks(self) -> List[str]:
        """Format autodetect (reference: musdb_dataset.py:167-186): prefer the
        HQ wav layout root/{train,test}/<track>/vocals.wav; fall back to the
        musdb package (.stem.mp4 archives) when no wavs are found."""
        self._mode = "hq"
        subset = "test" if self.split == "test" else "train"
        base = os.path.join(self.root, subset)
        if os.path.isdir(base):
            track_dirs = sorted(
                d for d in os.listdir(base)
                if os.path.isfile(os.path.join(base, d, "vocals.wav"))
            )
            if track_dirs:
                if self.split == "train":
                    track_dirs = [d for d in track_dirs
                                  if d not in VALIDATION_TRACKS]
                elif self.split == "valid":
                    track_dirs = [d for d in track_dirs
                                  if d in VALIDATION_TRACKS]
                return [os.path.join(base, d) for d in track_dirs]
        return self._discover_musdb_pkg(subset)

    def _discover_musdb_pkg(self, subset: str) -> List:
        """.stem.mp4 layout via the musdb package (reference fallback loader:
        musdb_dataset.py:326-410).  Requires `pip install musdb` (stempeg)."""
        try:
            import musdb as musdb_pkg
        except ImportError:
            return []
        kwargs = {"root": self.root, "subsets": [subset]}
        if subset == "train" and self.split in ("train", "valid"):
            kwargs["split"] = self.split
        try:
            db = musdb_pkg.DB(**kwargs)
        except Exception:
            return []
        if not db.tracks:
            return []
        self._mode = "pkg"
        return list(db.tracks)

    def _track_length(self, track) -> int:
        if self._mode == "pkg":
            return int(track.duration * track.rate)
        return audio_file_frames(os.path.join(track, "vocals.wav"))

    # ------------------------------------------------------------- indexing
    def _build_sequential_index(self) -> List[Tuple[int, int]]:
        """Evenly spaced (track, start) pairs for validation
        (reference: musdb_dataset.py:412-433)."""
        index = []
        hop = max(1, int(self.segment_samples * (1 - self.segment_overlap)))
        for ti, length in enumerate(self._track_lengths):
            starts = list(range(0, max(1, length - self.segment_samples + 1), hop))
            if len(starts) > self.max_segments_per_track:
                picks = np.linspace(
                    0, len(starts) - 1, self.max_segments_per_track
                ).astype(int)
                starts = [starts[p] for p in picks]
            index.extend((ti, s) for s in starts)
        return index

    def __len__(self) -> int:
        """#tracks when random, #segments when sequential
        (reference: musdb_dataset.py:435-440)."""
        if self.random_segments:
            return len(self.tracks)
        return len(self._index)

    # --------------------------------------------------------------- loading
    def _source_files(self, track_dir: str) -> Dict[str, str]:
        return {s: os.path.join(track_dir, f"{s}.wav") for s in ALL_SOURCES}

    def _load_stems(
        self, track_dir: str, start: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Chunk-read each needed source; mixture = sum of all sources
        (reference: musdb_dataset.py:269-319)."""
        files = self._source_files(track_dir)
        sources = {
            s: load_chunk(files[s], start, self.segment_samples)
            for s in ALL_SOURCES
        }
        mixture = sum(sources.values())
        targets = {
            stem: self._select_stem(stem, sources) for stem in self.stems
        }
        return mixture.astype(np.float32), targets

    def _select_stem(
        self, stem: str, sources: Dict[str, np.ndarray]
    ) -> np.ndarray:
        """Binary mode ('vocals'/'other'): other = drums + bass + other
        (reference: musdb_dataset.py:202-217); otherwise the raw source."""
        binary = len(self.stems) == 2 and "vocals" in self.stems
        if stem == "other" and binary:
            return sources["drums"] + sources["bass"] + sources["other"]
        if stem not in sources:
            raise KeyError(f"unknown stem {stem}")
        return sources[stem]

    def _load_stems_pkg(
        self, track, start: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Chunked read through the musdb package (reference fallback loader:
        musdb_dataset.py:326-410): set chunk window, decode, planar f32."""
        track.chunk_start = start / track.rate
        track.chunk_duration = self.segment_samples / track.rate

        def planar(audio) -> np.ndarray:
            a = np.asarray(audio, np.float32).T          # (channels, S)
            if a.shape[0] == 1:
                a = np.repeat(a, 2, axis=0)
            if a.shape[1] < self.segment_samples:
                a = np.pad(a, ((0, 0), (0, self.segment_samples - a.shape[1])))
            return a[:, : self.segment_samples]

        mixture = planar(track.audio)
        sources = {s: planar(track.targets[s].audio) for s in ALL_SOURCES}
        targets = {stem: self._select_stem(stem, sources) for stem in self.stems}
        return mixture, targets

    def set_epoch(self, epoch: int) -> None:
        """Advance the segment-sampling stream (called by DataLoader per epoch)."""
        self._epoch = epoch

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        if self.random_segments:
            ti = idx % len(self.tracks)
            length = self._track_lengths[ti]
            max_start = max(0, length - self.segment_samples)
            # Per-(seed, epoch, idx) generator: __getitem__ runs on loader
            # worker THREADS, and a shared np Generator is not thread-safe
            # (concurrent integers() can corrupt bit-generator state).  A
            # derived stream is race-free and makes sampling identical for
            # any worker count.
            rng = np.random.default_rng((self._seed, self._epoch, idx))
            start = int(rng.integers(0, max_start + 1))
        else:
            ti, start = self._index[idx]
        try:
            if self._mode == "pkg":
                return self._load_stems_pkg(self.tracks[ti], start)
            return self._load_stems(self.tracks[ti], start)
        except Exception as exc:  # pragma: no cover - IO resilience
            # fallback chain ends in zeros (reference: musdb_dataset.py:338-354)
            warnings.warn(f"failed to load {self.tracks[ti]}@{start}: {exc}")
            zeros = np.zeros((2, self.segment_samples), np.float32)
            return zeros, {s: zeros.copy() for s in self.stems}

    def get_full_track(
        self, track_idx: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Full-length mixture + targets for evaluation
        (reference: musdb_dataset.py:462-491)."""
        if self._mode == "pkg":
            track = self.tracks[track_idx]
            track.chunk_start = 0
            track.chunk_duration = None
            mixture = np.asarray(track.audio, np.float32).T
            sources = {
                s: np.asarray(track.targets[s].audio, np.float32).T
                for s in ALL_SOURCES
            }
            targets = {
                stem: self._select_stem(stem, sources) for stem in self.stems
            }
            return mixture, targets
        track_dir = self.tracks[track_idx]
        length = self._track_lengths[track_idx]
        files = self._source_files(track_dir)
        sources = {s: load_chunk(files[s], 0, length) for s in ALL_SOURCES}
        mixture = sum(sources.values()).astype(np.float32)
        targets = {stem: self._select_stem(stem, sources) for stem in self.stems}
        return mixture, targets

    @property
    def track_names(self) -> List[str]:
        if self._mode == "pkg":
            return [t.name for t in self.tracks]
        return [os.path.basename(t) for t in self.tracks]


def collate(
    samples: Sequence[Tuple[np.ndarray, Dict[str, np.ndarray]]]
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Stack (mixture, targets) tuples -> (B, 2, S) + {stem: (B, 2, S)}
    (reference: musdb_dataset.py:494-522)."""
    mixtures = np.stack([s[0] for s in samples])
    stems = samples[0][1].keys()
    targets = {k: np.stack([s[1][k] for s in samples]) for k in stems}
    return mixtures, targets
