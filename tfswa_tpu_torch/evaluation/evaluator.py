"""Dataset evaluators: separation of each track -> metrics -> JSON
(counterpart of ``tfswa_tpu/evaluation/evaluator.py``).

``MUSDB18Evaluator`` takes the official museval metrics when the package
imports and the port's own metrics (``MetricsCalculator``, on the
separator's device) otherwise.  The aggregate is the mean, std and median
of each metric of each stem, and the mean SDR over the stems.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.wav import write_wav
from .inference import SourceSeparator, read_audio
from .metrics import MetricsCalculator


def _museval_available() -> bool:
    """Checked when an evaluator is built, not at import, so that a museval
    installed or injected later is taken."""
    try:
        import museval  # noqa: F401

        return True
    except Exception:  # noqa: BLE001 (an optional package that may fail in any way)
        return False


def _nanmedian(x) -> float:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return float(np.nanmedian(np.asarray(x, dtype=np.float64)))


def _write_results(results: Dict, output_dir: Optional[str]) -> None:
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.json"), "w") as fh:
            json.dump(results, fh, indent=2)


class MUSDB18Evaluator:
    """Evaluate a separator over a MUSDB18-style dataset: one that has
    ``get_full_track(i) -> (mixture (2, S), {stem: (2, S)})`` and
    ``track_names``, as ``MUSDB18Dataset`` and ``SyntheticDataset`` do."""

    def __init__(self, separator: SourceSeparator, dataset, output_dir: Optional[str] = None,
                 use_museval: bool = True, segment_seconds: float = 10.0,
                 save_estimates: bool = False, max_tracks: Optional[int] = None):
        self.separator = separator
        self.dataset = dataset
        self.output_dir = output_dir
        self.use_museval = use_museval and _museval_available()
        self.segment_seconds = segment_seconds
        self.save_estimates = save_estimates
        self.max_tracks = max_tracks

    def evaluate_track(self, track_idx: int) -> Dict[str, Dict[str, float]]:
        """{stem: {metric: value}} of one track, against the channel mean
        of its references."""
        mixture, references = self.dataset.get_full_track(track_idx)
        estimates = self.separator.separate(mixture)
        if self.save_estimates and self.output_dir:
            self._save_estimates(self.dataset.track_names[track_idx], estimates)
        refs_mono = {k: np.asarray(v).mean(axis=0) for k, v in references.items()}
        ests_mono = {k: np.asarray(v)[0] for k, v in estimates.items()}
        if self.use_museval:
            return self._museval_metrics(refs_mono, ests_mono)
        return self._custom_metrics(refs_mono, ests_mono)

    def _save_estimates(self, track_name: str, estimates: Dict) -> None:
        """``<output_dir>/estimates/<track>/<stem>.wav``, PCM16."""
        track_dir = os.path.join(self.output_dir, "estimates", track_name.replace(os.sep, "_"))
        os.makedirs(track_dir, exist_ok=True)
        for stem, wav in estimates.items():
            write_wav(os.path.join(track_dir, f"{stem}.wav"), wav, self.separator.sample_rate)

    def _custom_metrics(self, refs, ests) -> Dict[str, Dict[str, float]]:
        sr = self.separator.sample_rate
        calc = MetricsCalculator(sample_rate=sr, segment_length=int(self.segment_seconds * sr),
                                 device=self.separator.device)
        sources = np.stack([refs[k] for k in refs])
        return {stem: calc.compute(ests[stem], refs[stem], sources)
                for stem in ests if stem in refs}

    def _museval_metrics(self, refs, ests) -> Dict[str, Dict[str, float]]:
        """museval's metrics, the nan-median over its frames."""
        import museval

        stems = [s for s in ests if s in refs]
        ref_arr = np.stack([refs[s] for s in stems])[..., None]   # (S, T, 1)
        est_arr = np.stack([ests[s] for s in stems])[..., None]
        win = int(self.segment_seconds * self.separator.sample_rate)
        sdr, isr, sir, sar = museval.evaluate(ref_arr, est_arr, win=win, hop=win)
        return {stem: {"sdr": _nanmedian(sdr[i]), "isr": _nanmedian(isr[i]),
                       "sir": _nanmedian(sir[i]), "sar": _nanmedian(sar[i])}
                for i, stem in enumerate(stems)}

    def evaluate(self) -> Dict:
        """Every track (the first ``max_tracks``), then the aggregate;
        ``results.json`` in ``output_dir`` when one is given.  A track that
        fails is warned about and left out."""
        names = self.dataset.track_names
        n = len(names) if self.max_tracks is None else min(self.max_tracks, len(names))
        per_track: Dict[str, Dict] = {}
        for i in range(n):
            try:
                per_track[names[i]] = self.evaluate_track(i)
            except Exception as exc:  # noqa: BLE001 (as the JAX package: skip the track)
                warnings.warn(f"track {names[i]} failed: {exc}")
        results = {"tracks": per_track, "aggregated": aggregate_track_metrics(per_track)}
        _write_results(results, self.output_dir)
        return results

    @staticmethod
    def print_summary(results: Dict) -> None:
        agg = results["aggregated"]
        print(f"Evaluated {len(results['tracks'])} tracks")
        for stem, stats in agg.items():
            if stem == "overall":
                continue
            line = ", ".join(f"{m}: {v['mean']:.2f}+/-{v['std']:.2f} (median {v['median']:.2f})"
                             for m, v in stats.items())
            print(f"  {stem}: {line}")
        if "overall" in agg:
            print(f"  overall: {agg['overall']}")


def aggregate_track_metrics(per_track: Dict[str, Dict]) -> Dict:
    """Mean, std and median of each metric of each stem over the tracks,
    and ``overall.sdr_mean``, the mean over the stems of their mean SDR."""
    stems: Dict[str, Dict[str, List[float]]] = {}
    for track_metrics in per_track.values():
        for stem, metrics in track_metrics.items():
            for metric, value in metrics.items():
                stems.setdefault(stem, {}).setdefault(metric, []).append(value)
    agg: Dict = {stem: {m: {"mean": float(np.mean(v)), "std": float(np.std(v)),
                            "median": float(np.median(v))} for m, v in metrics.items()}
                 for stem, metrics in stems.items()}
    sdr_means = [agg[stem]["sdr"]["mean"] for stem in agg if "sdr" in agg[stem]]
    if sdr_means:
        agg["overall"] = {"sdr_mean": float(np.mean(sdr_means))}
    return agg


class CustomDatasetEvaluator:
    """Evaluate over a directory of mixture WAVs (``<name>.wav``) and one
    of references (``<name>/<stem>.wav``)."""

    def __init__(self, separator: SourceSeparator, mixtures_dir: str, references_dir: str,
                 stems: Sequence[str] = ("vocals", "other"), output_dir: Optional[str] = None,
                 segment_seconds: float = 10.0):
        self.separator = separator
        self.mixtures_dir = mixtures_dir
        self.references_dir = references_dir
        self.stems = tuple(stems)
        self.output_dir = output_dir
        self.segment_seconds = segment_seconds

    def evaluate(self) -> Dict:
        """Every mixture in name order; a file that fails is warned about
        and left out."""
        per_track: Dict[str, Dict] = {}
        files = sorted(f for f in os.listdir(self.mixtures_dir) if f.endswith(".wav"))
        sr = self.separator.sample_rate
        calc = MetricsCalculator(sample_rate=sr, segment_length=int(self.segment_seconds * sr),
                                 device=self.separator.device)
        for fname in files:
            base = os.path.splitext(fname)[0]
            try:
                mixture, _ = read_audio(os.path.join(self.mixtures_dir, fname))
                refs = {stem: read_audio(os.path.join(self.references_dir, base,
                                                      f"{stem}.wav"))[0].mean(axis=0)
                        for stem in self.stems}
                ests = self.separator.separate(mixture)
                sources = np.stack([refs[s] for s in self.stems])
                per_track[base] = {stem: calc.compute(ests[stem][0], refs[stem], sources)
                                   for stem in self.stems}
            except Exception as exc:  # noqa: BLE001 (as the JAX package: skip the file)
                warnings.warn(f"{base} failed: {exc}")
        results = {"tracks": per_track, "aggregated": aggregate_track_metrics(per_track)}
        _write_results(results, self.output_dir)
        return results
