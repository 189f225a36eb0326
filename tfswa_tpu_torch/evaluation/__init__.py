"""Evaluation: separation metrics, overlap-add separation, dataset evaluators."""
from .inference import BatchSeparator, SourceSeparator, load_separator_from_checkpoint
from .metrics import (MetricsCalculator, bss_eval, compute_musdb_metrics,
                      median_filter_metrics, sar, sdr, si_sdr, sir)
from .evaluator import CustomDatasetEvaluator, MUSDB18Evaluator, aggregate_track_metrics

__all__ = ["BatchSeparator", "CustomDatasetEvaluator", "MUSDB18Evaluator", "MetricsCalculator",
           "SourceSeparator", "aggregate_track_metrics", "bss_eval", "compute_musdb_metrics",
           "load_separator_from_checkpoint", "median_filter_metrics", "sar", "sdr",
           "si_sdr", "sir"]
