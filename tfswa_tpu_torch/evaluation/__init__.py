"""Evaluation: separation metrics and overlap-add separation."""
from .inference import SourceSeparator, load_separator_from_checkpoint
from .metrics import (MetricsCalculator, bss_eval, compute_musdb_metrics,
                      median_filter_metrics, sar, sdr, si_sdr, sir)

__all__ = ["MetricsCalculator", "SourceSeparator", "bss_eval", "compute_musdb_metrics",
           "load_separator_from_checkpoint", "median_filter_metrics", "sar", "sdr",
           "si_sdr", "sir"]
