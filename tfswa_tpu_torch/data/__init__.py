"""Data: the synthetic dataset (the MUSDB pipeline is not ported yet)."""
from .synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
