"""Data: MUSDB18 and synthetic datasets, the loader and device prefetch,
augmentation, the numpy WAV reader."""
from .augment import (AudioAugmentation, MixupAugmentation, SpectrogramAugmentation,
                      build_augmentations, frequency_masking, gain, phase_vocoder,
                      pitch_shift, time_masking, time_stretch)
from .musdb import MUSDB18Dataset, collate, load_chunk
from .pipeline import DataLoader, prefetch_to_device
from .synthetic import SyntheticDataset

__all__ = ["AudioAugmentation", "DataLoader", "MUSDB18Dataset", "MixupAugmentation",
           "SpectrogramAugmentation", "SyntheticDataset", "build_augmentations", "collate",
           "frequency_masking", "gain", "load_chunk", "phase_vocoder", "pitch_shift",
           "prefetch_to_device", "time_masking", "time_stretch"]
