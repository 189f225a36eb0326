"""STFT front end, masks, windowing and the kernels' wrappers."""
from .stft import STFTProcessor, SpectrogramNormalizer, istft, num_frames, stft

__all__ = ["STFTProcessor", "SpectrogramNormalizer", "stft", "istft", "num_frames"]
