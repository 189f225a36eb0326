"""tfswa_tpu_torch: the PyTorch + CUDA port of tfswa_tpu for NVIDIA Hopper.

  - config.py     model / STFT / evaluation configs (copies of the JAX ones)
  - ops/          STFT, masks, windowing, the fused row-block kernel wrapper
  - csrc/         hand-written CUDA C++ kernels (sm_90a), built by ops/_build.py
  - models/       TFSWA-UNet under the reference's state_dict names
  - evaluation/   overlap-add separation (SourceSeparator)
  - weights.py    JAX variables -> the port's state_dict

The package imports torch and never JAX or the JAX package.
"""

from .config import EvalConfig, ModelConfig, STFTConfig

__all__ = ["EvalConfig", "ModelConfig", "STFTConfig"]
