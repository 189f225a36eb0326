"""tfswa_tpu_torch: the PyTorch + CUDA port of tfswa_tpu for NVIDIA Hopper.

  - config.py     model / STFT / data / train / evaluation configs (copies of
                  the JAX ones)
  - ops/          STFT, masks, windowing, the kernel wrappers (fused row
                  block, bilinear row attention, the kernel lab's forms)
  - csrc/         hand-written CUDA C++ kernels (sm_90a), built by ops/_build.py
  - models/       TFSWA-UNet under the reference's state_dict names
  - training/     losses, optimizer, the train and eval steps
  - data/         the synthetic dataset
  - evaluation/   overlap-add separation (SourceSeparator)
  - tools/        the kernel lab's command line (python -m tfswa_tpu_torch.tools.kernel_lab)
  - weights.py    JAX variables <-> the port's state_dict

The package imports torch and never JAX or the JAX package.
"""

from .config import Config, DataConfig, EvalConfig, ModelConfig, STFTConfig, TrainConfig

__all__ = ["Config", "DataConfig", "EvalConfig", "ModelConfig", "STFTConfig", "TrainConfig"]
