"""tfswa_tpu_torch: the PyTorch + CUDA port of tfswa_tpu for NVIDIA Hopper.

  - config.py     model / STFT / data / train / evaluation configs (copies of
                  the JAX ones), YAML and dotted overrides
  - ops/          STFT, masks, windowing and the Swin shift masks, the kernel
                  wrappers (fused row block, bilinear row attention, the kernel
                  lab's forms), the int8 products
  - csrc/         hand-written CUDA C++ kernels (sm_90a), built by ops/_build.py
  - models/       TFSWA-UNet under the reference's state_dict names
  - training/     losses, optimizer, the train and eval steps, checkpoints,
                  the Trainer
  - data/         MUSDB18 and synthetic datasets, the numpy WAV reader, the
                  loader and device prefetch, augmentation
  - evaluation/   overlap-add separation (SourceSeparator), metrics
  - optimization/ remat helpers, int8 quantization (QuantizedModel, static
                  calibration, QAT), BatchNorm folding, export (torch.export,
                  TorchScript, ONNX, the reference .pt), inference benchmarks
  - utils/        profiler traces and annotations, FLOPs, step timing and MFU,
                  device memory
  - cli/          the training, separation and evaluation entry points
                  (python -m tfswa_tpu_torch.cli.train / .separate / .evaluate)
  - tools/        the kernel lab's command line (python -m tfswa_tpu_torch.tools.kernel_lab)
                  and the int8 A/B (python -m tfswa_tpu_torch.tools.bench_int8)
  - weights.py    JAX variables <-> the port's state_dict

The package imports torch and never JAX or the JAX package.  Importing it
registers the serving kernels as torch.library custom ops (ops/custom_ops.py),
which an exported program loaded back calls.
"""

from .config import Config, DataConfig, EvalConfig, ModelConfig, STFTConfig, TrainConfig
from .ops import custom_ops  # noqa: F401  (registers the kernels' torch.library ops)

__all__ = ["Config", "DataConfig", "EvalConfig", "ModelConfig", "STFTConfig", "TrainConfig"]
