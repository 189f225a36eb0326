"""Configuration dataclasses of the PyTorch port.

Copies of the model, STFT, data, train and evaluation configs of the JAX
package (``tfswa_tpu/config.py``), so that configs carry over field for
field.  The port keeps its own copy: it imports nothing of the JAX package.
The YAML round trip and the CLI overrides are not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    """TFSWA-UNet architecture config.  The stock widths give 15,404,834
    parameters at in/out_channels=2.

    On the card the kernel routes (``attention_impl`` "pallas",
    "pallas_int8", "pallas_attn") take bf16 rows only: with the default
    ``dtype="float32"`` their wrappers raise (set ``dtype="bfloat16"``, as
    every shipped config does, or use "xla").  They take the widths in
    ``dims`` from (32, 64, 128, 256); "pallas" and "pallas_int8" a head dim
    of 4, 8, 16 or 32 and an MLP width (``mlp_ratio`` times the width) that
    is a multiple of 8; "pallas_attn" 2, 4 or 8 heads.  Any other shape
    raises; none falls back to the plain route.  On the CPU every route
    computes."""

    in_channels: int = 4          # stereo complex spectrogram: [re_L, re_R, im_L, im_R]
    out_channels: int = 4         # 2 * n_stems mask channels
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    dims: Tuple[int, ...] = (32, 64, 128, 256)
    window_size: int = 8
    shift_size: int = 4
    num_heads: int = 8
    dropout: float = 0.0
    mlp_ratio: float = 4.0
    use_shift_mask: bool = False
    # "pallas": the fused row-block kernel (CUDA on the card);
    # "pallas_int8": the fused block with int8 scores (serving only: the
    # train step refuses it); "pallas_attn": the bilinear attention kernel
    # between plain LN and MLP; "xla": the plain PyTorch row-block path.
    # The names are the JAX package's, so configs carry over.
    attention_impl: str = "xla"
    # Unused by the port: its plain route chunks rows by the bytes of the
    # score planes (ops/fused_block.MAX_SCORE_BYTES), not by a row count.
    attn_chunk_size: int = 16
    remat: bool = False           # not ported yet: from_config raises on True
    dtype: str = "float32"        # compute dtype ("float32" | "bfloat16")
    param_dtype: str = "float32"  # only "float32" is ported


@dataclass
class STFTConfig:
    """STFT front-end config."""

    n_fft: int = 2048
    hop_length: int = 512
    win_length: Optional[int] = None
    window: str = "hann"          # hann | hamming | blackman
    center: bool = True
    pad_mode: str = "reflect"
    sample_rate: int = 44100
    # Kept for config compatibility.  The port always computes the DFT in
    # float32; the JAX package's "default" is a 1-pass bf16 DFT on a TPU.
    precision: str = "highest"


@dataclass
class DataConfig:
    """Data config: the one field of the JAX package's DataConfig that the
    training path reads (the data pipeline is not ported)."""

    stems: Tuple[str, ...] = ("vocals", "other")


@dataclass
class TrainConfig:
    """Training config: the JAX package's fields that the train step and
    its optimizer read, with its defaults.  The others (the MR-STFT loss,
    the Trainer's epochs, logging, SDR evaluation and checkpoints) wait
    for what reads them, so that no option is dropped without a word."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    max_epochs: int = 300
    warmup_steps: int = 0
    lr_min: float = 1e-6            # cosine eta_min
    gradient_clip_val: float = 1.0
    l1_weight: float = 1.0
    train_mask_mode: str = "parity"  # "parity" (double sigmoid) | "direct"
    freq_policy: str = "full"       # "full" | "crop_pow2" (drop the Nyquist row)
    seed: int = 42


@dataclass
class EvalConfig:
    """Inference config: the serving knobs of the JAX package."""

    segment_seconds: float = 10.0
    overlap: float = 0.25
    mask_mode: str = "trainer"      # "trainer" | "direct" | "mag_direct"
    normalize: bool = False         # SpectrogramNormalizer on model input
    framewise_seconds: float = 10.0
    segment_batch: int = 8          # segments per device batch
    transfer_dtype: str = "float32" # "float32" | "float16" | "int16"
    device_ola: bool = False        # overlap-add on the device
    ola_bucket_seconds: float = 60.0
    freq_policy: str = "full"       # "full" | "crop_pow2" (drop the Nyquist row)
    stft_precision: str = ""        # "" keeps STFTConfig's (float32 either way)
    stream_max_in_flight: int = 2

    @classmethod
    def fast_serving(cls, **overrides) -> "EvalConfig":
        """The serving preset: batches of 8, float16 transfers, device
        overlap-add in 60 s windows, Nyquist-row crop."""
        cfg = cls(
            segment_batch=8,
            transfer_dtype="float16",
            device_ola=True,
            ola_bucket_seconds=60.0,
            freq_policy="crop_pow2",
            stft_precision="default",
        )
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
