"""Configuration dataclasses of the PyTorch port.

Copies of the model, STFT, data, train and evaluation configs of the JAX
package (``tfswa_tpu/config.py``), with its YAML round trip and dotted CLI
overrides, so that configs carry over field for field.  The port keeps its
own copy: it imports nothing of the JAX package.

Unlike the JAX ``from_dict``, which drops unknown keys, the port raises on
them.  ``ModelConfig.attn_chunk_size``, which the port does not read, loads
only at the JAX default and raises, naming the field, at any other value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass
class ModelConfig:
    """TFSWA-UNet architecture config.  The stock widths give 15,404,834
    parameters at in/out_channels=2.

    On the card the kernel routes (``attention_impl`` "pallas",
    "pallas_int8", "pallas_attn") take bf16 rows (``dtype="bfloat16"``, as
    every shipped config has it: the tensor-core kernels) and f32 rows (the
    default ``dtype="float32"``: their f32 forms); float16 raises.  They
    take every width in ``dims`` that is a multiple of 8 up to 512, any
    ``num_heads`` that divides each width, and an MLP width (``mlp_ratio``
    times the width) that is a multiple of 8.  Any other shape raises,
    naming the field; none falls back to the plain route.  On the CPU every
    route computes.  ``use_shift_mask`` (the Swin mask on the shifted SWA
    blocks) and ``dropout`` (in train mode) send the row blocks concerned
    to the plain route on any ``attention_impl``, as in the JAX package."""

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
    # between plain LN and MLP; "xla": the plain PyTorch row-block path;
    # "int8": the plain path with its four dense products in int8
    # (torch._int_mm on the card; serving only).  The names are the JAX
    # package's, so configs carry over.
    attention_impl: str = "xla"
    # Not read by the port, and refused at any value but the JAX default:
    # its plain route chunks rows by the bytes of the score planes
    # (ops/fused_block.MAX_SCORE_BYTES; SWA by models/attention.SWA_CHUNK_BYTES),
    # not by a row count, which at 16 would multiply its host-bound loop.
    attn_chunk_size: int = 16
    remat: bool = False           # torch.utils.checkpoint around each TFSWABlock
    dtype: str = "float32"        # compute dtype ("float32" | "bfloat16")
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.attn_chunk_size != 16:
            raise NotImplementedError(
                f"model.attn_chunk_size={self.attn_chunk_size!r} is not read by the port "
                "(only the JAX default 16 loads): its plain route chunks rows by the "
                "bytes of the score planes")


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
    """MUSDB18 data pipeline, loader and augmentation config."""

    musdb_root: str = ""
    stems: Tuple[str, ...] = ("vocals", "other")
    segment_seconds: float = 6.0
    sample_rate: int = 44100
    batch_size: int = 4
    random_segments: bool = True    # the training dataset's segment sampling
    segment_overlap: float = 0.5    # validation index
    max_segments_per_track: int = 8
    num_workers: int = 4            # loader threads
    prefetch: int = 2               # batches copied to the device ahead
    augment: bool = False           # AudioAugmentation (stretch, pitch, gain)
    aug_time_stretch: Tuple[float, float] = (0.9, 1.1)
    aug_pitch_shift_semitones: Tuple[float, float] = (-2.0, 2.0)
    aug_gain_db: Tuple[float, float] = (-6.0, 6.0)
    aug_prob: float = 0.5
    mixup: bool = False
    mixup_alpha: float = 0.4
    spec_augment: bool = False      # freq / time masks on the model input
    aug_freq_mask_param: int = 30
    aug_time_mask_param: int = 40


@dataclass
class TrainConfig:
    """Training config: the JAX package's fields with its defaults."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    max_epochs: int = 300
    steps_per_epoch: int = 0        # 0 = derive from the dataset
    warmup_steps: int = 0
    lr_min: float = 1e-6            # cosine eta_min
    gradient_clip_val: float = 1.0
    use_mrstft_loss: bool = False   # the multi-resolution STFT loss on the stems' audio
    l1_weight: float = 1.0
    mrstft_weight: float = 0.5
    train_mask_mode: str = "parity"  # "parity" (double sigmoid) | "direct"
    freq_policy: str = "full"       # "full" | "crop_pow2" (drop the Nyquist row)
    seed: int = 42
    log_every_n_steps: int = 50
    val_every_n_epochs: int = 1
    sdr_eval_num_tracks: int = 5
    sdr_eval_segment_seconds: float = 10.0
    sdr_eval_overlap: float = 0.5
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    keep_checkpoints: int = 5


@dataclass
class EvalConfig:
    """Inference config: the serving knobs of the JAX package."""

    segment_seconds: float = 10.0
    overlap: float = 0.25
    mask_mode: str = "trainer"      # "trainer" | "direct" | "mag_direct"
    normalize: bool = False         # SpectrogramNormalizer on model input
    framewise_seconds: float = 10.0
    segment_batch: int = 8          # segments per device batch
    transfer_dtype: str = "float32" # "float32" | "float16" | "int16" | "int8"
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
class MeshConfig:
    """The (data, model) mesh of ranks (``parallel/mesh.py``): one rank is
    one process on one card.  ``data_axis`` -1 takes the world size divided
    by ``model_axis``."""

    data_axis: int = -1
    model_axis: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------ io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        """Sections and fields as :meth:`to_dict` writes them; lists become
        tuples.  An unknown section or key raises ``ValueError``."""
        sections = {f.name: f.default_factory for f in dataclasses.fields(cls)}
        kwargs = {}
        for name, sub in (d or {}).items():
            if name not in sections:
                raise ValueError(f"unknown config section {name!r}")
            sub_cls = sections[name]
            valid = _field_names(sub_cls)
            filtered = {}
            for k, v in (sub or {}).items():
                if k not in valid:
                    raise ValueError(f"unknown config key {name}.{k}")
                filtered[k] = tuple(v) if isinstance(v, list) else v
            kwargs[name] = sub_cls(**filtered)
        return cls(**kwargs)

    def to_yaml(self, path: str) -> None:
        import yaml

        with open(path, "w") as fh:
            yaml.safe_dump(self.to_dict(), fh, sort_keys=False)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        import yaml

        with open(path) as fh:
            return cls.from_dict(yaml.safe_load(fh))

    # ------------------------------------------------------- cli overrides
    def apply_overrides(self, overrides: Sequence[str]) -> "Config":
        """Apply dotted-path overrides, e.g. ["model.dims=(16,32,64,128)"]."""
        cfg = self
        for ov in overrides:
            key, _, raw = ov.partition("=")
            section, _, attr = key.strip().partition(".")
            sub = getattr(cfg, section) if section in _field_names(cfg) else None
            if sub is None or attr not in _field_names(sub):
                raise ValueError(f"unknown config key {key.strip()!r}")
            val = _parse_value(raw, getattr(sub, attr))
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **{attr: val})})
        return cfg


def _field_names(obj) -> set:
    return {f.name for f in dataclasses.fields(obj)}


def _parse_value(raw: str, current: Any) -> Any:
    """The JAX package's parse of an override against the field's current
    value: bools from 1/true/yes, tuples of the first element's type,
    int, float, None from none/null, else the string."""
    raw = raw.strip()
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(current, tuple):
        inner = raw.strip("()[]")
        parts = [p for p in inner.split(",") if p.strip()]
        elem = current[0] if current else None
        conv = type(elem) if elem is not None else str
        return tuple(conv(p.strip()) for p in parts)
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if current is None:
        if raw.lower() in ("none", "null"):
            return None
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw
