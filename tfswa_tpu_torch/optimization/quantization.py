"""int8 quantization (counterpart of ``tfswa_tpu/optimization/quantization.py``).

  - :func:`quantize_params` / :func:`dequantize_params`: symmetric int8 of
    every >= 2-D parameter, one scale per output channel; 1-D parameters
    stay f32.  The output channel sits on axis 0 of ``nn.Linear`` and
    ``nn.Conv2d`` weights and on axis 1 of ``nn.ConvTranspose2d`` ones
    (the JAX kernels keep it last), so the int8 values and scales are the
    JAX package's after the layout map of ``weights.py``.
  - :class:`QuantizedModel`: a model served from int8 weights.
    ``compute="dequant"`` dequantises once and keeps the model's route
    (through ``"pallas"``: 66 B1 launches a forward); ``compute="int8"``
    switches every row block to ``"int8"`` (``ops/int8.py``), with dynamic
    activation scales or the static ones of :func:`quantize_static`.
  - :func:`calibrate_act_scales`, :func:`quantize_static`,
    :func:`quantize_dynamic`, :func:`prepare_qat` / :func:`fake_quantize_params`,
    :class:`QuantizationConfig`, :func:`compare_models`,
    :func:`benchmark_quantized_model`: the JAX functions.

Where the JAX functions take ``(model, variables)``, these take the model
(its parameters and BatchNorm running stats) and return models or state
dicts keyed by parameter name.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import TFSWAUNet
from ..models.attention import _RowBlock
from .export import _device, _probe


def _out_axes(model: nn.Module) -> Dict[str, int]:
    """The output-channel axis of every parameter of ``model``."""
    deconvs = {f"{n}.weight" for n, m in model.named_modules()
               if isinstance(m, nn.ConvTranspose2d)}
    return {n: 1 if n in deconvs else 0 for n, _ in model.named_parameters()}


def _quantize_leaf(x: np.ndarray, out_axis: int) -> Dict:
    """Symmetric int8, one scale per index of ``out_axis`` (the JAX
    package's arithmetic, in numpy f32)."""
    x = np.asarray(x, np.float32)
    if x.ndim < 2:
        return {"kind": "raw", "value": torch.from_numpy(x.copy())}
    axes = tuple(a for a in range(x.ndim) if a != out_axis)
    absmax = np.max(np.abs(x), axis=axes, keepdims=True)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return {"kind": "int8", "value": torch.from_numpy(q),
            "scale": torch.from_numpy(scale.astype(np.float32))}


def _dequantize_leaf(leaf: Dict) -> torch.Tensor:
    if leaf["kind"] == "raw":
        return leaf["value"]
    return leaf["value"].float() * leaf["scale"]


def quantize_params(model: nn.Module) -> Dict[str, Dict]:
    """{parameter name: {"kind": "int8", "value": int8, "scale": f32} or
    {"kind": "raw", "value": f32}} for every parameter of ``model``."""
    axes = _out_axes(model)
    return {n: _quantize_leaf(p.detach().float().cpu().numpy(), axes[n])
            for n, p in model.named_parameters()}


def dequantize_params(qparams: Dict[str, Dict]) -> Dict[str, torch.Tensor]:
    return {n: _dequantize_leaf(leaf) for n, leaf in qparams.items()}


def fake_quantize_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Quantize -> dequantize: the f32 parameters an int8 deployment sees."""
    return dequantize_params(quantize_params(model))


def quantized_size_bytes(qparams: Dict[str, Dict]) -> int:
    total = 0
    for leaf in qparams.values():
        total += leaf["value"].nbytes
        if leaf["kind"] == "int8":
            total += leaf["scale"].nbytes
    return total


def _with_params(model: TFSWAUNet, params: Dict[str, torch.Tensor],
                 attention_impl: Optional[str] = None) -> TFSWAUNet:
    """A copy of ``model`` (its running stats, mode and device) with the
    given parameters and, if given, every row block on ``attention_impl``."""
    out = model.clone(attention_impl)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(params[n])
    return out


def _row_blocks(model: nn.Module) -> Dict[str, _RowBlock]:
    return {n: m for n, m in model.named_modules() if isinstance(m, _RowBlock)}


class QuantizedModel(nn.Module):
    """Serve a model from int8 weights (the reference's ``QuantizableModel``).

    compute="dequant": the weights dequantise once; the products run in
    the model's dtype on its route.  compute="int8": every row block runs
    ``"int8"`` (its dense products int8 x int8 -> int32), with dynamic
    activation scales, or ``act_scales`` ({row-block name: {site: scale}},
    from :func:`calibrate_act_scales`).  The BatchNorm running stats are
    the model's.  Calling it runs the eval-mode forward without autograd."""

    def __init__(self, model: TFSWAUNet, qparams: Dict[str, Dict], compute: str = "dequant",
                 act_scales: Optional[Dict[str, Dict]] = None):
        super().__init__()
        if compute not in ("dequant", "int8"):
            raise ValueError(f"unknown compute mode {compute}")
        self.compute = compute
        self.qparams = qparams
        self.model = _with_params(model, dequantize_params(qparams),
                                  "int8" if compute == "int8" else None).eval()
        self.act_scales = act_scales
        for name, blk in _row_blocks(self.model).items():
            blk.act_scales = None if act_scales is None else act_scales.get(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(x)


def _size_stats(model: nn.Module, qparams: Dict[str, Dict]) -> Dict[str, float]:
    fp32_bytes = sum(p.numel() * 4 for p in model.parameters())
    q_bytes = quantized_size_bytes(qparams)
    return {"fp32_mb": fp32_bytes / 1024 / 1024, "int8_mb": q_bytes / 1024 / 1024,
            "compression_ratio": fp32_bytes / q_bytes}


def quantize_dynamic(model: TFSWAUNet, compute: str = "dequant") -> Tuple[QuantizedModel, Dict]:
    """Dynamic int8: weights quantised per output channel; with
    compute="int8" the dense products run in int8 with per-call activation
    scales.  Returns (quantized model, size stats)."""
    qparams = quantize_params(model)
    return QuantizedModel(model, qparams, compute=compute), _size_stats(model, qparams)


def calibrate_act_scales(model: TFSWAUNet, calibration_batches: Iterable,
                         max_batches: int = 100) -> Dict[str, Dict[str, torch.Tensor]]:
    """The running max of the activation scales each row block uses on its
    int8 route, over at most ``max_batches`` model inputs:
    {row-block name: {"qkv", "proj", "fc1", "fc2": f32 scalar}}."""
    int8_model = model.clone("int8").eval()
    blocks = _row_blocks(int8_model)
    for blk in blocks.values():
        blk.act_scales, blk.act_stats = None, {}
    seen = 0
    with torch.no_grad():
        for i, batch in enumerate(calibration_batches):
            if i >= max_batches:
                break
            int8_model(torch.as_tensor(np.asarray(batch, np.float32)).to(_device(model)))
            seen += 1
    if not seen:
        raise ValueError("calibration_batches is empty")
    return {n: dict(blk.act_stats) for n, blk in blocks.items()}


def quantize_static(model: TFSWAUNet, calibration_batches=None) -> Tuple[QuantizedModel, Dict]:
    """Static int8: per-channel int8 weights and int8 compute with the
    activation scales calibrated over ``calibration_batches`` (model
    inputs) at the quantized weights; without them, dynamic scales."""
    qparams = quantize_params(model)
    act_scales = None
    if calibration_batches is not None:
        deq = _with_params(model, dequantize_params(qparams))
        act_scales = calibrate_act_scales(deq, calibration_batches)
    qmodel = QuantizedModel(model, qparams, compute="int8", act_scales=act_scales)
    return qmodel, dict(_size_stats(model, qparams), calibrated=act_scales is not None)


def prepare_qat(model: TFSWAUNet) -> TFSWAUNet:
    """QAT preparation: a copy of the model whose parameters carry the
    int8 quantization error (quantize -> dequantize), to fine-tune at the
    quantized operating point."""
    return _with_params(model, fake_quantize_params(model))


@dataclasses.dataclass
class QuantizationConfig:
    """The reference's config holder."""

    mode: str = "dynamic"         # dynamic | static | qat
    dtype: str = "int8"
    per_channel: bool = True

    def apply(self, model: TFSWAUNet):
        if self.mode == "dynamic":
            return quantize_dynamic(model)
        if self.mode == "static":
            return quantize_static(model)
        if self.mode == "qat":
            return prepare_qat(model)
        raise ValueError(f"unknown quantization mode {self.mode}")


def compare_models(model: TFSWAUNet, quantized: nn.Module,
                   input_shape: Tuple[int, ...] = (1, 2, 256, 64)) -> Dict[str, float]:
    """Output MSE / MAE / max |diff| between the model (eval mode) and the
    quantized one on a normal probe from numpy seed 0."""
    x = _probe(model, input_shape)
    model.eval()
    with torch.no_grad():
        diff = (model(x).double() - quantized(x).double()).cpu().numpy()
    return {"mse": float(np.mean(diff ** 2)), "mae": float(np.mean(np.abs(diff))),
            "max_abs": float(np.max(np.abs(diff)))}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_quantized_model(model: TFSWAUNet, quantized: nn.Module,
                              input_shape: Tuple[int, ...] = (1, 2, 256, 64),
                              num_iters: int = 10) -> Dict[str, float]:
    """Latency A/B: ms a forward of the model and of the quantized one
    (host clock around ``num_iters`` forwards after one warm-up, ending in
    a synchronize on the card)."""
    x = _probe(model, input_shape)
    model.eval()

    def timed(fn):
        with torch.no_grad():
            fn(x)
            _sync(x.device)
            t0 = time.perf_counter()
            for _ in range(num_iters):
                fn(x)
            _sync(x.device)
        return (time.perf_counter() - t0) / num_iters * 1000

    fp32_ms = timed(model)
    q_ms = timed(quantized)
    return {"fp32_ms": fp32_ms, "int8_ms": q_ms, "speedup": fp32_ms / q_ms}
