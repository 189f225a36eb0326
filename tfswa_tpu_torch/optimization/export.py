"""Deployment export, BatchNorm folding and inference benchmarking
(counterpart of ``tfswa_tpu/optimization/export.py``, same names).

Artifacts, each of the eval-mode forward on the model's own route, checked
after a reload against the eager forward on a normal probe (max |diff| <
1e-4, the reference's limit):
  - :func:`export_stablehlo` / :func:`load_stablehlo`: ``torch.export``,
    saved with ``torch.export.save`` (the JAX package's portable
    serialized program is StableHLO);
  - :func:`aot_compile`, :func:`export_savedmodel`: a TorchScript trace (in
    memory; saved to a directory);
  - :func:`export_to_onnx`: ``torch.onnx.export`` through the TorchScript
    exporter (opset 14, batch axis dynamic); without the ``onnx`` package
    its one post-step that needs it, which returns the bytes unchanged
    when no custom function is registered, is skipped, as in the JAX
    package; a torch that cannot export without ``onnx`` raises
    ``ImportError`` with the reason;
  - :func:`export_torch_checkpoint`: the reference ``.pt`` format, which
    ``evaluation.load_separator_from_checkpoint`` reads.
Every route exports.  On a kernel route (``"pallas"``, ``"pallas_int8"``,
``"pallas_attn"``) the program holds the kernels' custom ops
(``ops/custom_ops.py``: ``tfswa::fused_row_block``, ...), three a
TFSWABlock, which run the kernel on the card and the plain version on the
CPU once ``tfswa_tpu_torch`` is imported; ``"int8"`` holds its products as
traced on the model's device (``torch._int_mm`` on the card).  ONNX has no
such ops: :func:`export_to_onnx` exports the plain route's graph
(``model.clone("xla")``) whatever the route, as the JAX package's ONNX
export goes through its plain torch mirror.

:func:`fold_batch_norms` folds every eval-mode BatchNorm into the conv
before it, exactly (float64), paired by module structure: a BatchNorm2d
that directly follows a Conv2d / ConvTranspose2d in an ``nn.Sequential``.
:func:`benchmark_model` times a forward on the card (host clock, ending in
``torch.cuda.synchronize``) with the JAX formulas.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import TFSWAUNet

DEFAULT_SHAPE = (1, 2, 1025, 259)    # n_fft 2048, about 6 s of audio


def make_forward_fn(model: TFSWAUNet) -> Callable:
    """The eval-mode forward without autograd: x (B, C, F, T) -> masks."""

    def forward(x):
        model.eval()
        with torch.no_grad():
            return model(x)

    return forward


class _Eval(nn.Module):
    """The model's eval-mode forward as a module of one input, for tracing."""

    def __init__(self, model: TFSWAUNet):
        super().__init__()
        self.model = model.eval()

    def forward(self, x):
        return self.model(x)


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _probe(model: nn.Module, input_shape) -> torch.Tensor:
    x = np.random.default_rng(0).standard_normal(input_shape).astype(np.float32)
    return torch.from_numpy(x).to(_device(model))


def _verify(model: TFSWAUNet, reloaded: Callable, input_shape, what: str) -> float:
    """max |reloaded - eager| on the probe; raises at 1e-4 or more."""
    x = _probe(model, input_shape)
    with torch.no_grad():
        diff = float((reloaded(x) - make_forward_fn(model)(x)).abs().max())
    if not diff < 1e-4:  # explicit raise: asserts vanish under python -O
        raise RuntimeError(f"{what} verification failed: max |diff| {diff}")
    return diff


def export_stablehlo(model: TFSWAUNet, output_path: str,
                     input_shape: Tuple[int, ...] = DEFAULT_SHAPE,
                     verify: bool = True) -> Dict:
    """``torch.export`` of the eval-mode forward at ``input_shape``, saved
    to ``output_path`` (``torch.export.save``); with ``verify``, loaded
    back and run against the eager forward."""
    x = torch.zeros(input_shape, device=_device(model))
    with torch.no_grad():
        program = torch.export.export(_Eval(model), (x,))
    torch.export.save(program, output_path)
    info = {"path": output_path, "bytes": os.path.getsize(output_path),
            "input_shape": list(input_shape), "format": "torch.export"}
    if verify:
        info["max_abs_diff"] = _verify(model, load_stablehlo(output_path), input_shape,
                                       "export")
    return info


def load_stablehlo(path: str) -> Callable:
    """The forward saved by :func:`export_stablehlo`."""
    return torch.export.load(path).module()


def aot_compile(model: TFSWAUNet, input_shape: Tuple[int, ...]) -> torch.jit.ScriptModule:
    """A TorchScript trace of the eval-mode forward at ``input_shape``."""
    x = torch.zeros(input_shape, device=_device(model))
    with torch.no_grad():
        return torch.jit.trace(_Eval(model), (x,), check_trace=False)


def export_savedmodel(model: TFSWAUNet, output_dir: str,
                      input_shape: Tuple[int, ...] = DEFAULT_SHAPE,
                      verify: bool = True) -> Dict:
    """:func:`aot_compile`'s trace saved as ``output_dir/model.pt``
    (``torch.jit.save``), loadable without this package; with ``verify``,
    loaded back and run against the eager forward."""
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "model.pt")
    torch.jit.save(aot_compile(model, input_shape), path)
    info = {"path": output_dir, "bytes": os.path.getsize(path),
            "input_shape": list(input_shape), "format": "torchscript"}
    if verify:
        loaded = torch.jit.load(path, map_location=_device(model))
        info["max_abs_diff"] = _verify(model, loaded, input_shape, "TorchScript")
    return info


@contextlib.contextmanager
def _onnx_proto_passthrough():
    """Let ``torch.onnx.export`` (TorchScript exporter) run without the
    ``onnx`` package: its one step that needs it, ``_add_onnxscript_fn``,
    returns the bytes unchanged when no onnxscript function is registered
    (none is).  With ``onnx`` installed nothing is patched.  Raises
    ImportError when this torch has no such step to skip."""
    if importlib.util.find_spec("onnx") is not None:
        yield
        return
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    except ImportError as exc:
        raise ImportError(f"torch {torch.__version__} cannot export ONNX without the onnx "
                          f"package: {exc}") from exc
    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    try:
        yield
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def export_to_onnx(model: TFSWAUNet, output_path: str,
                   input_shape: Tuple[int, ...] = DEFAULT_SHAPE, opset_version: int = 14,
                   verify: bool = True) -> Dict:
    """ONNX export of the eval-mode forward (the reference's shape and
    opset), the batch axis dynamic; the time axis is not (SWA's padding is
    fixed at trace time: export one artifact per segment length).  The
    graph is the plain route's (``model.clone("xla")`` for any other
    route: ONNX cannot hold the kernels' custom ops, and the JAX package
    exports its plain mirror whatever the route).  With ``verify`` the
    traced graph is run against the eager forward (of the plain route)
    first.  The artifact embeds the weights, so it must hold at least their
    bytes (4 a parameter in f32, 2 in bf16)."""
    if model.attention_impl != "xla":
        model = model.clone("xla")
    info: Dict = {"path": output_path, "input_shape": list(input_shape),
                  "opset_version": opset_version}
    if verify:
        info["max_abs_diff_traced"] = _verify(model, aot_compile(model, input_shape),
                                              input_shape, "traced graph")
    probe = _probe(model, input_shape)
    with _onnx_proto_passthrough(), torch.no_grad():
        torch.onnx.export(_Eval(model), (probe,), output_path, opset_version=opset_version,
                          dynamo=False, input_names=["spectrogram"], output_names=["masks"],
                          dynamic_axes={"spectrogram": {0: "batch"}, "masks": {0: "batch"}})
    size = os.path.getsize(output_path)
    n_params = sum(p.numel() for p in model.parameters())
    if size < sum(p.numel() * p.element_size() for p in model.parameters()):
        raise RuntimeError(f"ONNX artifact suspiciously small: {size} bytes for "
                           f"{n_params} parameters")
    info["bytes"] = size
    return info


def export_torch_checkpoint(model: TFSWAUNet, output_path: str) -> Dict:
    """The model as a reference-format checkpoint: ``{"model_state_dict",
    "config"}`` (the subset of the reference trainer's dict its loader
    reads), on the CPU."""
    state_dict = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    ckpt = {
        "model_state_dict": state_dict,
        "config": {
            "in_channels": model.in_channels, "out_channels": model.out_channels,
            "depths": list(model.depths), "dims": list(model.dims),
            "window_size": model.window_size, "shift_size": model.shift_size,
            "num_heads": model.num_heads,
        },
    }
    torch.save(ckpt, output_path)
    return {"path": output_path, "num_tensors": len(state_dict)}


def _conv_bn_pairs(model: nn.Module):
    """(conv name, conv, BN name, BN): every BatchNorm2d that directly
    follows a Conv2d or ConvTranspose2d in an ``nn.Sequential``."""
    for name, seq in model.named_modules():
        if not isinstance(seq, nn.Sequential):
            continue
        mods = list(seq.named_children())
        for (cn, conv), (bn_name, bn) in zip(mods, mods[1:]):
            if isinstance(bn, nn.BatchNorm2d) and isinstance(conv, (nn.Conv2d,
                                                                    nn.ConvTranspose2d)):
                yield f"{name}.{cn}", conv, f"{name}.{bn_name}", bn


@torch.no_grad()
def fold_batch_norms(model: TFSWAUNet) -> TFSWAUNet:
    """A copy of ``model`` with every BatchNorm folded into its conv, for
    eval mode: with s = gamma / sqrt(var + eps), W' = W s on the conv's
    output-channel axis (0 for Conv2d, 1 for ConvTranspose2d), b' =
    (b - mean) s + beta, in float64; the BatchNorm becomes the identity
    (mean 0, var 1, gamma sqrt(1 + eps), beta 0), as in the JAX package."""
    out = model.clone()
    for _, conv, _, bn in _conv_bn_pairs(out):
        if conv.bias is None:
            continue   # a bias-free conv keeps its BatchNorm, as in JAX
        mean, var = bn.running_mean.double(), bn.running_var.double()
        s = bn.weight.double() / torch.sqrt(var + bn.eps)
        shape = [1] * conv.weight.dim()
        shape[1 if isinstance(conv, nn.ConvTranspose2d) else 0] = -1
        conv.weight.copy_(conv.weight.double() * s.view(shape))
        conv.bias.copy_((conv.bias.double() - mean) * s + bn.bias.double())
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
        bn.weight.fill_(float(np.sqrt(1.0 + bn.eps)))
        bn.bias.zero_()
    return out


def optimize_for_inference(model: TFSWAUNet) -> Tuple[Callable, TFSWAUNet]:
    """The reference's inference preparation: BatchNorms folded into their
    convs (:func:`fold_batch_norms`), eval mode, no autograd.  Returns
    (forward, folded model)."""
    folded = fold_batch_norms(model).eval()
    for p in folded.parameters():
        p.requires_grad_(False)
    return make_forward_fn(folded), folded


def benchmark_model(forward: Callable, input_shape: Tuple[int, ...] = DEFAULT_SHAPE,
                    num_warmup: int = 3, num_iters: int = 20, hop_length: int = 512,
                    sample_rate: int = 44100, device="cuda") -> Dict[str, float]:
    """Latency and throughput of ``forward`` on a normal probe (numpy seed
    0) on ``device``: host clock around ``num_iters`` calls after
    ``num_warmup``, ending in a synchronize on the card.  The audio a call
    covers is batch x frames x hop / sample rate (the JAX formulas)."""
    device = torch.device(device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(input_shape)
                         .astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(num_warmup):
        forward(x)
    sync()
    t0 = time.perf_counter()
    for _ in range(num_iters):
        forward(x)
    sync()
    elapsed = time.perf_counter() - t0
    return benchmark_numbers(elapsed, num_iters, input_shape, hop_length, sample_rate)


def benchmark_numbers(elapsed: float, num_iters: int, input_shape: Tuple[int, ...],
                      hop_length: int = 512, sample_rate: int = 44100) -> Dict[str, float]:
    """The JAX package's benchmark formulas for ``num_iters`` calls in
    ``elapsed`` seconds on inputs of ``input_shape`` (B, C, F, T)."""
    batch, _, _, time_frames = input_shape
    audio_seconds = batch * time_frames * hop_length / sample_rate
    return {
        "ms_per_iter": 1000.0 * elapsed / num_iters,
        "iters_per_sec": num_iters / elapsed,
        "batch_per_sec": batch * num_iters / elapsed,
        "audio_sec_per_sec": audio_seconds / (elapsed / num_iters),
        "rtf": (elapsed / num_iters) / audio_seconds,
    }


def export_model_info(model: TFSWAUNet, output_path: Optional[str] = None) -> Dict:
    """Parameter counts, in all and by top-level module, the sizes in f32,
    bf16 and int8, and ``get_model_info``; written as JSON if a path is
    given."""
    per_module = {name: int(sum(p.numel() for p in m.parameters()))
                  for name, m in model.named_children()}
    total = int(sum(p.numel() for p in model.parameters()))
    info = {
        "architecture": "TFSWA-UNet (tfswa_tpu_torch)",
        "num_parameters": total,
        "fp32_size_mb": total * 4 / 1024 / 1024,
        "bf16_size_mb": total * 2 / 1024 / 1024,
        "int8_size_mb": total / 1024 / 1024,
        "modules": per_module,
        "model_info": model.get_model_info(model.parameters()),
    }
    if output_path:
        with open(output_path, "w") as fh:
            json.dump(info, fh, indent=2)
    return info
