"""Optimization: rematerialisation, deployment export, quantization
(counterpart of ``tfswa_tpu/optimization``, the same public names)."""
from .export import (aot_compile, benchmark_model, export_model_info, export_savedmodel,
                     export_stablehlo, export_to_onnx, export_torch_checkpoint,
                     fold_batch_norms, load_stablehlo, make_forward_fn,
                     optimize_for_inference)
from .quantization import (QuantizationConfig, QuantizedModel, benchmark_quantized_model,
                           compare_models, dequantize_params, fake_quantize_params,
                           prepare_qat, quantize_dynamic, quantize_params, quantize_static)
from .remat import (CheckpointConfig, checkpoint_fn, checkpoint_sequential,
                    estimate_activation_memory, get_memory_stats)

__all__ = [
    "CheckpointConfig",
    "checkpoint_fn",
    "checkpoint_sequential",
    "estimate_activation_memory",
    "get_memory_stats",
    "export_savedmodel",
    "export_stablehlo",
    "export_to_onnx",
    "export_torch_checkpoint",
    "load_stablehlo",
    "aot_compile",
    "optimize_for_inference",
    "benchmark_model",
    "export_model_info",
    "make_forward_fn",
    "quantize_params",
    "prepare_qat",
    "QuantizationConfig",
    "dequantize_params",
    "fake_quantize_params",
    "quantize_dynamic",
    "quantize_static",
    "QuantizedModel",
    "compare_models",
    "benchmark_quantized_model",
    "fold_batch_norms",
]
