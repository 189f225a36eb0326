"""``optimization/quantization.py`` against the JAX package's, on the CPU.

The same weights (the small port model's, carried to JAX by
``weights.variables_from_state_dict``) go through both packages.
Tolerances: the int8 weights and their scales exactly (the same numpy f32
arithmetic, after the layout map), the sizes exactly; the dequantised
model's output within 1e-5 (f32 plain routes, as the whole-model tests);
the int8 routes within 1e-3 and closer to JAX's int8 output than that is
to the f32 output (``test_torch_int8.py`` says why).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.optimization import quantization as jq
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.optimization import quantization as pq
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.weights import _INVERSE, mapping, variables_from_state_dict

from _torch_small_model import SMALL, perturbed_model

SHAPE = (1, 4, 33, 13)


@pytest.fixture(autouse=True)
def _two_threads():
    """Six test workers share the machine's cores: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    pm = perturbed_model(seed=3, qkv_gain=4.0)
    variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(pm.state_dict(), SMALL["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, **SMALL)
    x = np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)
    return pm, jm, variables, x


def _jax_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def test_quantize_params_equal_jax_after_the_layout_map(pair):
    pm, _, variables, _ = pair
    ours = pq.quantize_params(pm)
    theirs = jq.quantize_params(jax.device_get(variables["params"]))
    kinds = {}
    for name, path, transform in mapping(SMALL["depths"]):
        if path[0] != "params":
            continue
        leaf, ref = ours[name], _jax_leaf(theirs, path[1:])
        assert leaf["kind"] == ref["kind"], name
        kinds[leaf["kind"]] = kinds.get(leaf["kind"], 0) + 1
        inv = _INVERSE[transform]
        np.testing.assert_array_equal(inv(leaf["value"].numpy()), ref["value"], err_msg=name)
        if leaf["kind"] == "int8":
            assert leaf["value"].dtype == torch.int8
            np.testing.assert_array_equal(inv(leaf["scale"].numpy()), ref["scale"],
                                          err_msg=name)
    assert set(ours) == {n for n, _ in pm.named_parameters()}
    assert kinds["int8"] > 0 and kinds["raw"] > 0
    # the transposed convs quantise along their output axis, 1
    deconv = ours["upsample_layers.0.upsample.0.weight"]
    assert deconv["scale"].shape == (1, deconv["value"].shape[1], 1, 1)
    assert pq.quantized_size_bytes(ours) == jq.quantized_size_bytes(theirs)


def test_sizes_and_compression_ratio_equal_jax(pair):
    pm, jm, variables, _ = pair
    _, stats = pq.quantize_dynamic(pm)
    _, jstats = jq.quantize_dynamic(jm, variables)
    assert stats == pytest.approx(jstats, rel=1e-12)
    assert stats["compression_ratio"] > 3.0


def test_dequant_model_matches_jax(pair):
    pm, jm, variables, x = pair
    qm, _ = pq.quantize_dynamic(pm, compute="dequant")
    jqm, _ = jq.quantize_dynamic(jm, variables, compute="dequant")
    assert qm.model.attention_impl == "xla"
    out = qm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jqm(jnp.asarray(x))), atol=1e-5, rtol=0)
    deq = pq.dequantize_params(qm.qparams)
    for n, p in qm.model.named_parameters():
        assert torch.equal(p, deq[n]), n


def _close_int8(out, ref, f32):
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    assert np.abs(out - ref).max() < np.abs(ref - f32).max()


def test_int8_model_and_static_quantization_match_jax(pair):
    pm, jm, variables, x = pair
    with torch.no_grad():
        f32 = pm(torch.from_numpy(x)).numpy()
    qm, _ = pq.quantize_dynamic(pm, compute="int8")
    jqm, _ = jq.quantize_dynamic(jm, variables, compute="int8")
    assert all(m.attention_impl == "int8" for m in qm.model.modules()
               if hasattr(m, "attention_impl"))
    _close_int8(qm(torch.from_numpy(x)).numpy(), np.asarray(jqm(jnp.asarray(x))), f32)

    rng = np.random.default_rng(12)
    batches = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2)]
    sm, stats = pq.quantize_static(pm, calibration_batches=batches)
    jsm, jstats = jq.quantize_static(jm, variables, calibration_batches=batches)
    assert stats["calibrated"] is jstats["calibrated"] is True
    scales = [float(v) for s in sm.act_scales.values() for v in s.values()]
    assert len(scales) == 4 * 27 and min(scales) > 0
    _close_int8(sm(torch.from_numpy(x)).numpy(), np.asarray(jsm(jnp.asarray(x))), f32)
    assert not any("act" in k for k in sm.state_dict())
    dyn, stats = pq.quantize_static(pm)
    assert stats["calibrated"] is False and dyn.act_scales is None


def test_prepare_qat_and_config_apply_match_jax(pair):
    pm, jm, variables, _ = pair
    qat = pq.prepare_qat(pm)
    jqat = jq.prepare_qat(jm, jax.device_get(variables))
    ours = variables_from_state_dict(qat.state_dict(), SMALL["depths"])
    for path, ref in jax.tree_util.tree_leaves_with_path(jqat["params"]):
        leaf = _jax_leaf(ours["params"], [k.key for k in path])
        np.testing.assert_array_equal(leaf, np.asarray(ref))
    assert torch.equal(qat.stem[1].running_var, pm.stem[1].running_var)
    for mode in ("dynamic", "static"):
        qm, stats = pq.QuantizationConfig(mode=mode).apply(pm)
        assert isinstance(qm, pq.QuantizedModel)
        assert qm.compute == ("dequant" if mode == "dynamic" else "int8")
    assert isinstance(pq.QuantizationConfig(mode="qat").apply(pm), TFSWAUNet)
    with pytest.raises(ValueError, match="unknown quantization mode"):
        pq.QuantizationConfig(mode="fp4").apply(pm)
    with pytest.raises(ValueError, match="unknown compute mode"):
        pq.QuantizedModel(pm, pq.quantize_params(pm), compute="fp4")


def test_compare_and_benchmark_keys(pair):
    pm, jm, variables, _ = pair
    qm, _ = pq.quantize_dynamic(pm, compute="int8")
    diff = pq.compare_models(pm, qm, input_shape=SHAPE)
    assert set(diff) == {"mse", "mae", "max_abs"}
    # JAX's compare_models, on its jitted forwards: the same probe, seed 0
    jqm, _ = jq.quantize_dynamic(jm, variables, compute="int8")
    x = jnp.asarray(np.random.default_rng(0).standard_normal(SHAPE), jnp.float32)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x)
    jmae = float(np.mean(np.abs(np.asarray(ref) - np.asarray(jqm(x)))))
    assert diff["mae"] == pytest.approx(jmae, rel=0.1)
    assert 0 < diff["mae"] < 0.02                 # JAX's CPU limit at small width
    bench = pq.benchmark_quantized_model(pm, qm, input_shape=SHAPE, num_iters=1)
    assert set(bench) == {"fp32_ms", "int8_ms", "speedup"} and bench["int8_ms"] > 0


def test_training_refuses_the_int8_route():
    cfg = Config(model=ModelConfig(attention_impl="int8", **SMALL))
    with pytest.raises(ValueError, match="inference-only"):
        pts.create_train_state(cfg, device="cpu")
    model = TFSWAUNet(4, 4, attention_impl="int8", **SMALL)
    with pytest.raises(ValueError, match="inference-only"):
        pts.make_train_step(model, STFTProcessor(STFTConfig()), ("vocals", "other"))
