"""``optimization/export.py`` against the JAX package's, on the CPU.

Tolerances: folded parameters and statistics within 1e-6 of JAX's after
the layout map (both fold in float64 and round to f32 once); the folded
forward within 1e-5 of the unfolded one (f32 products of folded weights
against the BN after the conv, and the identity BN's rsqrt(1 + eps) x
sqrt(1 + eps), which is 1 within an f32 ulp); the exported programs within
1e-4 of the eager forward (the reference's export limit; they run the same
ops, so in fact much closer).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.optimization import export as jx
from tfswa_tpu_torch.evaluation import load_separator_from_checkpoint
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.optimization import export as px
from tfswa_tpu_torch.weights import conv_bn_pairs, variables_from_state_dict

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
def model():
    return perturbed_model(seed=4, qkv_gain=4.0)


def _x(seed=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(SHAPE)
                            .astype(np.float32))


def test_bn_pairs_by_structure_are_the_jax_pairs_by_name(model):
    ours = [(c, b) for c, _, b, _ in px._conv_bn_pairs(model)]
    assert sorted(ours) == sorted(conv_bn_pairs(SMALL["depths"]))
    assert len(ours) == 2 * 9 + 3 + 3 + 2        # blocks, down, up, stem + head


def test_fold_batch_norms_matches_jax_and_keeps_the_forward(model):
    variables = variables_from_state_dict(model.state_dict(), SMALL["depths"])
    ref = jx.fold_batch_norms(jax.tree_util.tree_map(jnp.asarray, variables))
    folded = px.fold_batch_norms(model)
    ours = variables_from_state_dict(folded.state_dict(), SMALL["depths"])
    for coll in ("params", "batch_stats"):
        for path, v in jax.tree_util.tree_leaves_with_path(ref[coll]):
            node = ours[coll]
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, np.asarray(v), rtol=1e-6, atol=1e-6,
                                       err_msg=str(path))
    assert not torch.equal(folded.stem[0].weight, model.stem[0].weight)
    x = _x()
    with torch.no_grad():
        torch.testing.assert_close(folded(x), model(x), rtol=0, atol=1e-5)
    fwd, opt = px.optimize_for_inference(model)
    assert not any(p.requires_grad for p in opt.parameters())
    torch.testing.assert_close(fwd(x), folded(x), rtol=0, atol=0)


def test_benchmark_model_formulas():
    """ms/iter, items and batches a second, audio-s/s and RTF as JAX
    computes them; the timed run on the CPU gives the same keys."""
    shape = (8, 4, 1024, 862)
    got = px.benchmark_numbers(2.0, 4, shape)
    audio = 8 * 862 * 512 / 44100
    assert got == pytest.approx({"ms_per_iter": 500.0, "iters_per_sec": 2.0,
                                 "batch_per_sec": 16.0, "audio_sec_per_sec": audio / 0.5,
                                 "rtf": 0.5 / audio})
    calls = []
    res = px.benchmark_model(lambda x: calls.append(x.shape), input_shape=(2, 4, 16, 8),
                             num_warmup=2, num_iters=3, device="cpu")
    assert len(calls) == 5 and set(res) == set(got)


def test_export_model_info_counts_the_jax_parameters(model, tmp_path):
    jm = JaxUNet(in_channels=4, out_channels=4, **SMALL)
    variables = variables_from_state_dict(model.state_dict(), SMALL["depths"])
    ref = jx.export_model_info(jm, variables)
    path = str(tmp_path / "info.json")
    info = px.export_model_info(model, path)
    assert os.path.exists(path)
    assert info["num_parameters"] == ref["num_parameters"] == model.count_parameters()
    assert sum(info["modules"].values()) == info["num_parameters"]
    for k in ("fp32_size_mb", "bf16_size_mb", "int8_size_mb"):
        assert info[k] == pytest.approx(ref[k])
    want = dict(jm.get_model_info(variables["params"]))
    got = dict(info["model_info"])
    assert got.pop("architecture") != want.pop("architecture")
    assert got == want


def test_torch_export_round_trip(model, tmp_path):
    path = str(tmp_path / "model.pt2")
    info = px.export_stablehlo(model, path, input_shape=SHAPE)
    assert info["bytes"] > 4 * model.count_parameters() and info["max_abs_diff"] < 1e-4
    x = _x(6)
    with torch.no_grad():
        torch.testing.assert_close(px.load_stablehlo(path)(x), model(x), rtol=0, atol=1e-4)


def test_torchscript_round_trip(model, tmp_path):
    info = px.export_savedmodel(model, str(tmp_path / "ts"), input_shape=SHAPE)
    assert info["max_abs_diff"] < 1e-4
    loaded = torch.jit.load(os.path.join(info["path"], "model.pt"))
    x = _x(7)
    with torch.no_grad():
        torch.testing.assert_close(loaded(x), model(x), rtol=0, atol=1e-4)
        torch.testing.assert_close(px.aot_compile(model, SHAPE)(x), model(x), rtol=0,
                                   atol=1e-4)


def test_onnx_export_writes_the_weights(model, tmp_path):
    path = str(tmp_path / "model.onnx")
    try:
        info = px.export_to_onnx(model, path, input_shape=SHAPE)
    except ImportError as exc:          # a torch that needs the onnx package
        pytest.skip(str(exc))
    assert info["bytes"] >= 4 * model.count_parameters()
    assert info["max_abs_diff_traced"] < 1e-4 and info["opset_version"] == 14


def test_torch_checkpoint_served_back(model, tmp_path):
    path = str(tmp_path / "ckpt.pt")
    info = px.export_torch_checkpoint(model, path)
    assert info["num_tensors"] == len(model.state_dict())
    from tfswa_tpu_torch.config import ModelConfig

    sep = load_separator_from_checkpoint(path, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(sep.model.state_dict()[k], v), k
    cfg = torch.load(path, weights_only=False)["config"]
    assert cfg == {"in_channels": 4, "out_channels": 4, "depths": list(SMALL["depths"]),
                   "dims": list(SMALL["dims"]), "window_size": 4, "shift_size": 2,
                   "num_heads": 4}
    assert ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items()}).dims == SMALL["dims"]


# the custom op each kernel route's program holds, 3 a TFSWABlock
ROUTE_OPS = {"pallas": "tfswa.fused_row_block", "pallas_int8": "tfswa.fused_row_block_int8",
             "pallas_attn": "tfswa.flash_row_attention", "int8": None}


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8", "pallas_attn", "int8"])
def test_export_of_another_route_raises(model, impl, tmp_path):
    """Every route exports (the name is older than the kernels' custom ops:
    these routes were refused until then).  The torch.export program and
    the TorchScript trace of a kernel route hold its custom op 3 times a
    TFSWABlock and run the plain version here; reloaded, both equal the
    eager forward exactly (the same ops).  "int8" holds its products as
    traced.  ONNX of a kernel route is the plain route's export, byte for
    byte."""
    other = model.clone(impl)
    blocks = 2 * sum(SMALL["depths"][:3]) + SMALL["depths"][3]
    op = ROUTE_OPS[impl]
    path = str(tmp_path / "m.pt2")
    info = px.export_stablehlo(other, path, SHAPE)
    assert info["max_abs_diff"] == 0.0
    if op is not None:
        program = torch.export.load(path)
        held = [str(n.target) for n in program.graph.nodes if "tfswa" in str(n.target)]
        assert held == [f"{op}.default"] * 3 * blocks
        x = _x(8)
        with torch.no_grad():
            assert torch.equal(program.module()(x), other(x))
    traced = px.aot_compile(other, SHAPE)
    kinds = [n.kind() for n in traced.inlined_graph.nodes() if n.kind().startswith("tfswa")]
    assert kinds == ([op.replace(".", "::")] * 3 * blocks if op else [])
    ts = px.export_savedmodel(other, str(tmp_path / "ts"), SHAPE)
    assert ts["max_abs_diff"] == 0.0
    if impl == "pallas":
        paths = [str(tmp_path / f"{m}.onnx") for m in ("kernel", "plain")]
        try:
            px.export_to_onnx(other, paths[0], SHAPE, verify=False)
            px.export_to_onnx(other.clone("xla"), paths[1], SHAPE, verify=False)
        except ImportError as exc:          # a torch that needs the onnx package
            pytest.skip(str(exc))
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert isinstance(other, TFSWAUNet)
