"""The port's modules against their JAX counterparts, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
packages.  Tolerances (all f32):
  - STFT / iSTFT: the JAX package projects frames on a DFT basis at HIGHEST
    precision, the port calls torch.stft (an FFT); sums of 256 terms in
    another order differ by ~1e-6 relative, so rtol = atol = 1e-4.
  - masks, windowing, bilinear resize: the same elementwise arithmetic or
    pure data movement, so 1e-6 (windowing exact).
  - whole model: convs, 3 attentions per block and f32 sums in another
    order, with activations kept O(1); sigmoid outputs in (0, 1), atol 1e-5
    (~100 f32 ULP at 0.5, for error grown over 5 blocks and 8 resamplings).
"""
import importlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.models.layers import bilinear_resize as jax_resize
from tfswa_tpu.ops.windowing import window_partition as jax_partition
from tfswa_tpu.ops.windowing import window_reverse as jax_reverse
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.models.layers import bilinear_resize
from tfswa_tpu_torch.ops import masking
from tfswa_tpu_torch.ops.windowing import window_partition, window_reverse
from tfswa_tpu_torch.weights import mapping, state_dict_from_jax

# tfswa_tpu.ops and tfswa_tpu_torch.ops re-export functions under these
# module names
jax_masking = importlib.import_module("tfswa_tpu.ops.masking")
jax_stft = importlib.import_module("tfswa_tpu.ops.stft")
port_stft = importlib.import_module("tfswa_tpu_torch.ops.stft")

SMALL = dict(depths=(2, 1, 1, 1), dims=(16, 32, 64, 128), window_size=4,
             shift_size=2, num_heads=4)


@pytest.mark.parametrize("S", [1000, 1024])
def test_stft_matches_jax(S):
    x = np.random.default_rng(S).standard_normal((2, 2, S)).astype(np.float32)
    ref = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft=256, hop_length=64))
    out = port_stft.stft(torch.from_numpy(x), n_fft=256, hop_length=64).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("length", [1000, 1100])
def test_istft_matches_jax(length):
    rng = np.random.default_rng(length)
    spec = (rng.standard_normal((2, 129, 16))
            + 1j * rng.standard_normal((2, 129, 16))).astype(np.complex64)
    ref = np.asarray(jax_stft.istft(jnp.asarray(spec), n_fft=256, hop_length=64,
                                    length=length))
    out = port_stft.istft(torch.from_numpy(spec), n_fft=256, hop_length=64,
                          length=length).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_model_input_and_trainer_masks_match_jax():
    rng = np.random.default_rng(0)
    out = rng.uniform(0, 1, (2, 4, 9, 7)).astype(np.float32)
    mag = rng.uniform(0, 2, (2, 9, 7)).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, 9, 7)).astype(np.float32)
    ref = np.asarray(jax_masking.trainer_masked_complex(
        jnp.asarray(out), jnp.asarray(mag), jnp.asarray(phase), 2))
    got = masking.trainer_masked_complex(torch.from_numpy(out), torch.from_numpy(mag),
                                         torch.from_numpy(phase), 2).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    ref_d = np.asarray(jax_masking.apply_magnitude_masks(
        jnp.asarray(out), jnp.asarray(mag), 2, "direct"))
    got_d = masking.apply_magnitude_masks(torch.from_numpy(out), torch.from_numpy(mag),
                                          2, "direct").numpy()
    np.testing.assert_allclose(got_d, ref_d, rtol=1e-6, atol=1e-6)
    spec = (rng.standard_normal((2, 2, 9, 7))
            + 1j * rng.standard_normal((2, 2, 9, 7))).astype(np.complex64)
    np.testing.assert_allclose(
        masking.apply_direct_masks(torch.from_numpy(out), torch.from_numpy(spec), 2).numpy(),
        np.asarray(jax_masking.apply_direct_masks(jnp.asarray(out), jnp.asarray(spec), 2)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        port_stft.STFTProcessor.to_model_input(torch.from_numpy(spec)).numpy(),
        np.asarray(jax_stft.STFTProcessor.to_model_input(jnp.asarray(spec))))


def test_window_partition_and_reverse_match_jax():
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(jax_partition(jnp.asarray(x), 4))
    got = window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        window_reverse(got, 4, 2, 8, 12).numpy(),
        np.asarray(jax_reverse(jnp.asarray(ref), 4, 2, 8, 12)))


@pytest.mark.parametrize("src,dst", [((6, 10), (7, 11)), ((7, 9), (15, 19)),
                                     ((107, 5), (215, 5))])
def test_bilinear_upsampling_matches_jax_including_edges(src, dst):
    x = np.random.default_rng(2).standard_normal((1, *src, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), dst))
    got = bilinear_resize(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    for edge in (0, -1):
        np.testing.assert_allclose(got[:, edge], ref[:, edge], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[:, :, edge], ref[:, :, edge], rtol=1e-6, atol=1e-6)


def test_parameter_count_at_stock_widths():
    assert TFSWAUNet(2, 2).count_parameters() == 15_404_834


def test_mapping_names_every_state_dict_entry_at_stock_depths():
    sd_keys = set(TFSWAUNet(4, 4).state_dict())
    mapped = {name for name, _, _ in mapping((2, 2, 6, 2))}
    tracked = {k for k in sd_keys if k.endswith("num_batches_tracked")}
    assert mapped | tracked == sd_keys


def _perturbed_variables(variables, seed):
    """JAX init leaves plus noise, with non-trivial BatchNorm stats, as numpy.
    Conv kernels are scaled down so that activations stay O(1) through the
    residual stack and the sigmoid head does not saturate."""
    rng = np.random.default_rng(seed)

    def walk(tree, path):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        a = np.asarray(tree, dtype=np.float32)
        leaf = path[-1]
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf in ("mean", "bias") or leaf.endswith("_bias"):
            return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if leaf == "scale" or leaf.endswith("_scale"):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if leaf == "kernel" and a.ndim == 4:
            return (0.4 * a).astype(np.float32)
        return a

    return walk(variables, ())


@pytest.fixture(scope="module")
def small_models():
    """One JAX forward (interpret mode) and the port model with the same
    weights, shared by the tests of this module."""
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="pallas", **SMALL)
    x = np.random.default_rng(3).standard_normal((1, 4, 33, 13)).astype(np.float32)
    variables = _perturbed_variables(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 16, 16))), seed=4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                  jnp.asarray(x), train=False))
    pm = TFSWAUNet(4, 4, attention_impl="pallas", **SMALL)
    pm.load_state_dict(state_dict_from_jax(variables, SMALL["depths"]))
    return pm, x, ref


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_whole_model_matches_jax(small_models, impl):
    pm, x, ref = small_models
    pm = TFSWAUNet(4, 4, attention_impl=impl, **SMALL)
    pm.load_state_dict(small_models[0].state_dict())
    with torch.inference_mode():
        out = pm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 4, 33, 13)
    assert ((ref > 0.05) & (ref < 0.95)).all() and ref.std() > 0.01   # not saturated
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_unported_attention_impl_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        TFSWAUNet(2, 2, attention_impl="triton")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, tfswa_tpu_torch\n"
        "for m in pkgutil.walk_packages(tfswa_tpu_torch.__path__, 'tfswa_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tfswa_tpu', 'bench')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('tfswa_tpu_torch')]))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 12
