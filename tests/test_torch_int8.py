"""The int8 route (``attention_impl="int8"``, ``ops/int8.py``) against the
JAX package's (``tfswa_tpu/ops/int8.py``), on the CPU.

Tolerances:
  - the int8 products: exact integer sums (the plain f32 product of int8
    values is exact for K <= 1040; ``torch._int_mm`` is exact);
  - ``quantize_symmetric``: the same f32 division and round-half-to-even,
    exact;
  - ``int8_row_block``: the scales used within 1e-6 rel. (the absmax of f32
    activations that differ by f32 rounding in the attention core, whose
    sums run in another order); 99 % of the block's outputs within 1e-5 of
    its largest, and every output closer to JAX's than JAX's int8 block is
    to the float block: an activation an f32 ulp from a half step (GELU's
    last bit differs between the packages) rounds to the other int8 value
    in one package now and then (about 1 % of the tokens here), which moves
    a product by one step of its activation scale, and the next product's
    quantisation can spread that over the token;
  - the whole small model (sigmoid outputs): within 1e-3 and closer to
    JAX's int8 route than that is to the f32 route, for the same reason
    after nine blocks; its calibrated scales: the median within 1e-4 rel.
    (f32 convs summed in another order), all within 1e-2 (a block's input
    carries the earlier blocks' int8 flips).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops import int8 as jax_int8
from tfswa_tpu.optimization import quantization as jax_quant
from tfswa_tpu_torch.models.attention import RowBlockParams, _RowBlock, row_transformer_block
from tfswa_tpu_torch.ops import int8
from tfswa_tpu_torch.optimization import quantization
from tfswa_tpu_torch.weights import act_scales_from_jax, act_scales_to_jax, variables_from_state_dict

from _torch_small_model import SMALL, perturbed_model


@pytest.fixture(autouse=True)
def _two_threads():
    """Six test workers share the machine's cores: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("M,K,N", [(24, 16, 8), (37, 64, 96), (64, 1024, 32)])
def test_int8_products_are_exact(M, K, N):
    rng = np.random.default_rng(M)
    x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    want = x.astype(np.int64) @ w.astype(np.int64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = int8.int8_product_reference(xt, wt)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(torch._int_mm(xt, wt).numpy(), want)
    np.testing.assert_array_equal(int8.int8_product(xt, wt).numpy(), want)   # CPU: plain


def test_plain_product_refuses_where_f32_stops_being_exact():
    with pytest.raises(ValueError, match="exact"):
        int8.int8_product_reference(torch.zeros(17, 1048, dtype=torch.int8),
                                    torch.zeros(1048, 8, dtype=torch.int8))


def test_int8_matmul_matches_jax_on_small_ints():
    rng = np.random.default_rng(0)
    xq = rng.integers(-5, 6, (3, 7, 16)).astype(np.int8)
    wq = rng.integers(-5, 6, (16, 8)).astype(np.int8)
    ws = rng.uniform(0.5, 2, (1, 8)).astype(np.float32)
    ref = jax_int8.int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.float32(0.25),
                               jnp.asarray(ws))
    out = int8.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                           torch.tensor(0.25), torch.from_numpy(ws))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("axis,static", [(None, None), ((0,), None), ((0, 1), None),
                                         (None, 0.0123)])
def test_quantize_symmetric_matches_jax(axis, static):
    x = np.random.default_rng(1).standard_normal((6, 5, 12)).astype(np.float32) * 3
    q, s = int8.quantize_symmetric(torch.from_numpy(x), axis=axis,
                                   scale=None if static is None else torch.tensor(static))
    jq, js = jax_int8.quantize_symmetric(jnp.asarray(x), axis=axis,
                                         scale=None if static is None else jnp.float32(static))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _block(C, H, seed=0):
    rng = np.random.default_rng(seed)
    hidden = 4 * C
    shapes = [(C,), (C,), (C, 3 * C), (C, C), (C,), (C,), (C,), (C, hidden), (hidden,),
              (hidden, C), (C,)]
    arrs = [(rng.standard_normal(s) * (0.5 if len(s) == 2 else 0.1)).astype(np.float32)
            for s in shapes]
    arrs[0] += 1.0
    arrs[5] += 1.0
    return (RowBlockParams(*map(torch.from_numpy, arrs)),
            JaxParams(*map(jnp.asarray, arrs)))


@pytest.mark.parametrize("R,N,C,H", [(20, 16, 16, 4), (80, 256, 16, 4), (40, 130, 32, 8)],
                         ids=["one_chunk", "three_chunks", "per_row"])
@pytest.mark.parametrize("static", [False, True])
def test_int8_row_block_matches_jax(R, N, C, H, static):
    """One chunk (R = 20 <= 2^25 // (H N^2 4)), chunks of 32 rows (N = 256),
    and one row a chunk (N = 130, H = 8: the stage-0 case); dynamic scales,
    and static ones."""
    p, jp = _block(C, H)
    rows = np.random.default_rng(R).standard_normal((R, N, C)).astype(np.float32)
    scales = {"qkv": 0.031, "proj": 0.0042, "fc1": 0.027, "fc2": 0.0011} if static else None
    ref, jused = jax_int8.int8_row_block(
        jnp.asarray(rows), jp, H,
        act_scales=None if scales is None else {k: jnp.float32(v) for k, v in scales.items()})
    out, used = int8.int8_row_block(
        torch.from_numpy(rows), p, H,
        act_scales=None if scales is None else {k: torch.tensor(v) for k, v in scales.items()})
    ref = np.asarray(ref)
    assert set(used) == set(jused) == {"qkv", "proj", "fc1", "fc2"}
    for k in used:
        np.testing.assert_allclose(float(used[k]), float(jused[k]), rtol=1e-6)
    err = np.abs(out.numpy() - ref)
    assert (err <= 1e-5 * np.abs(ref).max()).mean() >= 0.99, (err > 1e-5).mean()
    with torch.no_grad():
        exact = row_transformer_block(torch.from_numpy(rows), p, H).numpy()
    assert err.max() <= np.abs(ref - exact).max(), (err.max(), np.abs(ref - exact).max())


def test_int8_row_block_scales_are_per_chunk():
    """Rows of very different size: a chunk's scale is its own absmax /
    127, so the small chunk keeps its resolution (as in JAX)."""
    p, _ = _block(16, 4)
    rows = np.random.default_rng(0).standard_normal((64, 256, 16)).astype(np.float32)
    rows[:32] *= 100.0
    normed = torch.from_numpy(rows)
    s, used = int8._chunk_scales(normed, 32)
    np.testing.assert_allclose(s[0, 0, 0].item(), np.abs(rows[:32]).max() / 127, rtol=1e-6)
    np.testing.assert_allclose(s[-1, 0, 0].item(), np.abs(rows[32:]).max() / 127, rtol=1e-6)
    assert used.item() == s.max().item()


@pytest.fixture(scope="module")
def int8_models():
    """The small port model and the JAX int8 model on the same weights,
    with calibration batches and the JAX calibration."""
    pm = perturbed_model(seed=2, qkv_gain=4.0)
    variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(pm.state_dict(), SMALL["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="int8", **SMALL)
    rng = np.random.default_rng(7)
    batches = [rng.standard_normal((1, 4, 33, 13)).astype(np.float32) for _ in range(2)]
    jax_scales = jax_quant.calibrate_act_scales(jm, variables, batches)
    return pm, variables, jm, batches, jax_scales


def _jax_apply(jm, variables, x, act_scales=None):
    v = dict(variables)
    if act_scales is not None:
        v["act_scales"] = act_scales
    return np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(v, jnp.asarray(x)))


def test_int8_model_matches_jax_dynamic(int8_models):
    pm, variables, jm, batches, _ = int8_models
    ref = _jax_apply(jm, variables, batches[0])
    with torch.no_grad():
        out = pm.clone("int8")(torch.from_numpy(batches[0])).numpy()
        f32 = pm(torch.from_numpy(batches[0])).numpy()
    assert ((ref > 0.05) & (ref < 0.95)).mean() > 0.9
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    # closer to JAX's int8 route than that is to the f32 route
    assert np.abs(out - ref).max() < np.abs(ref - f32).max()


def test_int8_model_with_jax_calibrated_scales_matches_jax(int8_models):
    """JAX's calibrated act_scales carried to the port's row blocks by
    ``weights.act_scales_from_jax``: the static forward equals JAX's; the
    port's own calibration gives JAX's scales."""
    pm, variables, jm, batches, jax_scales = int8_models
    scales = act_scales_from_jax(jax_scales, SMALL["depths"])
    blocks = {n: m for n, m in pm.named_modules() if isinstance(m, _RowBlock)}
    assert set(scales) == set(blocks) and len(blocks) == 3 * 9
    ref = _jax_apply(jm, variables, batches[1], jax_scales)
    model = pm.clone("int8")
    for name, blk in model.named_modules():
        if isinstance(blk, _RowBlock):
            blk.act_scales = scales[name]
    with torch.no_grad():
        out = model(torch.from_numpy(batches[1])).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)

    ours = quantization.calibrate_act_scales(pm, batches)
    back = act_scales_to_jax(ours, SMALL["depths"])
    flat = jax.tree_util.tree_leaves_with_path(jax_scales)
    assert len(flat) == 4 * len(blocks)
    rel = []
    for path, v in flat:
        node = back
        for key in path:
            node = node[key.key]
        rel.append(abs(float(node) / float(v) - 1))
    assert np.median(rel) <= 1e-4 and max(rel) <= 1e-2, sorted(rel)[-5:]
    assert not any("act" in k for k in model.state_dict())   # scales stay out of it
