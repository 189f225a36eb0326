"""Masked SWA (``use_shift_mask=True``) in the port against the JAX package,
on the CPU.

The same weights and inputs (numpy, from seeds) go through both packages
in f32.  Tolerances:
  - the Swin masks: integer region arithmetic, exact;
  - the SWA module: LN, one attention of N = 16 and an MLP, f32 sums in
    another order (the JAX core pairs two heads a score tile), 1e-5;
  - the small model: as ``test_torch_modules.py``'s whole model, atol
    1e-5 on sigmoid outputs;
  - chunked against unchunked: the same arithmetic a chunk of windows at
    a time, so equal bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models.attention import ShiftedWindowAttention as JaxSWA
from tfswa_tpu.ops.windowing import swin_attention_mask as jax_mask
from tfswa_tpu.ops.windowing import swin_mask_table as jax_table
from tfswa_tpu_torch.models import TFSWAUNet, row_transformer_block
from tfswa_tpu_torch.models import attention as port_attention
from tfswa_tpu_torch.models.attention import ShiftedWindowAttention
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops.windowing import swin_attention_mask, swin_mask_table
from tfswa_tpu_torch.weights import _row_block

from _torch_small_model import SMALL, jax_forward, perturbed_model

@pytest.fixture(autouse=True)
def _two_threads():
    """Six test workers share the machine's cores: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("H,W,ws,ss", [(8, 8, 4, 2), (16, 12, 4, 2), (24, 16, 8, 4),
                                        (16, 24, 8, 3), (32, 32, 8, 4)])
def test_swin_masks_equal_jax(H, W, ws, ss):
    dense = swin_attention_mask(H, W, ws, ss)
    np.testing.assert_array_equal(dense, jax_mask(H, W, ws, ss))
    table, idx = swin_mask_table(H, W, ws, ss)
    jt, ji = jax_table(H, W, ws, ss)
    np.testing.assert_array_equal(table, jt)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(table[idx], dense)
    assert set(np.unique(dense)) == {-100.0, 0.0}


def _swa_pair(dim=16, ws=4, ss=2, heads=4, seed=0):
    """The JAX SWA module (use_shift_mask=True) and the port's, same weights."""
    jm = JaxSWA(dim=dim, window_size=ws, num_heads=heads, shift_size=ss, use_shift_mask=True)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, dim)))["params"])
    rng = np.random.default_rng(seed)
    params = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    pm = ShiftedWindowAttention(dim, ws, heads, ss, use_shift_mask=True)
    sd = {name[len("swa."):]: torch.from_numpy(np.array(tf(params[path[-1]])))
          for name, path, tf in _row_block("swa", ())}
    pm.load_state_dict(sd)
    return jm, params, pm


@pytest.mark.parametrize("shape", [(2, 8, 8), (1, 10, 7), (2, 13, 9)])
def test_masked_swa_module_matches_jax(shape):
    jm, params, pm = _swa_pair()
    x = np.random.default_rng(1).standard_normal(shape + (16,)).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = pm(torch.from_numpy(x)).numpy()
        unmasked = ShiftedWindowAttention(16, 4, 4, 2)
        unmasked.load_state_dict(pm.state_dict())
        other = unmasked(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert np.abs(out - other).max() > 1e-3          # the mask does something


@pytest.fixture(scope="module")
def masked_reference():
    pm = perturbed_model(use_shift_mask=True)
    x = np.random.default_rng(3).standard_normal((1, 4, 33, 13)).astype(np.float32)
    return pm, x, jax_forward(pm, x, use_shift_mask=True)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_masked_small_model_matches_jax(masked_reference, impl):
    """The small model with use_shift_mask=True through the port's plain and
    "pallas" routes (the mask sends the shifted SWA blocks to the plain
    route, the rest to B1's plain version) against the JAX model's plain
    route, f32."""
    pm, x, ref = masked_reference
    pm = pm.clone(impl)
    with torch.inference_mode():
        out = pm(torch.from_numpy(x)).numpy()
        unmasked = TFSWAUNet(4, 4, **SMALL)
        unmasked.load_state_dict(pm.state_dict())
        other = unmasked(torch.from_numpy(x)).numpy()
    assert ((ref > 0.05) & (ref < 0.95)).all() and ref.std() > 0.01
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    assert np.abs(out - other).max() > 1e-4


def test_masked_rows_chunked_equal_unchunked(monkeypatch):
    """The factored mask gathered a chunk of windows at a time gives the
    unchunked result bit for bit (MAX_SCORE_BYTES cut to a few windows)."""
    from tfswa_tpu_torch.models.attention import RowBlockParams

    rng = np.random.default_rng(5)
    C, H, ws, ss = 16, 4, 4, 2
    table, idx = swin_mask_table(12, 16, ws, ss)
    idx = np.tile(idx, 3)                      # batch 3
    rows = torch.from_numpy(rng.standard_normal((idx.size, ws * ws, C)).astype(np.float32))
    hidden = 4 * C
    shapes = [(C,), (C,), (C, 3 * C), (C, C), (C,), (C,), (C,), (C, hidden), (hidden,),
              (hidden, C), (C,)]
    p = RowBlockParams(*(torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
                         for s in shapes))
    mask = (torch.from_numpy(table)[:, None], torch.from_numpy(idx).long())
    with torch.no_grad():
        whole = row_transformer_block(rows, p, H, mask=mask)
        monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 5 * H * (ws * ws) ** 2 * 4)
        parts = row_transformer_block(rows, p, H, mask=mask)
        dense = row_transformer_block(rows, p, H, mask=torch.from_numpy(table[idx])[:, None])
    assert torch.equal(whole, parts)
    assert torch.equal(whole, dense)
    rows.requires_grad_(True)                  # under autograd: per-chunk recompute
    g = torch.autograd.grad(row_transformer_block(rows, p, H, mask=mask).square().sum(), rows)[0]
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 1 << 28)
    g_whole = torch.autograd.grad(row_transformer_block(rows, p, H, mask=mask).square().sum(),
                                  rows)[0]
    torch.testing.assert_close(g, g_whole, rtol=1e-6, atol=1e-6)


def test_swa_chunk_follows_its_budget(monkeypatch):
    """SWA's plain route runs max(16, SWA_CHUNK_BYTES // (H N^2 4)) windows a
    chunk; the values do not depend on it."""
    jm, params, pm = _swa_pair()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 16, 16, 16))
                         .astype(np.float32))
    seen = []
    real = port_attention._plain_block
    monkeypatch.setattr(port_attention, "_plain_block",
                        lambda rows, *a: seen.append(rows.shape[0]) or real(rows, *a))
    with torch.no_grad():
        a = pm(x)
        assert seen == [64]                    # 64 windows <= 256 a chunk
        seen.clear()
        monkeypatch.setattr(port_attention, "SWA_CHUNK_BYTES", 4 * 16 ** 2 * 4 * 20)
        b = pm(x)
    assert seen == [20, 20, 20, 4]
    assert torch.equal(a, b)
