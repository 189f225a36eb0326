"""The port's whole-block VJP (B2) plain version against the JAX package's
Pallas kernel, on the CPU.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them: ``_fused_block_impl(..., with_mid=True)`` for the forward's exports
and ``_fused_block_bwd_impl``.  Both sides are fed the same inputs, made
with numpy from a seed (B2 gets the JAX forward's own mid, acc and den).
The helpers here serve ``test_torch_fused_block_train.py`` too.

Tolerances:
  - f32: gradients are sums over R*N tokens of O(1-100) products, in
    another order; the JAX package's own kernel-vs-XLA gradient tolerance,
    1e-4 relative to each leaf's largest magnitude.  One row is x30 so
    that its scores pass SCORE_CLAMP.
  - bf16: both sides round at the same points, but an f32 sum in another
    order now and then flips one bf16 rounding of an intermediate: dx
    within 4 bf16 ULP of its largest magnitude; each parameter gradient
    (an f32 sum over tokens) within 1e-2 of its leaf's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas import autotune
from tfswa_tpu.ops.pallas.fused_block import _fused_block_bwd_impl, _fused_block_impl
from tfswa_tpu_torch.models.attention import RowBlockParams
from tfswa_tpu_torch.ops.fused_block import fused_row_block_bwd_reference

H = 8


@pytest.fixture(autouse=True)
def _own_autotune_dir(monkeypatch, tmp_path):
    """The JAX kernels read per-chip tables: give them an empty one."""
    monkeypatch.setenv("TFSWA_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset()
    yield
    autotune.reset()


def _inputs(R, N, C, seed, qkv_scale=0.25, hot_row=False, hidden=None):
    rng = np.random.default_rng(seed)

    def r(*s, sc=0.05):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    hid = 4 * C if hidden is None else hidden
    p = dict(norm1_scale=1.0 + r(C, sc=0.1), norm1_bias=r(C, sc=0.1),
             qkv_kernel=r(C, 3 * C, sc=qkv_scale), proj_kernel=r(C, C),
             proj_bias=r(C, sc=0.01), norm2_scale=1.0 + r(C, sc=0.1),
             norm2_bias=r(C, sc=0.1), fc1_kernel=r(C, hid), fc1_bias=r(hid, sc=0.01),
             fc2_kernel=r(hid, C), fc2_bias=r(C, sc=0.01))
    rows = r(R, N, C, sc=0.5)
    if hot_row:
        rows[0] *= 30.0
    g = r(R, N, C, sc=1.0)
    return rows, p, g


def _jp(p):
    return JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})


def _tp(p):
    return RowBlockParams(**{k: torch.from_numpy(v) for k, v in p.items()})


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -100))) - 7)


def _jax_forward(rows, p):
    with pltpu.force_tpu_interpret_mode():
        return [np.asarray(a) for a in _fused_block_impl(jnp.asarray(rows), _jp(p), H,
                                                         with_mid=True)]


def _bwd_both(rows, p, g, dtype):
    rows_j = rows.astype(dtype)
    out, mid, acc, den = _jax_forward(rows_j, p)
    g_j = g.astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        jdx, jdp = _fused_block_bwd_impl(jnp.asarray(rows_j), jnp.asarray(mid),
                                         jnp.asarray(acc), jnp.asarray(den),
                                         jnp.asarray(g_j), _jp(p), H)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    dx, dp = fused_row_block_bwd_reference(_t(rows_j, tdt), _t(mid, tdt), _t(acc, tdt),
                                           _t(den), _t(g_j, tdt), _tp(p), H)
    ref = [np.asarray(jdx, np.float32)] + [np.asarray(a, np.float32) for a in jdp]
    return [dx.float().numpy()] + [a.numpy() for a in dp], ref


@pytest.mark.parametrize("R,N", [(2, 37), (2, 64)])
def test_bwd_reference_matches_pallas_f32_with_clamped_row(R, N):
    rows, p, g = _inputs(R, N, 32, seed=100 + N, hot_row=True)
    got, ref = _bwd_both(rows, p, g, jnp.float32)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 1e-4 * scale, (i, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("R,N", [(2, 37), (2, 64)])
def test_bwd_reference_matches_pallas_bf16(R, N):
    rows, p, g = _inputs(R, N, 32, seed=200 + N)
    got, ref = _bwd_both(rows, p, g, jnp.bfloat16)
    dx_scale = np.abs(ref[0]).max()
    assert np.abs(got[0] - ref[0]).max() <= 4 * _ulp(dx_scale)
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 1e-2 * scale, (i, np.abs(a - b).max(), scale)


def test_bwd_reference_matches_pallas_at_an_mlp_width_off_the_kernels_chunks():
    """An MLP of 96 units at C = 32, a multiple of 8 but not of the CUDA
    kernels' hidden chunks (a ragged last chunk on the card), in bf16 with
    the limits of test_bwd_reference_matches_pallas_bf16."""
    rows, p, g = _inputs(2, 37, 32, seed=296, hidden=96)
    got, ref = _bwd_both(rows, p, g, jnp.bfloat16)
    assert got[9].shape == (96,)                 # fc1_bias
    dx_scale = np.abs(ref[0]).max()
    assert np.abs(got[0] - ref[0]).max() <= 4 * _ulp(dx_scale)
    for i, (a, b) in enumerate(zip(got[1:], ref[1:])):
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= 1e-2 * scale, (i, np.abs(a - b).max(), scale)
