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


@pytest.mark.parametrize("N", [37, 65])
def test_bwd_parts_dqkv_matches_autograd_through_the_clamped_attention(N):
    """The attention backward's own output: the plain B2's dqkv in f32
    against torch.autograd through the plain clamped max-free attention
    (the block's forward with the same q|k|v), at a ragged N.  Row 0's q
    and k are scaled so that some of its scores pass SCORE_CLAMP (their
    gradient is 0) and others do not.  Limit: 1e-4 of each of q's, k's and
    v's largest gradient in the row (f32 sums in another order)."""
    R, C = 2, 32
    rows, p, g = _inputs(R, N, C, seed=300 + N)
    tp = _tp(p)
    x, gt = torch.from_numpy(rows), torch.from_numpy(g)
    from tfswa_tpu_torch.ops.fused_block import (
        SCORE_CLAMP, _block_weights, _reference_forward, fused_row_block_bwd_reference,
        fused_row_block_bwd_reference_parts, fused_row_block_train_reference, layer_norm_f32)
    ln_s, ln_b, w_qkv = _block_weights(tp, C, H, torch.float32)[:3]
    qkv = (layer_norm_f32(x, ln_s, ln_b) @ w_qkv).reshape(R * N, 3 * C)
    qkv[:N, :2 * C] *= 6.0                       # row 0: q and k
    q, k = (qkv[:N, i * C:(i + 1) * C].view(N, H, C // H).transpose(0, 1) for i in (0, 1))
    s0 = q @ k.transpose(-1, -2)
    assert s0.max() > SCORE_CLAMP and (s0 < SCORE_CLAMP).float().mean() > 0.5
    _, mid, acc, den = fused_row_block_train_reference(x, tp, H, qkv=qkv)
    parts = fused_row_block_bwd_reference_parts(x, mid, acc, den, gt, tp, H, qkv=qkv)
    assert parts.dqkv.shape == (R, N, 3 * C) and parts.d_oe.shape == (R, N, C)
    assert parts.d_den.shape == (R, N, H)
    dx, dp = fused_row_block_bwd_reference(x, mid, acc, den, gt, tp, H, qkv=qkv)
    assert torch.equal(dx, parts.dx) and all(torch.equal(a, b) for a, b in zip(dp, parts.dp))

    qkv_var = qkv.clone().requires_grad_()
    _reference_forward(x, tp, H, train=False, qkv=qkv_var)[0].backward(gt)
    ref = qkv_var.grad.view(R, N, 3 * C)
    for r in range(R):
        for i in range(3):
            a, b = (t[r, :, i * C:(i + 1) * C] for t in (parts.dqkv, ref))
            scale = b.abs().max().item()
            assert (a - b).abs().max().item() <= 1e-4 * scale, (r, i, scale)
