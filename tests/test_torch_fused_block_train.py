"""The port's training forward (B1-train) plain version against the JAX
package's Pallas kernel, and the differentiable ``fused_row_block`` (the
autograd.Function over B1-train and B2), on the CPU.

The JAX kernel runs in interpret mode: ``_fused_block_impl(...,
with_mid=True)``.  Inputs are made with numpy from a seed (helpers from
``test_torch_fused_block_bwd.py``).

Tolerances:
  - f32, forward: the same arithmetic with sums in another order, at O(1-10)
    activations, so atol = rtol = 2e-5 (the JAX package's kernel-vs-XLA
    tolerance).  den is a sum of up to N values of exp2(s), compared
    relatively (rtol 2e-5).
  - bf16, forward: both sides round at the same points, but an f32 sum in
    another order now and then flips one bf16 rounding: out, mid and acc
    within 2 bf16 ULP elementwise (out and mid, rows plus an update, at
    the larger magnitude of the two).
  - the autograd.Function on the CPU against autograd through the plain
    route (standard softmax, no clamp in reach): f32, 1e-4 of each leaf's
    largest magnitude.
  - chunking and a given q|k|v: per-row values bit for bit, sums over
    chunks to 1e-6 of the leaf's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_fused_block_bwd import (H, _inputs, _jax_forward, _own_autotune_dir,  # noqa: F401
                                        _t, _tp, _ulp)
from tfswa_tpu_torch.models.attention import RowBlockParams, row_transformer_block
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops.fused_block import (fused_row_block, fused_row_block_bwd,
                                             fused_row_block_bwd_reference,
                                             fused_row_block_train,
                                             fused_row_block_train_reference)


@pytest.mark.parametrize("N", [37, 64])
def test_train_forward_reference_matches_pallas_f32(N):
    rows, p, _ = _inputs(2, N, 32, seed=N)
    ref = _jax_forward(rows, p)
    got = fused_row_block_train_reference(_t(rows), _tp(p), H)
    for name, a, b in zip(("out", "mid", "acc", "den"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("N", [37, 64])
def test_train_forward_reference_matches_pallas_bf16(N):
    rows, p, _ = _inputs(2, N, 32, seed=N + 1)
    rows_bf = rows.astype(jnp.bfloat16)
    ref = _jax_forward(rows_bf, p)
    got = fused_row_block_train_reference(_t(rows_bf, torch.bfloat16), _tp(p), H)
    x = np.abs(rows_bf.astype(np.float32))
    for name, a, b in zip(("out", "mid", "acc"), got[:3], ref[:3]):
        b = b.astype(np.float32)
        # out and mid are rows + an update, rounded: their error scales
        # with the larger of the two, also where they cancel
        mag = np.abs(b) if name == "acc" else np.maximum(np.abs(b), x)
        assert np.all(np.abs(a.float().numpy() - b) <= 2 * _ulp(mag)), name
    np.testing.assert_allclose(got[3].numpy(), ref[3], rtol=2e-5)


def test_denominator_is_the_ones_column_of_the_rounded_p():
    """The attention kernel takes each head's denominator from its AV
    product: a ones column beside the head's v columns, so den = sum_k
    p_k * 1 over the bf16-rounded p (the TPU kernel's appended ones row),
    and each head's score from a 16-channel product whose q channels
    outside the head are zero.  That form, on the plain version's q|k|v,
    gives the plain B1-train's den up to the f32 summation order (rtol
    1e-6), and the plain den is the JAX kernel's (rtol 2e-5, as above)."""
    R, N, C, D = 2, 37, 32, 4
    rows, p, _ = _inputs(R, N, C, seed=41)
    rows_bf = rows.astype(jnp.bfloat16)
    jax_den = _jax_forward(rows_bf, p)[3]
    x, tp = _t(rows_bf, torch.bfloat16), _tp(p)
    ln_s, ln_b, w_qkv = (w.float() for w in fused_block._block_weights(tp, C, H,
                                                                        torch.bfloat16)[:3])
    n1 = fused_block.layer_norm_f32(x.float(), ln_s, ln_b).to(torch.bfloat16).float()
    qkv = (n1 @ w_qkv).to(torch.bfloat16)
    q, k, v = qkv.float()[..., :C], qkv.float()[..., C:2 * C], qkv.float()[..., 2 * C:]
    den = torch.empty(R, H, N)
    for h in range(H):
        grp = slice(16 * (h * D // 16), 16 * (h * D // 16) + 16)
        lanes = torch.zeros(C)
        lanes[h * D:(h + 1) * D] = 1.0
        s = (q * lanes)[..., grp] @ k[..., grp].transpose(-1, -2)
        prob = torch.exp2(s.clamp(max=fused_block.SCORE_CLAMP)).to(torch.bfloat16).float()
        vo = torch.cat([v[..., h * D:(h + 1) * D], torch.ones(R, N, 1)], dim=-1)
        den[:, h] = (prob @ vo)[..., D]
    got = fused_row_block_train_reference(x, tp, H, qkv=qkv.reshape(R * N, 3 * C))[3]
    torch.testing.assert_close(den, got, rtol=1e-6, atol=0.0)
    np.testing.assert_allclose(got.numpy(), jax_den, rtol=2e-5)


def _grads(fn, rows, p, g):
    x = rows.clone().requires_grad_()
    pr = RowBlockParams(*(t.clone().requires_grad_() for t in p))
    fn(x, pr).backward(g)
    return [x.grad] + [t.grad for t in pr]


def test_function_matches_autograd_through_plain_route():
    """fused_row_block under autograd (B1-train + B2 plain versions on the
    CPU) against autograd through attention_impl="xla"."""
    rows, p, g = _inputs(3, 24, 32, seed=5)
    rt, tp, gt = _t(rows), _tp(p), _t(g)
    got = _grads(lambda x, q: row_transformer_block(x, q, H, attention_impl="pallas"),
                 rt, tp, gt)
    ref = _grads(lambda x, q: row_transformer_block(x, q, H, attention_impl="xla"),
                 rt, tp, gt)
    for a, b in zip(got, ref):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * scale


def test_plain_route_chunked_backward_is_value_neutral(monkeypatch):
    """The plain route's row chunks, recomputed in the backward
    (torch.utils.checkpoint), give the unchunked gradients: per-row
    values bit for bit, parameter gradients summed chunk by chunk to f32
    rounding (1e-6 of each leaf's largest magnitude)."""
    rows, p, g = _inputs(5, 24, 32, seed=9)
    rt, tp, gt = _t(rows), _tp(p), _t(g)

    def block(x, q):
        return row_transformer_block(x, q, H, attention_impl="xla")

    whole = _grads(block, rt, tp, gt)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", H * 24 * 24 * 4 * 2)
    chunked = _grads(block, rt, tp, gt)
    for a, b in zip(whole, chunked):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()


def test_backward_goes_through_b2_and_forward_through_b1_train(monkeypatch):
    """Under autograd the wrapper runs B1-train and its backward B2 (on the
    CPU their plain versions); without a gradient it runs the serving form."""
    calls = []
    train, bwd = fused_block.fused_row_block_train, fused_block.fused_row_block_bwd
    monkeypatch.setattr(fused_block, "fused_row_block_train",
                        lambda *a: calls.append("train") or train(*a))
    monkeypatch.setattr(fused_block, "fused_row_block_bwd",
                        lambda *a: calls.append("bwd") or bwd(*a))
    rows, p, g = _inputs(2, 16, 32, seed=7)
    x = _t(rows).requires_grad_()
    out = fused_row_block(x, _tp(p), H)
    assert calls == ["train"]
    out.backward(_t(g))
    assert calls == ["train", "bwd"] and x.grad is not None
    with torch.no_grad():
        fused_row_block(_t(rows), _tp(p), H)
    assert calls == ["train", "bwd"]


def test_train_and_bwd_wrappers_count_no_launch_on_cpu():
    rows, p, g = _inputs(2, 16, 32, seed=1)
    before = (fused_row_block_train.launches, fused_row_block_bwd.launches)
    out, mid, acc, den = fused_row_block_train(_t(rows), _tp(p), H)
    fused_row_block_bwd(_t(rows), mid, acc, den, _t(g), _tp(p), H)
    assert (fused_row_block_train.launches, fused_row_block_bwd.launches) == before


@pytest.mark.parametrize("wrapper", ["train", "bwd"])
def test_training_wrappers_raise_on_wrong_dtype_for_cuda(wrapper):
    """A CUDA tensor the kernels do not take raises before any launch (a
    stand-in object, since this machine has no card)."""

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float32

    with pytest.raises(TypeError, match="bfloat16"):
        if wrapper == "train":
            fused_row_block_train(FakeCuda(), None, H)
        else:
            fused_row_block_bwd(FakeCuda(), None, None, None, None, None, H)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_take_the_given_qkv(dtype, monkeypatch):
    """A given q|k|v (what the check on the card passes: the kernel's own)
    replaces the recomputed one, chunk by chunk: the recomputed q|k|v
    gives the same results bit for bit, and another q|k|v other ones."""
    rows, p, g = _inputs(3, 24, 32, seed=11)
    rt, tp, gt = _t(rows, dtype), _tp(p), _t(g, dtype)
    w = fused_block._block_weights(tp, 32, H, dtype)
    n1 = fused_block.layer_norm_f32(rt.float(), w[0].float(), w[1].float()).to(dtype)
    qkv = (n1.float() @ w[2].float()).to(dtype).reshape(-1, 96)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", H * 24 * 24 * 4 * 4 * 2)
    fwd = fused_row_block_train_reference(rt, tp, H)
    bwd = fused_row_block_bwd_reference(rt, *fwd[1:], gt, tp, H)
    fwd_q = fused_row_block_train_reference(rt, tp, H, qkv=qkv)
    bwd_q = fused_row_block_bwd_reference(rt, *fwd[1:], gt, tp, H, qkv=qkv)
    for a, b in zip([*fwd, bwd[0], *bwd[1]], [*fwd_q, bwd_q[0], *bwd_q[1]]):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)
    other = fused_row_block_train_reference(rt, tp, H, qkv=qkv * 2)
    assert not torch.equal(other[2], fwd[2])


def test_bwd_reference_chunking_is_value_neutral(monkeypatch):
    rows, p, g = _inputs(5, 24, 32, seed=3)
    rt, tp, gt = _t(rows), _tp(p), _t(g)
    _, mid, acc, den = fused_row_block_train_reference(rt, tp, H)
    whole = fused_row_block_bwd_reference(rt, mid, acc, den, gt, tp, H)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 4 * H * 24 * 24 * 4 * 2)
    chunked = fused_row_block_bwd_reference(rt, mid, acc, den, gt, tp, H)
    # dx is per row; a parameter gradient is summed chunk by chunk, in
    # another order: f32 rounding, 1e-6 of the leaf's largest magnitude
    torch.testing.assert_close(whole[0], chunked[0], atol=0.0, rtol=0.0)
    for a, b in zip(whole[1], chunked[1]):
        assert (a - b).abs().max() <= 1e-6 * a.abs().max()
