"""The port's fused row block against the JAX package's Pallas kernel.

``fused_row_block_reference`` (the plain PyTorch version of the CUDA
kernel, and what the wrapper runs on a CPU tensor) must compute what the
TPU kernel computes.  The JAX kernel runs in interpret mode, as the JAX
package's own tests run it on the CPU.

Tolerance (f32): both sides compute the same arithmetic in f32 with sums in
a different order (per-head matmuls vs the TPU's lane-masked contraction,
division vs reciprocal); at O(1-10) activations that is a few f32 ULP, so
atol = rtol = 2e-5, the JAX package's own kernel-vs-XLA tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas.fused_block import fused_row_block as jax_fused_row_block
from tfswa_tpu_torch.models.attention import RowBlockParams, row_transformer_block
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops.fused_block import (SCORE_CLAMP, fused_row_block,
                                             fused_row_block_parts,
                                             fused_row_block_reference)


def _np_params(rng, C, scale=0.05):
    hid = 4 * C

    def r(*s, sc=scale):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    return dict(
        norm1_scale=1.0 + r(C, sc=0.1), norm1_bias=r(C, sc=0.1),
        qkv_kernel=r(C, 3 * C), proj_kernel=r(C, C), proj_bias=r(C, sc=0.01),
        norm2_scale=1.0 + r(C, sc=0.1), norm2_bias=r(C, sc=0.1),
        fc1_kernel=r(C, hid), fc1_bias=r(hid, sc=0.01),
        fc2_kernel=r(hid, C), fc2_bias=r(C, sc=0.01),
    )


def _both(R, N, C, seed, qkv_scale=0.05):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((R, N, C)).astype(np.float32)
    p = _np_params(rng, C)
    p["qkv_kernel"] = (p["qkv_kernel"] / 0.05 * qkv_scale).astype(np.float32)
    return rows, p


def _jax(rows, p, H):
    jp = JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_fused_row_block(jnp.asarray(rows), jp, H))


def _torch_params(p):
    return RowBlockParams(**{k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("N,C", [(37, 32), (64, 32), (127, 32), (37, 64), (64, 64),
                                 (127, 64)])
def test_reference_matches_pallas_kernel_f32(N, C):
    rows, p = _both(3, N, C, seed=N * 7 + C)
    ref = _jax(rows, p, 8)
    out = fused_row_block_reference(torch.from_numpy(rows), _torch_params(p), 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_reference_matches_pallas_kernel_saturated_scores():
    """Scores far above SCORE_CLAMP (log2 units): both sides saturate the
    same way and stay finite."""
    N, C, H = 37, 32, 8
    rows, p = _both(2, N, C, seed=11, qkv_scale=2.0)
    # the case is only meaningful if some scores really pass the clamp
    x = (rows - rows.mean(-1, keepdims=True)) / rows.std(-1, keepdims=True)
    x = x * p["norm1_scale"] + p["norm1_bias"]
    D = C // H
    q = (x @ p["qkv_kernel"][:, :C]).reshape(2, N, H, D) * D ** -0.5 * 1.4426950408889634
    k = (x @ p["qkv_kernel"][:, C:2 * C]).reshape(2, N, H, D)
    assert np.einsum("rnhd,rmhd->rhnm", q, k).max() > 2 * SCORE_CLAMP
    ref = _jax(rows, p, H)
    out = fused_row_block_reference(torch.from_numpy(rows), _torch_params(p), H)
    assert np.isfinite(ref).all() and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=2e-5)


def test_reference_matches_pallas_kernel_bf16():
    """bf16 rows: the plain version's bf16 rounding points (LN1 output, q/k/v,
    p, the attention output, the GELU output) are the TPU kernel's.  An f32
    sum in another order now and then flips one bf16 rounding, so the bound
    is 2 bf16 ULP at the output's magnitude, elementwise."""
    rows, p = _both(3, 64, 32, seed=17, qkv_scale=0.25)
    rows_bf = rows.astype(jnp.bfloat16)
    ref = _jax(rows_bf, p, 8).astype(np.float32)
    out = fused_row_block_reference(
        torch.from_numpy(np.asarray(rows_bf, np.float32)).to(torch.bfloat16),
        _torch_params(p), 8).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -20))) - 7)
    assert np.all(np.abs(out - ref) <= 2 * ulp)


def test_reference_chunking_is_value_neutral(monkeypatch):
    rows, p = _both(5, 24, 32, seed=3)
    rt, tp = torch.from_numpy(rows), _torch_params(p)
    whole = fused_row_block_reference(rt, tp, 8)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 8 * 24 * 24 * 4 * 2)
    chunked = fused_row_block_reference(rt, tp, 8)
    torch.testing.assert_close(chunked, whole, atol=0.0, rtol=0.0)


def test_parts_attention_is_the_blocks_own():
    """fused_row_block_parts' attention output, put through the
    out-projection and the MLP, gives the block's output."""
    rows, p = _both(2, 24, 32, seed=9)
    rt, tp = torch.from_numpy(rows), _torch_params(p)
    out, attn = fused_row_block_parts(rt, tp, 8)
    y = rt + attn @ tp.proj_kernel + tp.proj_bias
    h = torch.nn.functional.layer_norm(y, (32,), tp.norm2_scale, tp.norm2_bias, 1e-5)
    h = torch.nn.functional.gelu(h @ tp.fc1_kernel + tp.fc1_bias)
    torch.testing.assert_close(out, y + h @ tp.fc2_kernel + tp.fc2_bias,
                               atol=2e-5, rtol=2e-5)


def test_routes_agree_on_cpu(monkeypatch):
    """row_transformer_block: the kernel route (plain version on the CPU) and
    the plain route (standard softmax, here chunked one row at a time) give
    the same values."""
    rows, p = _both(4, 40, 32, seed=5)
    rt, tp = torch.from_numpy(rows), _torch_params(p)
    a = row_transformer_block(rt, tp, 8, attention_impl="pallas")
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 40 * 40 * 8 * 4)
    b = row_transformer_block(rt, tp, 8, attention_impl="xla")
    torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_wrapper_counts_no_launch_on_cpu():
    rows, p = _both(2, 16, 32, seed=1)
    before = fused_row_block.launches
    fused_row_block(torch.from_numpy(rows), _torch_params(p), 8)
    assert fused_row_block.launches == before


def test_wrapper_raises_off_cpu_and_cuda():
    rows, p = _both(2, 16, 32, seed=1)
    with pytest.raises(ValueError, match="no kernel"):
        fused_row_block(torch.from_numpy(rows).to("meta"), _torch_params(p), 8)


def test_wrapper_raises_on_wrong_dtype_for_cuda():
    """A CUDA tensor of another dtype than bf16 raises before any launch.
    The check runs on a stand-in object, since this machine has no card."""
    _, p = _both(2, 16, 32, seed=1)

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float32
        requires_grad = False

    with pytest.raises(TypeError, match="bfloat16"):
        fused_row_block(FakeCuda(), _torch_params(p), 8)
