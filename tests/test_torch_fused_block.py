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


def _np_params(rng, C, scale=0.05, hid=None):
    hid = 4 * C if hid is None else hid

    def r(*s, sc=scale):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    return dict(
        norm1_scale=1.0 + r(C, sc=0.1), norm1_bias=r(C, sc=0.1),
        qkv_kernel=r(C, 3 * C), proj_kernel=r(C, C), proj_bias=r(C, sc=0.01),
        norm2_scale=1.0 + r(C, sc=0.1), norm2_bias=r(C, sc=0.1),
        fc1_kernel=r(C, hid), fc1_bias=r(hid, sc=0.01),
        fc2_kernel=r(hid, C), fc2_bias=r(C, sc=0.01),
    )


def _both(R, N, C, seed, qkv_scale=0.05, hid=None):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((R, N, C)).astype(np.float32)
    p = _np_params(rng, C, hid=hid)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_kernel_at_an_mlp_width_off_the_kernels_chunks(dtype):
    """An MLP of 96 units at C = 32, a multiple of 8 but not of the CUDA
    kernels' hidden chunks (64 and 128 units: a ragged last chunk on the
    card): the plain version still computes the TPU kernel's function.
    Tolerances as the f32 and bf16 tests above."""
    rows, p = _both(3, 37, 32, seed=96, qkv_scale=0.25, hid=96)
    if dtype == "float32":
        ref = _jax(rows, p, 8)
        out = fused_row_block_reference(torch.from_numpy(rows), _torch_params(p), 8)
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
        return
    rows_bf = rows.astype(jnp.bfloat16)
    ref = _jax(rows_bf, p, 8).astype(np.float32)
    out = fused_row_block_reference(
        torch.from_numpy(np.asarray(rows_bf, np.float32)).to(torch.bfloat16),
        _torch_params(p), 8).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -20))) - 7)
    assert np.all(np.abs(out - ref) <= 2 * ulp)


def test_padded_keys_masked_to_minus_inf_add_exactly_zero():
    """The attention kernel pads a row's keys to whole 16-key chunks with
    zero k and v.  Unmasked, a zero key has s = 0 and p = bf16(exp2(0)) = 1,
    and adds 1 to the denominator (the planted fault "padded keys adding
    exp2(0)"); masked to -inf before the exp2 it has p = 0, so with the
    sums taken key by key in order (as the kernel's mma chain takes them)
    the padded row's acc and denominator are bit for bit the unpadded
    row's."""
    rng = np.random.default_rng(7)
    N, Np, D = 37, 48, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
               .to(torch.bfloat16).float() for _ in range(3))
    pad = torch.zeros(Np - N, D)
    kp, vp = torch.cat([k, pad]), torch.cat([v, pad])

    def line(s):
        return torch.exp2(s.clamp(max=SCORE_CLAMP)).to(torch.bfloat16).float()

    def sums(p, v):                     # [sum_k p v | sum_k p * 1], key by key
        terms = p[:, :, None] * torch.cat([v, torch.ones(v.shape[0], 1)], 1)[None]
        return torch.cumsum(terms, dim=1)[:, -1]

    s = q @ k.t()
    s_pad = q @ kp.t()
    assert torch.equal(s_pad[:, N:], torch.zeros(N, Np - N))
    unmasked = sums(line(s_pad), vp)
    masked = sums(line(torch.where(torch.arange(Np) < N, s_pad, float("-inf"))), vp)
    plain = sums(line(s), v)
    assert torch.equal(masked, plain)
    assert torch.equal(unmasked[:, D] - plain[:, D], torch.full((N,), float(Np - N)))


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
    """A CUDA tensor of another dtype than bf16 or f32 raises before any
    launch.  The check runs on a stand-in object: the CPU tests have no
    card."""
    _, p = _both(2, 16, 32, seed=1)

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float16
        requires_grad = False

    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fused_row_block(FakeCuda(), _torch_params(p), 8)


# The row-block shapes (R, N, C) of the flagship config (dims 32-256, 8
# heads, MLP ratio 4) on the serving path (F = 1024 after the crop, T = 862,
# batches of 8) and the training path (F = 1025, T = 517, batches of 4):
# at stage s, F and T halve s times; TSA has rows of N = F_s, FSA of N = T_s,
# SWA windows of 64 tokens.
FLAGSHIP_PATHS = {"serving": (1024, 862, 8), "training": (1025, 517, 4)}


def flagship_row_shapes(path, stage):
    F, T, B = FLAGSHIP_PATHS[path]
    f, t, C = F >> stage, T >> stage, 32 << stage
    return [(B * t, f, C), (B * f, t, C), (B * -(-f // 8) * -(-t // 8), 64, C)]


class FakeCuda:
    """A stand-in for a CUDA tensor (this machine has no card): what the
    wrappers read before they launch."""

    device = torch.device("cuda", 0)
    requires_grad = False

    def __init__(self, shape, dtype=torch.bfloat16):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


@pytest.mark.parametrize("path", sorted(FLAGSHIP_PATHS))
@pytest.mark.parametrize("stage", range(4))
def test_kernel_admits_the_flagship_row_shapes(path, stage):
    """Every (N, C) of the flagship's serving and training paths is within
    what the kernels take, shared memory included (which depends on C only)."""
    for R, N, C in flagship_row_shapes(path, stage):
        fused_block.check_shape("fused_row_block", R, N, C, 8, 4 * C)
        assert fused_block.kernel_smem_bytes(C) <= fused_block.MAX_SMEM_BYTES


def _wrappers(C, H):
    """Each kernel wrapper of ops/fused_block.py and ops/lab_block.py, called
    on a FakeCuda of width C with H heads and its parameters."""
    from tfswa_tpu_torch.ops.lab_block import lab_row_block

    rng = np.random.default_rng(0)
    p = _torch_params(_np_params(rng, C))
    rows = lambda dt: FakeCuda((2, 16, C), dt)  # noqa: E731
    like = torch.zeros(2, 16, C)
    return {
        "B1": lambda dt: fused_row_block(rows(dt), p, H),
        "B1-train": lambda dt: fused_block.fused_row_block_train(rows(dt), p, H),
        "B2": lambda dt: fused_block.fused_row_block_bwd(rows(dt), like, like,
                                                         torch.zeros(2, H, 16), like, p, H),
        "B3": lambda dt: fused_block.fused_row_block_int8(rows(dt), p, H),
        "L": lambda dt: lab_row_block(rows(dt), p, H, "attn"),
    }


@pytest.mark.parametrize("C,H", [(44, 4), (520, 8), (48, 5), (64, 3)])
@pytest.mark.parametrize("kernel", ["B1", "B1-train", "B2", "B3", "L"])
def test_wrappers_raise_on_a_width_or_head_count_the_kernels_do_not_take(kernel, C, H):
    """C not a multiple of 8 (44), C past 512 (520), or a head count that
    does not divide C (48 / 5, 64 / 3) raises before any launch, with no
    fallback to the plain version."""
    with pytest.raises(ValueError, match="no kernel"):
        _wrappers(C, H)[kernel](torch.bfloat16)


@pytest.mark.parametrize("kernel", ["B1", "B1-train", "B2", "B3", "L"])
def test_wrappers_raise_on_a_dtype_the_kernels_do_not_take(kernel, monkeypatch):
    """float16 has no kernel; the lab (L) takes f32 too since it has f32
    forms: f32 rows, with their parameters on the card, pass the wrapper's
    own _check_cuda (called with the dtypes the wrapper gives it)."""
    from tfswa_tpu_torch.ops import lab_block

    with pytest.raises(TypeError, match="bfloat16"):
        _wrappers(32, 8)[kernel](torch.float16)
    if kernel == "L":
        class Accepted(Exception):
            pass

        def check(name, rows, num_heads, p, **kw):
            on_card = type(p)(*(FakeCuda(w.shape, w.dtype) for w in p))
            fused_block._check_cuda(name, rows, num_heads, on_card, **kw)
            raise Accepted

        monkeypatch.setattr(lab_block, "_check_cuda", check)
        with pytest.raises(Accepted):
            _wrappers(32, 8)[kernel](torch.float32)


def test_kernel_refuses_an_mlp_width_off_its_chunks():
    """The kernels take any MLP width whose bf16 rows are whole 16-byte
    cp.async copies (a multiple of 8 units): their hidden chunks may end
    ragged, so 96 is admitted; 100 is refused."""
    fused_block.check_shape("fused_row_block", 2, 16, 32, 8, 96)
    assert fused_block.kernel_smem_bytes(32, 96) <= fused_block.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="MLP of 100 units"):
        fused_block.check_shape("fused_row_block", 2, 16, 32, 8, 100)
