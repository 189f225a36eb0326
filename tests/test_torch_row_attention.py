"""The port's B4, the bilinear row attention (``attention_impl="pallas_attn"``),
against the JAX package, on the CPU.

``flash_row_attention_reference`` (the plain version of the CUDA kernel,
and what ``flash_row_attention`` runs on a CPU tensor) against the JAX
package's ``flash_row_attention`` in interpret mode, as
``tests/test_pallas.py`` runs it; the gradients of the port's
``"pallas_attn"`` row block (``_BilinearBlock``, which holds B4's only VJP)
against ``jax.grad`` through the JAX package's ``"pallas_attn"`` row block;
that block against the plain route under autograd; one whole-model forward
through both packages' ``"pallas_attn"`` routes.

Tolerances:
  - f32: the same arithmetic with sums in another order (scores over C
    lanes of t, the einsum that makes A), at O(1) activations: atol = rtol
    = 2e-5, the JAX package's own kernel-vs-XLA tolerance.
  - bf16: both sides round A, Wv, v, t, p and acc at the same points; an
    f32 sum in another order now and then flips one bf16 rounding: 2 bf16
    ULP at the output's largest magnitude.
  - gradients: both sides differentiate the plain attention, chunked,
    and the same LN and MLP around it (the JAX test's 1e-4).
  - whole model, f32: nine row blocks of the above through sigmoid masks,
    atol 1e-5 (test_torch_modules.py's whole-model tolerance).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_fused_block import _both, _torch_params
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.models.attention import row_transformer_block as jax_row_block
from tfswa_tpu.ops.pallas.row_attention import _bilinear_weights as jax_bilinear_weights
from tfswa_tpu.ops.pallas.row_attention import flash_row_attention as jax_flash
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.models.attention import row_transformer_block
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops.row_attention import (bilinear_weights, flash_row_attention,
                                               flash_row_attention_reference,
                                               flash_row_attention_reference_parts)
from tfswa_tpu_torch.weights import variables_from_state_dict


def _weights(C, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((C, 3 * C)) * scale).astype(np.float32),
            (rng.standard_normal((C, C)) * 0.05).astype(np.float32),
            (rng.standard_normal(C) * 0.01).astype(np.float32))


def _rows(R, N, C, seed):
    return np.random.default_rng(seed).standard_normal((R, N, C)).astype(np.float32)


def _jax_flash(rows, w, H):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_flash(jnp.asarray(rows), *(jnp.asarray(a) for a in w), H))


# tests/test_pallas.py's shapes: SWA-like windows, odd N and R, wider channels
@pytest.mark.parametrize("R,N,C,H", [(4, 64, 32, 8), (3, 127, 32, 4), (2, 96, 64, 8)])
def test_reference_matches_pallas_kernel_f32(R, N, C, H):
    rows, w = _rows(R, N, C, seed=N + C), _weights(C, seed=C)
    ref = _jax_flash(rows, w, H)
    out = flash_row_attention_reference(torch.from_numpy(rows),
                                        *(torch.from_numpy(a) for a in w), H)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_reference_matches_pallas_kernel_bf16():
    """bf16 rows and weights cast to bf16 first, as the ``pallas_attn`` route
    passes them; scores of std ~2 so that the softmax is peaked."""
    H = 8
    rows = _rows(3, 64, 32, seed=7).astype(jnp.bfloat16)
    w = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16)) for a in _weights(32, 8, scale=0.25)]
    ref = _jax_flash(rows, w, H).astype(np.float32)
    out = flash_row_attention_reference(
        *(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16) for a in (rows, *w)),
        H).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert np.abs(out - ref).max() <= 2 * ulp


def test_bilinear_weights_match_jax():
    w = _weights(32, seed=3)[0]
    a, wv = bilinear_weights(torch.from_numpy(w), 4)
    ja, jwv = jax_bilinear_weights(jnp.asarray(w), 4)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-7, rtol=1e-6)
    np.testing.assert_array_equal(wv.numpy(), np.asarray(jwv))


def _block_grads(rows, p, H, g=None):
    """Output and gradients (rows, then each parameter) of the port's
    ``"pallas_attn"`` row block at cotangent ``g`` (default: of sum(out^2))."""
    x = torch.from_numpy(rows).requires_grad_()
    tp = type(_torch_params(p))(*(t.requires_grad_() for t in _torch_params(p)))
    out = row_transformer_block(x, tp, H, attention_impl="pallas_attn")
    if g is None:
        out.square().sum().backward()
    else:
        out.backward(g)
    return out.detach(), [x.grad, *(t.grad for t in tp)]


def test_gradients_match_jax():
    """jax.grad through the JAX package's ``"pallas_attn"`` row block (its
    flash_row_attention's VJP re-runs the plain attention) against the
    port's, whose ``_BilinearBlock`` takes the plain attention's VJP a
    chunk of rows at a time."""
    R, N, C, H = 3, 32, 16, 4
    rows, p = _both(R, N, C, seed=2, qkv_scale=0.25)

    def loss(r, jp):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(jax_row_block(r, jp, H, attention_impl="pallas_attn") ** 2)

    jp = JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})
    d_rows, d_p = jax.grad(loss, argnums=(0, 1))(jnp.asarray(rows), jp)
    _, got = _block_grads(rows, p, H)
    for a, r in zip(got, [d_rows, *d_p]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_backward_chunking_is_value_neutral(monkeypatch):
    R, N, C, H = 5, 24, 32, 8
    rows, p = _both(R, N, C, seed=4, qkv_scale=0.25)
    g = torch.from_numpy(_rows(R, N, C, seed=6))
    _, whole = _block_grads(rows, p, H, g)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", H * N * N * 4 * 2)
    for a, b in zip(_block_grads(rows, p, H, g)[1], whole):
        torch.testing.assert_close(a, b, atol=1e-6 * b.abs().max().item(), rtol=0)


def test_given_t_and_v_reproduce_the_reference():
    """The plain version's ``t=`` and ``v=`` (what a check on the card passes:
    the kernel's own) give the recomputed result when fed the recomputed
    values."""
    R, N, C, H = 2, 24, 32, 4
    rows, (wqkv, wp, b) = torch.from_numpy(_rows(R, N, C, seed=8)), \
        (torch.from_numpy(a) for a in _weights(C, seed=9))
    a, wv = bilinear_weights(wqkv, H)
    t = torch.stack([rows @ a[h] for h in range(H)], dim=2).reshape(R * N, H * C)
    v = (rows @ wv).reshape(R * N, C)
    whole = flash_row_attention_reference_parts(rows, wqkv, wp, b, H)
    given = flash_row_attention_reference_parts(rows, wqkv, wp, b, H, t=t, v=v)
    for x, y in zip(given, whole):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6)


def test_pallas_attn_block_under_autograd_matches_the_plain_route(monkeypatch):
    """The ``"pallas_attn"`` row block under autograd (``_BilinearBlock``:
    B4 forward, the plain attention's VJP a chunk at a time) against
    autograd through the plain route, in f32: the same values and
    gradients (1e-4 of each leaf's largest magnitude)."""
    rows, p = _both(4, 40, 32, seed=12, qkv_scale=0.25)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 8 * 40 * 40 * 4)

    g = torch.from_numpy(rows[::-1].copy())
    out_a, grads_a = _block_grads(rows, p, 8, g)
    x = torch.from_numpy(rows).requires_grad_()
    tp = type(_torch_params(p))(*(t.requires_grad_() for t in _torch_params(p)))
    out_b = row_transformer_block(x, tp, 8, attention_impl="xla")
    out_b.backward(g)
    out_b, grads_b = out_b.detach(), [x.grad, *(t.grad for t in tp)]
    torch.testing.assert_close(out_a, out_b, atol=2e-5, rtol=2e-5)
    for a, b in zip(grads_a, grads_b):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_wrapper_counts_no_launch_on_cpu_and_raises_elsewhere():
    rows, w = torch.from_numpy(_rows(2, 16, 32, seed=1)), \
        [torch.from_numpy(a) for a in _weights(32, seed=1)]
    before = flash_row_attention.launches
    flash_row_attention(rows, *w, 8)
    assert flash_row_attention.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        flash_row_attention(rows.to("meta"), *w, 8)


@pytest.mark.parametrize("leaf", [0, 1, 2, 3])
def test_wrapper_raises_under_grad(leaf):
    """Forward only: with grad mode on and an input that requires a
    gradient it raises, rather than cut the graph; with grad mode off it
    runs."""
    args = [torch.from_numpy(_rows(2, 16, 32, seed=1)),
            *(torch.from_numpy(a) for a in _weights(32, seed=1))]
    args[leaf].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient of its own"):
        flash_row_attention(*args, 8)
    with torch.no_grad():
        assert flash_row_attention(*args, 8).shape == (2, 16, 32)


SMALL = dict(depths=(1, 0, 0, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
             num_heads=4)


def test_whole_model_pallas_attn_matches_jax():
    """The small model with the same weights through the port's
    ``"pallas_attn"`` route and the JAX package's (whose only gate is
    masks and dropout, both off).  qkv weights x40 so that the attention
    shapes the output; convs x0.4 so that the masks do not saturate."""
    pm = TFSWAUNet(4, 4, attention_impl="pallas_attn",
                   generator=torch.Generator().manual_seed(0), **SMALL)
    with torch.no_grad():
        for name, w in pm.named_parameters():
            if name.endswith("attn.qkv.weight"):
                w.mul_(40.0)
            elif w.dim() == 4:
                w.mul_(0.4)
    variables = variables_from_state_dict(pm.state_dict(), SMALL["depths"])
    x = np.random.default_rng(3).standard_normal((1, 4, 33, 13)).astype(np.float32)
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="pallas_attn", **SMALL)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                  jnp.asarray(x), train=False))
    with torch.inference_mode():
        out = pm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 4, 33, 13)
    assert ((ref > 0.05) & (ref < 0.95)).all() and ref.std() > 0.01   # not saturated
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["pallas_int8", "pallas_attn"])
def test_load_separator_passes_the_route_through(impl, tmp_path):
    """load_separator_from_checkpoint builds its model from the given
    ModelConfig, so the route reaches every row block and separates as a
    model built by hand with the same weights."""
    from tfswa_tpu_torch.config import EvalConfig, ModelConfig, STFTConfig
    from tfswa_tpu_torch.evaluation import SourceSeparator, load_separator_from_checkpoint
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    small = dict(SMALL, dims=(8, 16, 32, 64), num_heads=2)
    pm = TFSWAUNet(4, 4, attention_impl=impl, generator=torch.Generator().manual_seed(1),
                   **small)
    path = tmp_path / "model.pt"
    torch.save({"model_state_dict": pm.state_dict()}, path)
    stft = STFTConfig(n_fft=256, hop_length=64, sample_rate=8000)
    sep = load_separator_from_checkpoint(
        str(path), ModelConfig(in_channels=4, out_channels=4, attention_impl=impl, **small),
        stft, EvalConfig(segment_seconds=1.0), device="cpu")
    impls = {m.attention_impl for m in sep.model.modules() if hasattr(m, "attention_impl")}
    assert impls == {impl}
    audio = np.sin(np.arange(12000) * 0.05).astype(np.float32)
    a = sep.separate(audio)
    b = SourceSeparator(pm, STFTProcessor(stft), segment_length=1.0, device="cpu").separate(audio)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
