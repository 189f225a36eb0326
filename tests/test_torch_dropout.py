"""Dropout in the port (the reference's three sites: the attention weights,
after the GELU, after fc2) against the JAX package, on the CPU.

The two packages draw different random bits from the same seed, so the
train-mode masks are held to their distribution and to the port's own
determinism; eval mode, where dropout is a no-op, is held to JAX.
Tolerances: eval mode against JAX as the whole-model tests (atol 1e-5,
f32); dropout's keep fraction within 3 sigma of 1 - p; the standalone
attention against JAX at 1e-5 (f32, N = 8); remat against no remat equal
bit for bit (the recompute runs the same f32 ops on the same masks).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models.attention import MultiHeadAttention as JaxMHA
from tfswa_tpu.models.attention import scaled_dot_product_attention as jax_sdpa
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig, TrainConfig
from tfswa_tpu_torch.models import TFSWAUNet, row_transformer_block
from tfswa_tpu_torch.models import attention as port_attention
from tfswa_tpu_torch.models.attention import (MultiHeadAttention, RowBlockParams,
                                              scaled_dot_product_attention)
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops import row_attention
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts

from _torch_small_model import SMALL, jax_forward, perturbed_model

RATE = 0.1


@pytest.fixture(autouse=True)
def _two_threads():
    """Six test workers share the machine's cores: two intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(shape=(1, 4, 33, 13), seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_eval_with_dropout_matches_jax_and_dropout_zero():
    """Eval mode: dropout is a no-op in both packages; the port equals JAX
    and, bit for bit, the same weights at dropout 0 (also on the kernel
    route, whose plain version runs here)."""
    pm = perturbed_model(seed=1, qkv_gain=1.0, dropout=RATE)
    x = _x()
    ref = jax_forward(pm, x, dropout=RATE)
    for impl in ("xla", "pallas"):
        a = pm.clone(impl)
        b = TFSWAUNet(4, 4, attention_impl=impl, **SMALL)
        b.load_state_dict(a.state_dict())
        with torch.no_grad():
            out = a(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
            assert torch.equal(out, b(torch.from_numpy(x)))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_dropout_keeps_one_minus_p_and_scales_the_kept():
    x = torch.full((200_000,), 3.0, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    y = row_attention.dropout(x, RATE, gen)
    kept = y != 0
    n = x.numel()
    frac = kept.float().mean().item()
    assert abs(frac - (1 - RATE)) < 3 * np.sqrt(RATE * (1 - RATE) / n)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y[kept], (x / (1 - RATE))[kept])
    assert torch.equal(y, row_attention.dropout(x, RATE, torch.Generator().manual_seed(0)))
    assert not torch.equal(y, row_attention.dropout(x, RATE, torch.Generator().manual_seed(1)))


def _params(C=16, hidden=64, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(C,), (C,), (C, 3 * C), (C, C), (C,), (C,), (C,), (C, hidden), (hidden,),
              (hidden, C), (C,)]
    return RowBlockParams(*(torch.from_numpy((rng.standard_normal(s) * 0.3)
                                             .astype(np.float32)) for s in shapes))


def test_all_three_sites_draw_and_the_seed_fixes_them(monkeypatch):
    """Every chunk draws at the weights (R, H, N, N), after the GELU
    (R, N, hidden) and after fc2 (R, N, C), in that order; the same seed
    gives the same output, another seed another."""
    p = _params()
    rows = torch.from_numpy(_x((6, 8, 16)))
    sites = []
    real = row_attention.dropout

    def spy(x, rate, gen):
        sites.append(tuple(x.shape))
        return real(x, rate, gen)

    monkeypatch.setattr(row_attention, "dropout", spy)
    monkeypatch.setattr(port_attention, "dropout", spy)
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 2 * 4 * 8 * 8 * 4)   # 2 rows a chunk
    with torch.no_grad():
        a = row_transformer_block(rows, p, 4, dropout_rate=RATE, dropout_seed=7)
        assert sites == [(2, 4, 8, 8), (2, 8, 64), (2, 8, 16)] * 3
        b = row_transformer_block(rows, p, 4, dropout_rate=RATE, dropout_seed=7)
        c = row_transformer_block(rows, p, 4, dropout_rate=RATE, dropout_seed=8)
        d = row_transformer_block(rows, p, 4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def _raise(*a, **k):
    raise AssertionError("a kernel wrapper was reached")


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8", "pallas_attn"])
def test_dropout_and_the_mask_never_reach_a_kernel(monkeypatch, impl):
    """With every kernel wrapper raising, a train-mode forward with dropout
    through a kernel route runs (every row block on the plain route), and so
    does a masked row block; eval mode without a mask reaches the kernel."""
    for name in ("fused_row_block", "fused_row_block_int8", "flash_row_attention"):
        monkeypatch.setattr(port_attention, name, _raise)
    pm = TFSWAUNet(4, 4, attention_impl=impl, dropout=RATE, use_shift_mask=True,
                   generator=torch.Generator().manual_seed(0), **SMALL).train()
    out = pm(torch.from_numpy(_x()), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    from tfswa_tpu_torch.ops.windowing import swin_mask_table

    table, idx = swin_mask_table(8, 8, 4, 2)
    rows = torch.from_numpy(_x((idx.size, 16, 16)))
    with torch.no_grad():
        row_transformer_block(rows, _params(), 4, attention_impl=impl,
                              mask=(torch.from_numpy(table)[:, None],
                                    torch.from_numpy(idx).long()))
        with pytest.raises(AssertionError, match="kernel wrapper"):
            pm.eval()(torch.from_numpy(_x()))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_with_dropout_gives_the_no_remat_gradient(monkeypatch, impl):
    """Remat recomputes each block (and, above one chunk, each chunk of
    rows) in the backward: the masks come from seeds fixed outside the
    recompute, so the gradient equals the no-remat one bit for bit."""
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 4 * 4 * 33 * 33 * 4)   # chunks
    x = torch.from_numpy(_x())
    grads = {}
    for remat in (False, True):
        pm = TFSWAUNet(4, 4, attention_impl=impl, dropout=RATE, remat=remat,
                       generator=torch.Generator().manual_seed(0), **SMALL).train()
        out = pm(x, generator=torch.Generator().manual_seed(5))
        out.square().sum().backward()
        grads[remat] = torch.cat([p.grad.flatten() for p in pm.parameters()])
    assert torch.equal(grads[True], grads[False])


def test_train_step_dropout_is_fixed_by_seed_and_step():
    """make_train_step draws the dropout from (rng_seed, step): the same
    pair gives the same loss; another step another."""
    proc = STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=8000))
    mix = torch.from_numpy(_x((2, 2, 2000)) * 0.3)
    targets = {k: mix * 0.5 for k in ("vocals", "other")}
    cfg = Config(model=ModelConfig(dropout=RATE, **SMALL), train=TrainConfig(seed=0))

    def loss(step):
        model, state = pts.create_train_state(cfg, device="cpu")
        state.step = step
        fn = pts.make_train_step(model, proc, cfg.data.stems, rng_seed=3)
        return float(fn(state, mix, targets)[1]["total_loss"])

    assert loss(4) == loss(4)
    assert loss(4) != loss(5)
    assert pts.dropout_generator(3, 4).initial_seed() == pts.dropout_generator(3, 4).initial_seed()


def _mha_pair(dim=16, heads=4):
    jm = JaxMHA(dim=dim, num_heads=heads)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, dim)))["params"])
    rng = np.random.default_rng(0)
    params = {k: (v + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()}
    pm = MultiHeadAttention(dim, heads)
    pm.load_state_dict({"qkv.weight": torch.from_numpy(params["qkv_kernel"].T.copy()),
                        "proj.weight": torch.from_numpy(params["proj_kernel"].T.copy()),
                        "proj.bias": torch.from_numpy(params["proj_bias"])})
    return jm, params, pm


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(masked):
    jm, params, pm = _mha_pair()
    x = _x((3, 8, 16), seed=4)
    mask = None
    if masked:
        mask = np.random.default_rng(6).random((3, 1, 8, 8)) > 0.3
        mask[..., 0] = True                    # every query keeps a key
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                              mask=None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        out = pm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        pm.dropout = RATE                      # eval mode: no dropout
        assert torch.equal(out, pm(torch.from_numpy(x), None if mask is None
                                   else torch.from_numpy(mask),
                                   generator=torch.Generator().manual_seed(0)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    pm.train()
    assert not torch.equal(out, pm(torch.from_numpy(x), generator=torch.Generator()))


@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
def test_scaled_dot_product_attention_matches_jax(mask_kind):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 3, 8, 4)).astype(np.float32) for _ in range(3))
    mask = None
    if mask_kind == "bool":
        mask = rng.random((2, 1, 8, 8)) > 0.4
        mask[..., 0] = True
    elif mask_kind == "additive":
        mask = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
    ref_o, ref_w = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            None if mask is None else jnp.asarray(mask))
    o, w = scaled_dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v),
                                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6, rtol=0)
