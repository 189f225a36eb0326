"""The port's B3, the fused row block with int8 scores
(``attention_impl="pallas_int8"``), against the JAX package, on the CPU.

``fused_row_block_int8_reference`` (the plain version of the CUDA kernel,
and what the wrapper runs on a CPU tensor) against the JAX package's
``fused_row_block_int8`` in interpret mode, as the JAX package's own tests
run it; the quantisation against a numpy replica; the serving-only rule;
one whole-model forward through both packages' ``"pallas_int8"`` routes.

Tolerances:
  - f32, block: q and k come from f32 sums in another order, so a value
    within rounding of a .5 quantisation boundary can land one int8 step
    apart on the two sides, which moves that query's scores by up to
    127 * sq * sk; at these widths that is about 1e-5 of the output, so
    atol = rtol = 1e-4 (B1's 2e-5 holds where nothing flips).
  - bf16, block: both sides round q, k, p and the outputs at the same
    points; a flip of a bf16 rounding or of an int8 step now and then:
    2 bf16 ULP at the output's magnitude, elementwise (B1's bf16 bound).
  - quantisation: exact (the same f32 division and half-to-even rounding).
  - whole model, f32: nine row blocks of the above through sigmoid masks,
    atol 1e-4 (measured 9e-6; the int8 scores move the output by 6e-4
    against the float route, which the test also holds).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from test_torch_fused_block import _both, _torch_params
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas import autotune
from tfswa_tpu.ops.pallas.fused_block import fused_row_block_int8 as jax_int8
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops import fused_block
from tfswa_tpu_torch.ops.fused_block import (fused_row_block_int8,
                                             fused_row_block_int8_reference, quantize_rows)
from tfswa_tpu_torch.weights import variables_from_state_dict

H = 8


def _jax(rows, p):
    jp = JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax_int8(jnp.asarray(rows), jp, H))


@pytest.mark.parametrize("N,C", [(37, 32), (64, 32), (127, 32), (37, 64), (64, 64)])
def test_int8_reference_matches_pallas_kernel_f32(N, C):
    rows, p = _both(3, N, C, seed=N * 7 + C)
    ref = _jax(rows, p)
    out = fused_row_block_int8_reference(torch.from_numpy(rows), _torch_params(p), H)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_int8_reference_matches_pallas_kernel_bf16():
    rows, p = _both(3, 64, 32, seed=19, qkv_scale=0.25)
    rows_bf = rows.astype(jnp.bfloat16)
    ref = _jax(rows_bf, p).astype(np.float32)
    out = fused_row_block_int8_reference(
        torch.from_numpy(np.asarray(rows_bf, np.float32)).to(torch.bfloat16),
        _torch_params(p), H).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -20))) - 7)
    assert np.all(np.abs(out - ref) <= 2 * ulp)


def _numpy_quantize(t):
    """The TPU kernel's quantisation written in numpy: per leading index,
    s = max|t| / 127 in f32, np.round (half to even) of t / s."""
    s = (np.abs(t).reshape(t.shape[0], -1).max(axis=1) / np.float32(127.0)).astype(np.float32)
    s = s.reshape((-1,) + (1,) * (t.ndim - 1))
    return np.round(t / s).astype(np.int8), s


@pytest.mark.parametrize("case", ["random", "halves"])
def test_quantize_rows_matches_numpy(case):
    rng = np.random.default_rng(5)
    t = (rng.standard_normal((3, 4, 9, 8)) * 2.0).astype(np.float32)
    if case == "halves":
        # max|t| = 127 gives s = 1 exactly, so these land on .5 boundaries:
        # half to even sends 2.5 -> 2, 3.5 -> 4, -0.5 -> 0, -1.5 -> -2
        t[:, 0, 0, :5] = [127.0, 2.5, 3.5, -0.5, -1.5]
        t[:, 1:] = np.round(t[:, 1:]) + 0.5
    qi, s = quantize_rows(torch.from_numpy(t))
    ref_q, ref_s = _numpy_quantize(t)
    np.testing.assert_array_equal(s.numpy(), ref_s)
    np.testing.assert_array_equal(qi.numpy(), ref_q.astype(np.float32))
    if case == "halves":
        assert qi[0, 0, 0, :5].tolist() == [127.0, 2.0, 4.0, 0.0, -2.0]


def test_int8_scores_are_the_same_in_any_order():
    """B3's kernel sums each head's int8 products in int32 on the tensor
    cores (m16n8k32, K = 32 channels, the bytes outside the head zeroed, in
    the hardware's order); the plain version sums them in f32 in its own
    order.  Every sum is an integer of magnitude at most 32 * 127^2 < 2^24,
    so f32 holds each partial sum exactly: the scores, and the scores times
    sq * sk, are the same bits in any order."""
    rng = np.random.default_rng(3)
    R, N, C, D = 2, 37, 32, 4
    q, k = (torch.from_numpy(rng.standard_normal((R, N, C)).astype(np.float32))
            .to(torch.bfloat16).float() for _ in range(2))
    (qi, sq), (ki, sk) = quantize_rows(q), quantize_rows(k)
    perm = torch.from_numpy(rng.permutation(C))
    for h in range(C // D):
        lanes = slice(h * D, (h + 1) * D)
        plain = qi[..., lanes] @ ki[..., lanes].transpose(-1, -2)
        exact = (qi[..., lanes].double() @ ki[..., lanes].double().transpose(-1, -2))
        mask = torch.zeros(C)
        mask[lanes] = 1.0
        masked = (qi * mask) @ ki.transpose(-1, -2)              # all 32 channels
        shuffled = (qi * mask)[..., perm] @ ki[..., perm].transpose(-1, -2)
        serial = torch.cumsum((qi * mask)[:, :, None, :] * ki[:, None, :, :], dim=-1)[..., -1]
        assert torch.equal(plain.double(), exact)
        for other in (masked, shuffled, serial):
            assert torch.equal(other, plain)
            assert torch.equal(other * (sq * sk), plain * (sq * sk))


def test_quantize_rows_all_zero_row_gives_zero():
    """An all-zero q row: s = 0.  The TPU kernel computes 0/0 = NaN and casts
    it to int8 0 (on the CPU); the port produces the 0 explicitly."""
    t = np.zeros((2, 3, 4), np.float32)
    t[1] = np.arange(12, dtype=np.float32).reshape(3, 4) - 6.0
    qi, s = quantize_rows(torch.from_numpy(t))
    assert s[0].item() == 0.0 and torch.isfinite(qi).all()
    assert (qi[0] == 0).all()
    assert qi[1].abs().max().item() == 127.0
    with np.errstate(invalid="ignore"):
        assert (np.asarray(jnp.round(jnp.asarray(t[0]) / 0.0).astype(jnp.int8)) == 0).all()


def test_int8_block_with_a_zero_row_matches_pallas_kernel():
    """A row whose LN1 output, and so q and k, is all zero (LN1 scale and
    bias zero for this check) stays finite and equal on both sides."""
    rows, p = _both(2, 16, 32, seed=23)
    p = dict(p, norm1_scale=np.zeros_like(p["norm1_scale"]),
             norm1_bias=np.zeros_like(p["norm1_bias"]))
    ref = _jax(rows, p)
    out = fused_row_block_int8_reference(torch.from_numpy(rows), _torch_params(p), H)
    assert np.isfinite(ref).all() and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_int8_given_qkv_and_chunking_are_value_neutral(monkeypatch):
    """The plain version's ``qkv=`` (what a check on the card passes: the
    kernel's own q|k|v) and its row chunking change no value."""
    rows, p = _both(5, 24, 32, seed=3)
    rt, tp = torch.from_numpy(rows), _torch_params(p)
    whole = fused_row_block_int8_reference(rt, tp, H)
    ln1 = fused_block.layer_norm_f32(rt, tp.norm1_scale, tp.norm1_bias)
    w_qkv = fused_block._block_weights(tp, 32, H, torch.float32)[2]
    given = fused_row_block_int8_reference(rt, tp, H, qkv=(ln1 @ w_qkv).reshape(-1, 96))
    monkeypatch.setattr(fused_block, "MAX_SCORE_BYTES", 8 * 24 * 24 * 4 * 2)
    chunked = fused_row_block_int8_reference(rt, tp, H)
    torch.testing.assert_close(chunked, whole, atol=0.0, rtol=0.0)
    torch.testing.assert_close(given, whole, atol=0.0, rtol=0.0)


def test_int8_under_grad_raises():
    """B3 has no VJP (serving only): under grad the wrapper raises instead
    of returning a result no gradient reaches."""
    rows, p = _both(2, 16, 32, seed=1)
    rt = torch.from_numpy(rows).requires_grad_()
    with pytest.raises(RuntimeError, match="serving only"):
        fused_row_block_int8(rt, _torch_params(p), H)
    with torch.no_grad():
        out = fused_row_block_int8(rt, _torch_params(p), H)
    assert out.shape == rt.shape and not out.requires_grad


def test_int8_wrapper_counts_no_launch_on_cpu_and_raises_elsewhere():
    rows, p = _both(2, 16, 32, seed=1)
    before = fused_row_block_int8.launches
    fused_row_block_int8(torch.from_numpy(rows), _torch_params(p), H)
    assert fused_row_block_int8.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        fused_row_block_int8(torch.from_numpy(rows).to("meta"), _torch_params(p), H)

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float16
        requires_grad = False

    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fused_row_block_int8(FakeCuda(), _torch_params(p), H)


# one block at the first stage and the bottleneck: TSA, FSA and SWA at two
# widths, nine row blocks, and a JAX forward of about 15 s in interpret mode
SMALL = dict(depths=(1, 0, 0, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
             num_heads=4)


def _gate_everything_to_b3(path):
    """An autotune table for the CPU that sends every (N, C) the small model
    can meet to the fused kernel ("attn_route") and to its int8 core
    ("fused_int8"); without it the JAX route's CPU heuristic would send
    128 < N < 300 at C <= 64 to the float plain path."""
    route = {f"{n},{c},float32": "pallas" for n in range(1, 300) for c in SMALL["dims"]}
    int8 = {f"{n},{c}": "1" for n in range(1, 300) for c in SMALL["dims"]}
    (path / "autotune.json").write_text(json.dumps(
        {"cpu": {"attn_route": route, "fused_int8": int8}}))


def test_whole_model_int8_matches_jax(monkeypatch, tmp_path):
    """The small model with the same weights through the port's
    ``"pallas_int8"`` route and the JAX package's, gated to B3 everywhere.
    The qkv weights are scaled up (x40) so that the int8 scores move the
    output by 6x the tolerance against the float route, and the convs
    down (x0.4) so that the sigmoid masks do not saturate."""
    pm = TFSWAUNet(4, 4, attention_impl="pallas_int8",
                   generator=torch.Generator().manual_seed(0), **SMALL)
    with torch.no_grad():
        for name, w in pm.named_parameters():
            if name.endswith("attn.qkv.weight"):
                w.mul_(40.0)
            elif w.dim() == 4:
                w.mul_(0.4)
    variables = variables_from_state_dict(pm.state_dict(), SMALL["depths"])
    x = np.random.default_rng(3).standard_normal((1, 4, 33, 13)).astype(np.float32)
    _gate_everything_to_b3(tmp_path)
    monkeypatch.setenv("TFSWA_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset()
    calls = []
    try:
        import tfswa_tpu.ops.pallas.fused_block as jfb
        real = jfb.fused_row_block_int8
        monkeypatch.setattr(jfb, "fused_row_block_int8",
                            lambda *a: calls.append(a[0].shape) or real(*a))
        jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="pallas_int8", **SMALL)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                      jnp.asarray(x), train=False))
    finally:
        autotune.reset()
    assert len(calls) == 3 * sum(SMALL["depths"][:3]) * 2 + 3 * SMALL["depths"][3]
    with torch.inference_mode():
        out = pm(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (1, 4, 33, 13)
    assert ((ref > 0.05) & (ref < 0.95)).all() and ref.std() > 0.01   # not saturated
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    plain = TFSWAUNet(4, 4, attention_impl="xla", **SMALL)
    plain.load_state_dict(pm.state_dict())
    with torch.inference_mode():
        float_route = plain(torch.from_numpy(x)).numpy()
    assert np.abs(float_route - ref).max() > 5e-4     # the int8 core shows


def test_training_refuses_pallas_int8():
    """The train step refuses the serving-only route up front; the eval step
    (no gradient) takes it."""
    from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.training import create_train_state, make_eval_step, make_train_step

    small = dict(SMALL, dims=(8, 16, 32, 64), num_heads=2)
    with pytest.raises(ValueError, match="serving only"):
        create_train_state(Config(model=ModelConfig(attention_impl="pallas_int8", **small)),
                           device="cpu")
    model = TFSWAUNet(4, 4, attention_impl="pallas_int8", **small)
    proc = STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=8000))
    with pytest.raises(ValueError, match="serving only"):
        make_train_step(model, proc, ("vocals", "other"))
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2, 2000))
                           .astype(np.float32))
    loss = make_eval_step(model, proc, ("vocals", "other"))(
        None, mix, {"vocals": mix * 0.5, "other": mix * 0.5})
    assert torch.isfinite(loss["total_loss"])
