"""Every width on the kernel routes, on the CPU.

The kernels take any C a multiple of 8 up to 512 and any head count H that
divides C (csrc/block_common.cuh ``head_plan``: the product kernels at C
rounded up to 32, 64, 128, 256, 384 or 512, the attention's heads padded
to a power of two).  Held here, with no card:
  - the plain versions of B1, B1-train, B3, B2 and B4 against the JAX
    package's Pallas kernels (interpret mode) at (C, H) off the old lists,
    f32, with the tolerances of ``test_torch_fused_block.py`` (2e-5),
    ``test_torch_int8_block.py`` (1e-4) and ``test_torch_fused_block_bwd.py``
    (1e-4 of each leaf's largest magnitude);
  - the f32 CUDA sources themselves, compiled with g++ against
    ``tests/_cuda_emu.h`` and called through the wrappers' own launches
    (``test_torch_f32_kernels.py``'s fixtures), against the plain f32
    versions within 1e-5 of the largest magnitude: B1, B1-train, B3, B2
    (twice, bit for bit) and B4 at D = 3, 12, 48, 128, 8, B4 also at 3 and
    6 heads and at D = 1 (C = 8, 8 heads) and D = 512 (C = 512, one head).
    It is the only check of CUDA code at the new widths without a card;
  - a whole model at a narrow off-list width, dims (8, 16, 24, 48) and 4
    heads (D = 2, 4, 6, 12), against JAX with the same weights: a
    SourceSeparator separation and a train step through ``"pallas"`` and
    ``"pallas_attn"`` (the routes' plain versions on the CPU), at the
    tolerances of ``test_torch_separation.py`` and
    ``test_torch_train_step.py``;
  - admission: every (N, C) of ``wide384``'s serving and training paths
    (``chip_smoke.WIDE384``) and every entry of the edge grid
    (``chip_smoke.EDGE_GRID``) in both dtypes, and a width that stays
    refused (C not a multiple of 8, C past 512, H not dividing C) raising
    before any launch in every wrapper.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from test_torch_f32_kernels import _close, _inputs, emulated, kernels  # noqa: F401
from test_torch_fused_block import FakeCuda, _np_params, _torch_params
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas import autotune
from tfswa_tpu.ops.pallas.fused_block import (_fused_block_bwd_impl, _fused_block_impl,
                                              fused_row_block as jax_fused_row_block,
                                              fused_row_block_int8 as jax_int8)
from tfswa_tpu.ops.pallas.row_attention import flash_row_attention as jax_flash
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, STFTConfig
from tfswa_tpu_torch.evaluation import SourceSeparator
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops import fused_block as fb
from tfswa_tpu_torch.ops import row_attention as ra
from tfswa_tpu_torch.ops.lab_block import lab_row_block
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.weights import variables_from_state_dict

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_widths", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (C, H) off the old lists: D = 3, 12, 8 (5 heads), 4 (C = 16)
OFF_LIST = [(24, 8), (48, 4), (40, 5), (16, 4)]


@pytest.fixture(autouse=True)
def _own_autotune_dir(monkeypatch, tmp_path):
    """The JAX kernels read per-chip tables: give them an empty one."""
    monkeypatch.setenv("TFSWA_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset()
    yield
    autotune.reset()


def _rows_params(R, N, C, seed, qkv_scale=0.25):
    rng = np.random.default_rng(seed)
    p = _np_params(rng, C)
    p["qkv_kernel"] = (p["qkv_kernel"] / 0.05 * qkv_scale).astype(np.float32)
    rows = (rng.standard_normal((R, N, C)) * 0.5).astype(np.float32)
    g = rng.standard_normal((R, N, C)).astype(np.float32)
    return rows, p, g


def _jp(p):
    return JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})


def _near(got, ref, rel):
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(np.asarray(got) - ref).max() <= rel * scale


# --- the plain versions against the JAX kernels, f32 -----------------------

@pytest.mark.parametrize("C,H", OFF_LIST)
def test_plain_b1_and_b1_train_match_the_jax_kernel(C, H):
    rows, p, _ = _rows_params(2, 37, C, seed=C + H)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fused_row_block(jnp.asarray(rows), _jp(p), H))
        ref_train = [np.asarray(a) for a in _fused_block_impl(jnp.asarray(rows), _jp(p), H,
                                                              with_mid=True)]
    x, tp = torch.from_numpy(rows), _torch_params(p)
    np.testing.assert_allclose(fb.fused_row_block_reference(x, tp, H).numpy(), ref,
                               atol=2e-5, rtol=2e-5)
    got = fb.fused_row_block_train_reference(x, tp, H)
    for name, a, b in zip(("out", "mid", "acc", "den"), got, ref_train):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("C,H", OFF_LIST)
def test_plain_b3_matches_the_jax_kernel(C, H):
    rows, p, _ = _rows_params(2, 37, C, seed=3 * C + H)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_int8(jnp.asarray(rows), _jp(p), H))
    out = fb.fused_row_block_int8_reference(torch.from_numpy(rows), _torch_params(p), H)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("C,H", OFF_LIST)
def test_plain_b2_matches_the_jax_kernel(C, H):
    rows, p, g = _rows_params(2, 37, C, seed=5 * C + H)
    with pltpu.force_tpu_interpret_mode():
        out, mid, acc, den = _fused_block_impl(jnp.asarray(rows), _jp(p), H, with_mid=True)
        jdx, jdp = _fused_block_bwd_impl(jnp.asarray(rows), mid, acc, den, jnp.asarray(g),
                                         _jp(p), H)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    dx, dp = fb.fused_row_block_bwd_reference(t(rows), t(mid), t(acc), t(den), t(g),
                                              _torch_params(p), H)
    for a, b in zip([dx, *dp], [jdx, *jdp]):
        assert a.shape == b.shape
        _near(a.numpy(), np.asarray(b), 1e-4)


@pytest.mark.parametrize("C,H", OFF_LIST + [(48, 3), (48, 1)])
def test_plain_b4_matches_the_jax_kernel(C, H):
    rng = np.random.default_rng(7 * C + H)
    rows = rng.standard_normal((2, 37, C)).astype(np.float32)
    w = ((rng.standard_normal((C, 3 * C)) * 0.05).astype(np.float32),
         (rng.standard_normal((C, C)) * 0.05).astype(np.float32),
         (rng.standard_normal(C) * 0.01).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash(jnp.asarray(rows), *(jnp.asarray(a) for a in w), H))
    out = ra.flash_row_attention_reference(torch.from_numpy(rows),
                                           *(torch.from_numpy(a) for a in w), H)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)


# --- the f32 CUDA sources through the CPU stand-in -------------------------

EMU_WIDTHS = [(24, 8), (48, 4), (96, 2), (128, 1), (40, 5)]


@pytest.mark.parametrize("C,H", EMU_WIDTHS)
def test_f32_forward_sources_at_any_width(kernels, C, H):  # noqa: F811
    R, N = 2, 21
    x, p = _inputs(R, N, C, seed=C + H, regime="clamp")
    run = fb._forward_kernel(x, p, H)
    out, attn = fb.fused_row_block_reference_parts(x, p, H, qkv=run.qkv)
    _close(run.out, out)
    _close(run.attn, attn)
    tr = fb._forward_kernel(x, p, H, train=True)
    refs = fb.fused_row_block_train_reference(x, p, H, qkv=tr.qkv)
    for got, ref in zip((tr.out, tr.mid, tr.attn, tr.den), refs):
        _close(got, ref)
    i8 = fb._forward_kernel(x, p, H, int8=True)
    q3 = i8.qkv.view(R, N, 3 * C)
    (qi, _), (ki, _) = fb.quantize_rows(q3[..., :C]), fb.quantize_rows(q3[..., C:2 * C])
    qk = i8.qk.view(R, N, 2 * C).float()
    assert torch.equal(qk[..., :C], qi) and torch.equal(qk[..., C:], ki)
    out8, attn8 = fb.fused_row_block_int8_reference_parts(x, p, H, qkv=i8.qkv)
    _close(i8.out, out8)
    _close(i8.attn, attn8)


@pytest.mark.parametrize("C,H", EMU_WIDTHS)
def test_f32_backward_source_at_any_width(kernels, C, H):  # noqa: F811
    R, N = 2, 21
    x, p = _inputs(R, N, C, seed=2 * C + H, regime="clamp")
    g = torch.from_numpy(np.random.default_rng(C).standard_normal((R, N, C))
                         .astype(np.float32))
    tr = fb._forward_kernel(x, p, H, train=True)
    got = fb._bwd_kernel(x, tr.mid, tr.attn, tr.den, g, p, H)
    again = fb._bwd_kernel(x, tr.mid, tr.attn, tr.den, g, p, H)
    ref = fb.fused_row_block_bwd_reference_parts(x, tr.mid, tr.attn, tr.den, g, p, H,
                                                 qkv=tr.qkv)
    for a, b in zip((got.dx, *got.dp, got.d_oe, got.d_den, got.dqkv),
                    (ref.dx, *ref.dp, ref.d_oe, ref.d_den, ref.dqkv)):
        _close(a, b)
    for a, b in zip((got.dx, *got.dp, got.dqkv), (again.dx, *again.dp, again.dqkv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C,H", EMU_WIDTHS + [(48, 3), (96, 6), (8, 8), (512, 1)])
def test_f32_row_attention_source_at_any_width(kernels, C, H):  # noqa: F811
    R, N = 1, 19
    rng = np.random.default_rng(C * H)
    x, wq, wp, b = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, N, C)), rng.standard_normal((C, 3 * C)) * 1.44 / C ** 0.5,
        rng.standard_normal((C, C)) * 0.05, rng.standard_normal(C) * 0.01))
    out, acc, _, _ = ra._kernel(x, wq, wp, b, H, export=True)
    r_out, r_acc = ra.flash_row_attention_reference_parts(x, wq, wp, b, H)
    _close(out, r_out)
    _close(acc, r_acc)


# --- a whole model at a narrow off-list width ------------------------------

SR = 8000
NARROW = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 48), window_size=4, shift_size=2,
              num_heads=4)
STEMS = ("vocals", "other")


@pytest.fixture(scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _narrow_model(impl):
    return TFSWAUNet(4, 4, attention_impl=impl, generator=torch.Generator().manual_seed(0),
                     **NARROW)


@pytest.fixture(scope="module")
def jax_narrow(two_threads):
    """The narrow model's weights (the port's seeded init) in JAX, the JAX
    separation of a 3 s track and one jitted JAX train step (loss, raw
    gradients through an optax transform that hands them out)."""
    variables = jax.tree_util.tree_map(jnp.asarray, variables_from_state_dict(
        _narrow_model("xla").state_dict(), NARROW["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **NARROW)
    proc = JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=SR))
    sep = JaxSeparator(jm, variables, proc, segment_length=1.0, stem_names=STEMS)
    separated = {k: np.asarray(v) for k, v in sep.separate(_audio()).items()}
    capture = optax.GradientTransformation(
        lambda q: jax.tree_util.tree_map(jnp.zeros_like, q),
        lambda gr, s, q=None: (jax.tree_util.tree_map(jnp.zeros_like, gr), gr))
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=capture.init(variables["params"]), tx=capture)
    step = jax.jit(jts.make_train_step(jm, proc, STEMS),
                   compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = _batch()
    new, loss = step(state, jnp.asarray(mix), {k: jnp.asarray(v) for k, v in targets.items()})
    grads = dict(_flat(new.opt_state))
    return separated, {k: float(v) for k, v in loss.items()}, grads


def _audio():
    t = np.arange(3 * SR) / SR
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.random.default_rng(0)
            .standard_normal(t.size)).astype(np.float32)


def _batch():
    rng = np.random.default_rng(1)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    return mix, {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32)
                 for k in STEMS}


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


@pytest.mark.parametrize("impl", ["pallas", "pallas_attn"])
def test_narrow_model_separation_matches_jax(jax_narrow, impl):
    ref = jax_narrow[0]
    sep = SourceSeparator(_narrow_model(impl), STFTProcessor(STFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), segment_length=1.0, stem_names=STEMS,
        device="cpu")
    got = sep.separate(_audio())
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("impl", ["pallas", "pallas_attn"])
def test_narrow_model_train_step_matches_jax(jax_narrow, impl):
    _, ref_loss, ref_grads = jax_narrow
    model = _narrow_model(impl)
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    step = pts.make_train_step(model, STFTProcessor(STFTConfig(
        n_fft=256, hop_length=64, sample_rate=SR)), STEMS)
    grads = {}
    orig = tx.step
    tx.step = lambda: grads.update({n: q.grad.clone() for n, q in model.named_parameters()}) \
        or orig()
    mix, targets = _batch()
    _, loss = step(pts.TrainState(0, model, tx), torch.from_numpy(mix),
                   {k: torch.from_numpy(v) for k, v in targets.items()})
    for k, v in ref_loss.items():
        np.testing.assert_allclose(float(loss[k]), v, rtol=1e-5, err_msg=k)
    got = dict(_flat(variables_from_state_dict(grads, NARROW["depths"])["params"]))
    assert set(got) == set(ref_grads)
    floor = 1e-6 * max(np.abs(g).max() for g in ref_grads.values())
    for k, ref in ref_grads.items():
        assert np.abs(got[k] - ref).max() <= 1e-4 * np.abs(ref).max() + floor, k


# --- admission ---------------------------------------------------------------

@pytest.mark.parametrize("path", ["serving", "training"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_admit_every_wide384_row_shape(path, dtype):
    shapes = chip_smoke.wide_row_shapes(path)
    assert len(shapes) == 12
    H = chip_smoke.WIDE384["num_heads"]
    for R, N, C in shapes:
        fb.check_shape("fused_row_block", R, N, C, H, 4 * C, dtype)
        ra.check_shape(R, N, C, H, dtype)
        limit = fb.STATIC_SMEM_BYTES if dtype == torch.float32 else fb.MAX_SMEM_BYTES
        assert fb.kernel_smem_bytes(C, 4 * C, dtype, H) <= limit
        assert ra.kernel_smem_bytes(C, H, dtype) <= limit


@pytest.mark.parametrize("C,H", chip_smoke.EDGE_GRID)
def test_kernels_admit_the_edge_grid(C, H):
    for dtype in (torch.bfloat16, torch.float32):
        limit = fb.STATIC_SMEM_BYTES if dtype == torch.float32 else fb.MAX_SMEM_BYTES
        for N in chip_smoke.EDGE_N:
            for hidden in (2 * C, 4 * C + 8):
                fb.check_shape("fused_row_block", 64, N, C, H, hidden, dtype)
                assert fb.kernel_smem_bytes(C, hidden, dtype, H) <= limit
            ra.check_shape(64, N, C, H, dtype)
            assert ra.kernel_smem_bytes(C, H, dtype) <= limit


def test_every_width_up_to_512_and_every_head_count_is_admitted():
    """C a multiple of 8 from 8 to 512, every H dividing it, both dtypes,
    and the head plan the kernels compute: DP a power of two at least D,
    CA = H DP rounded up to 32, the padding round trip exact."""
    n = 0
    for C in range(8, 513, 8):
        for H in (h for h in range(1, C + 1) if C % h == 0):
            for dtype in (torch.bfloat16, torch.float32):
                fb.check_shape("fused_row_block", 2, 16, C, H, 4 * C, dtype)
                ra.check_shape(2, 16, C, H, dtype)
            D, DP, CA, HK = fb.head_plan(C, H)
            assert DP >= max(D, 4) and DP & (DP - 1) == 0 and DP < 2 * max(D, 4)
            assert CA % 32 == 0 and CA >= H * DP and HK * DP == CA
            assert fb.prod_width(C) >= C and fb.prod_width(C) % 32 == 0
            n += 1
    t = torch.arange(2 * 3 * 40, dtype=torch.float32).view(2, 120)
    padded = fb.pad_heads(t, 40, 5)
    assert padded.shape == (2, 3 * 64) and torch.equal(fb.unpad_heads(padded, 40, 5), t)
    assert padded.view(2, 3, 8, 8)[:, :, 5:].abs().sum() == 0      # the heads past H
    assert n > 500


def _wrappers(C, H):
    """Every kernel wrapper on a FakeCuda of width C, H heads."""
    rng = np.random.default_rng(0)
    p = _torch_params(_np_params(rng, C))
    rows = lambda dt: FakeCuda((2, 16, C), dt)  # noqa: E731
    like = torch.zeros(2, 16, C)
    return {
        "B1": lambda dt: fb.fused_row_block(rows(dt), p, H),
        "B1-train": lambda dt: fb.fused_row_block_train(rows(dt), p, H),
        "B2": lambda dt: fb.fused_row_block_bwd(rows(dt), like, like, torch.zeros(2, H, 16),
                                                like, p, H),
        "B3": lambda dt: fb.fused_row_block_int8(rows(dt), p, H),
        "L": lambda dt: lab_row_block(rows(dt), p, H, "attn"),
        "B4": lambda dt: ra.flash_row_attention(rows(dt), p.qkv_kernel, p.proj_kernel,
                                                p.proj_bias, H),
    }


@pytest.mark.parametrize("C,H", [(44, 4), (520, 8), (48, 5)])
@pytest.mark.parametrize("kernel", ["B1", "B1-train", "B2", "B3", "L", "B4"])
def test_a_width_outside_the_rule_raises_before_any_launch(kernel, C, H, monkeypatch):
    """C not a multiple of 8, C past 512, a head count not dividing C: a
    ValueError naming the field, in both dtypes (the lab: bf16), before any
    library is loaded."""
    from tfswa_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"{name} loaded"))
    for dt in (torch.bfloat16,) if kernel == "L" else (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="no kernel for (C=|[0-9]+ heads)"):
            _wrappers(C, H)[kernel](dt)


@pytest.mark.parametrize("C,H", [(256, 1), (512, 2), (512, 1)])
def test_the_lab_refuses_a_head_wider_than_its_instantiations(C, H, monkeypatch):
    """The lab (L) is instantiated for head dims up to 128 (B1 for every
    head dim up to 512): a wider head raises before any launch."""
    from tfswa_tpu_torch.ops import _build
    from tfswa_tpu_torch.ops.lab_block import LAB_MAX_HEAD_DIM

    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"{name} loaded"))
    assert C // H > LAB_MAX_HEAD_DIM
    with pytest.raises(ValueError, match="no kernel for a head dim"):
        _wrappers(C, H)["L"](torch.bfloat16)
