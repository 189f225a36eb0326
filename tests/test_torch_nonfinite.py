"""Non-finite inputs: the port's plain versions of B1, B1-train, B2 and B4
against the JAX package's Pallas kernels (interpret mode, as its own tests
run them), on the CPU, in f32.

The kernels clamp each score with min(s, 110) before exp2; the JAX
package's ``jnp.minimum`` keeps a NaN score NaN, and so must every form of
the port (fminf, which returns 110, would make p the finite 2^110).  Three
cases, each in row 1 of 4 rows (R, N, C) = (4, 20, 32), 8 heads:
  - nan: one token of the card's NaN (0x7fffffff);
  - inf: one token of +inf;
  - overflow: for the fused block, k's channels 0 and 1 of head 0 overflow
    f32 (+inf, -inf) in every token of the row while q's are finite and of
    one sign, so that every q.k of head 0 is inf - inf (weights of 2^127 on
    LN1's channel 0, which is exactly 0 in the other rows: their tokens sum
    to exactly 0); for B4, which has no LayerNorm, channel 0 of the row at
    2^80, so that its scores pass f32's range.
Held: every output is non-finite exactly where the JAX kernel's is (B2 on
the JAX forward's mid, acc and den of the rows without the case), and in
the overflow case the fused block's outputs are non-finite somewhere.  And
of the CUDA sources and chip_smoke.py's phase 3b, which holds the kernels
to the same rule on the card: every score clamp through the NaN-keeping
clamp_score, the fminf plant, the phase's shapes and rows.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas import autotune
from tfswa_tpu.ops.pallas.fused_block import _fused_block_bwd_impl, _fused_block_impl
from tfswa_tpu.ops.pallas.row_attention import flash_row_attention as jax_flash
from tfswa_tpu_torch.models.attention import RowBlockParams
from tfswa_tpu_torch.ops.fused_block import (fused_row_block_bwd_reference,
                                             fused_row_block_reference,
                                             fused_row_block_train_reference, layer_norm_f32)
from tfswa_tpu_torch.ops.row_attention import flash_row_attention_reference

R, N, C, H = 4, 20, 32, 8
ROW = 1
CARD_NAN = 0x7FFFFFFF
BIG = np.float32(2.0 ** 127)


@pytest.fixture(autouse=True)
def _own_autotune_dir(monkeypatch, tmp_path):
    """The JAX kernels read per-chip tables: give them an empty one."""
    monkeypatch.setenv("TFSWA_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset()
    yield
    autotune.reset()


def _params(seed, block=True):
    rng = np.random.default_rng(seed)

    def r(*s, sc=0.05):
        return (rng.standard_normal(s) * sc).astype(np.float32)

    p = dict(norm1_scale=1.0 + r(C, sc=0.1), norm1_bias=r(C, sc=0.1),
             qkv_kernel=r(C, 3 * C), proj_kernel=r(C, C), proj_bias=r(C, sc=0.01),
             norm2_scale=1.0 + r(C, sc=0.1), norm2_bias=r(C, sc=0.1), fc1_kernel=r(C, 4 * C),
             fc1_bias=r(4 * C, sc=0.01), fc2_kernel=r(4 * C, C), fc2_bias=r(C, sc=0.01))
    if block:
        p["norm1_scale"][0], p["norm1_bias"][0] = 1.0, 0.0
        p["qkv_kernel"][0, :2] = 64.0
        p["qkv_kernel"][0, C], p["qkv_kernel"][0, C + 1] = BIG, -BIG
    return p


def _rows(seed):
    """Tokens that sum to exactly 0 (channels c and c + C/2 opposite
    multiples of 1/8), channels 0 and C/2 zero."""
    rng = np.random.default_rng(seed)
    half = rng.integers(2, 34, (R, N, C // 2)) / 8.0 * rng.choice([-1.0, 1.0], (R, N, C // 2))
    x = np.concatenate([half, -half], axis=-1).astype(np.float32)
    x[..., 0] = x[..., C // 2] = 0.0
    return x


def _case(x, case, block=True):
    x = x.copy()
    if case == "nan":
        x.view(np.int32)[ROW, N // 3] = CARD_NAN
    elif case == "inf":
        x[ROW, N // 3] = np.inf
    elif block:
        x[ROW, :, 0], x[ROW, :, C // 2] = 8.0, -8.0
    else:
        x[ROW, :, 0] = 2.0 ** 80
    return x


def _jax_p(p):
    return JaxParams(**{k: jnp.asarray(v) for k, v in p.items()})


def _torch_p(p):
    return RowBlockParams(**{k: torch.from_numpy(v) for k, v in p.items()})


def _same_nonfinite(got, ref):
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f"output {i}")


def _jax_forward(x, p, with_mid):
    with pltpu.force_tpu_interpret_mode():
        out = _fused_block_impl(jnp.asarray(x), _jax_p(p), H, with_mid=with_mid)
    return [np.asarray(a) for a in (out if with_mid else [out])]


CASES = ("nan", "inf", "overflow")


@pytest.mark.parametrize("case", CASES)
def test_b1_plain_is_non_finite_where_jax_is(case):
    p, x = _params(1), _case(_rows(2), case)
    ref = _jax_forward(x, p, with_mid=False)
    got = [fused_row_block_reference(torch.from_numpy(x), _torch_p(p), H).numpy()]
    _same_nonfinite(got, ref)
    assert not np.isfinite(ref[0][ROW]).all()
    assert np.isfinite(ref[0][np.arange(R) != ROW]).all()


@pytest.mark.parametrize("case", CASES)
def test_b1_train_plain_is_non_finite_where_jax_is(case):
    p, x = _params(3), _case(_rows(4), case)
    ref = _jax_forward(x, p, with_mid=True)
    got = [t.numpy() for t in fused_row_block_train_reference(torch.from_numpy(x),
                                                                _torch_p(p), H)]
    _same_nonfinite(got, ref)
    assert not np.isfinite(ref[0]).all()


@pytest.mark.parametrize("case", CASES)
def test_b2_plain_is_non_finite_where_jax_is(case):
    p, x0 = _params(5), _rows(6)
    x = _case(x0, case)
    g = np.random.default_rng(7).standard_normal((R, N, C)).astype(np.float32)
    _, mid, acc, den = _jax_forward(x0, p, with_mid=True)
    with pltpu.force_tpu_interpret_mode():
        jdx, jdp = _fused_block_bwd_impl(*(jnp.asarray(a) for a in (x, mid, acc, den, g)),
                                         _jax_p(p), H)
    ref = [np.asarray(jdx)] + [np.asarray(a) for a in jdp]
    dx, dp = fused_row_block_bwd_reference(*(torch.from_numpy(np.array(a))
                                             for a in (x, mid, acc, den, g)),
                                           _torch_p(p), H)
    _same_nonfinite([dx.numpy()] + [a.numpy() for a in dp], ref)
    assert not np.isfinite(ref[0][ROW]).all()


@pytest.mark.parametrize("case", CASES)
def test_b4_plain_is_non_finite_where_jax_is(case):
    p, x = _params(8, block=False), _case(_rows(9), case, block=False)
    w = [p[k] for k in ("qkv_kernel", "proj_kernel", "proj_bias")]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_flash(jnp.asarray(x), *(jnp.asarray(a) for a in w), H))
    got = flash_row_attention_reference(torch.from_numpy(x), *(torch.from_numpy(a) for a in w), H)
    _same_nonfinite([got.numpy()], [ref])
    assert not np.isfinite(ref[ROW]).all()


# ---------------------------------------- the clamp in the CUDA sources

CSRC = Path(__file__).resolve().parent.parent / "tfswa_tpu_torch" / "csrc"


def test_every_score_clamp_goes_through_clamp_score():
    """No kernel keeps its own fminf on a score: SCORE_CLAMP's min is the
    NaN-keeping clamp_score of block_common.cuh (bf16 kernels) and
    block_f32.cuh (f32 kernels), and every site that clamps calls it."""
    for header in ("block_common.cuh", "block_f32.cuh"):
        src = (CSRC / header).read_text()
        assert "float clamp_score(float s)" in src and "min.NaN.f32" in src
        assert "float max_keep_nan(float a, float b)" in src and "max.NaN.f32" in src
    sites = {"fused_block.cu": 1, "fused_block_f32.cu": 1, "fused_block_bwd.cu": 1,
             "fused_block_bwd_f32.cu": 4}
    for name, n in sites.items():
        src = (CSRC / name).read_text()
        assert src.count("clamp_score(") == n, name
        assert not re.search(r"fminf\([^;]*SCORE_CLAMP", src), name
    for name in ("fused_block.cu", "fused_block_f32.cu"):    # B3's row scales
        src = (CSRC / name).read_text()
        body = src[src.index("qk_scale_kernel("):]
        body = body[:body.index("\n}\n")]
        assert "fmaxf" not in body and body.count("max_keep_nan(") == 6, name


def test_heads_sharing_a_product_keep_nan_in_their_own_head():
    """At D <= 8 one tensor-core product spans several heads, masked to one
    by zeros, and 0 x inf is NaN: B1's ln_qkv_kernel lists the rows whose k
    holds an inf or NaN, the attention skips them and a fix-up launch does
    them with k masked too; B2 recomputes a NaN score as its head's own FMA
    chain (clamp_band) and, in a pass with a non-finite bound, adds a
    head's product to its own accumulator columns only (head_acc's
    ``apart``); its bound keeps NaN."""
    common = (CSRC / "block_common.cuh").read_text()
    assert "if (atomicOr(fix + 1 + M / N + r, 1) == 0)" in common
    fwd = (CSRC / "fused_block.cu").read_text()
    assert "bool EXACT = true, bool FIX = false>" in fwd
    assert "if (MASK_K && !FIX && fix != nullptr && fix[1 + rows + r]) return;" in fwd
    assert fwd.count("attn_kernel<DP, WITH_DEN, INT8, STAGE, FLAGS, true, true>") == 1
    assert fwd.count("attn_kernel<DP, WITH_DEN, INT8, STAGE, FLAGS, false, true>") == 1
    bwd = (CSRC / "fused_block_bwd.cu").read_text()
    assert "!(fabsf(s[j][e] - SCORE_CLAMP) >= CLAMP_BAND)" in bwd
    assert bwd.count("!pass_low && apart") == 3
    norm = bwd[bwd.index("attn_bwd_norm_kernel("):]
    norm = norm[:norm.index("\n}\n")]
    assert norm.count("max_keep_nan(") == 4 and "fmaxf" not in norm


@pytest.fixture(scope="module")
def chip_smoke():
    root = Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke_nf", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_fminf_plant_puts_exp2_lines_clamp_back_on_fminf(chip_smoke):
    assert chip_smoke.F32_PLANT_SOURCES["fminf_clamp"] == "fused_block.cu"
    src = (CSRC / "fused_block.cu").read_text()
    old, new = chip_smoke.NF_PLANTS["fminf_clamp"]
    assert src.count(old) == 1 and "fminf(" in new and "SCORE_CLAMP" in new
    line = src[src.index("__device__ __forceinline__ void exp2_line"):]
    assert old in line[:line.index("\n}\n")]


def test_phase_3b_runs_every_kernel_at_stages_0_and_3(chip_smoke):
    assert [s[:4] for s in chip_smoke.NF_SHAPES] == [
        (0, "TSA", 1024, 32), (0, "FSA", 862, 32), (0, "SWA", 64, 32),
        (3, "TSA", 128, 256), (3, "FSA", 107, 256), (3, "SWA", 64, 256)]
    assert [s[:4] for s in chip_smoke.NF_TRAIN_SHAPES] == [
        (0, "TSA", 1025, 32), (0, "FSA", 517, 32), (0, "SWA", 64, 32),
        (3, "TSA", 128, 256), (3, "FSA", 64, 256), (3, "SWA", 64, 256)]
    assert chip_smoke.NF_CASES == ("nan", "inf", "overflow", "nan_k")


@pytest.mark.parametrize("C", [32, 256])
def test_phase_3b_rows_make_ln1s_channel_0_exactly_zero(chip_smoke, C):
    """nf_rows' tokens sum to exactly 0 in any order, so that LN1's channel 0
    is exactly 0 and the NF_BIG weights on it add nothing outside the
    overflow row; in that row it is far from 0 (k past f32's range)."""
    gen = torch.Generator().manual_seed(C)
    x = chip_smoke.nf_rows(torch, 64, C, gen)
    assert torch.equal(x.sum(-1), torch.zeros(x.shape[:2]))
    assert torch.equal(x.to(torch.bfloat16).float(), x)
    ones, zeros = torch.ones(C), torch.zeros(C)
    n = layer_norm_f32(x, ones, zeros)
    assert torch.equal(n[..., 0], torch.zeros(x.shape[:2]))
    x[chip_smoke.NF_ROW, :, 0], x[chip_smoke.NF_ROW, :, C // 2] = 8.0, -8.0
    n = layer_norm_f32(x, ones, zeros)[chip_smoke.NF_ROW, :, 0]
    assert float(n.min()) * chip_smoke.NF_BIG > torch.finfo(torch.float32).max
