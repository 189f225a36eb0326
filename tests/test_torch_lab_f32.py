"""The kernel lab's f32 forms (``csrc/fused_block_f32.cu``
``fused_block_lab_forward_f32``) on the CPU.

The CUDA source is compiled with g++ against the CPU stand-in
``tests/_cuda_emu.h`` (as in ``tests/test_torch_f32_kernels.py``) and called
through the wrapper's own ctypes launch (``lab_row_block_parts``) on CPU
tensors, at head widths D = 4 and 8 (``attn_ffma_kernel``), 16
(``attn_kernel<16>``) and 40 (``attn_kernel<32, WIDE>``: score chunks of 32
and 8 channels, two output parts).
Held:
  - every stage and flag form against the plain f32 version fed the
    kernel's q|k|v, within 1e-5 of its largest magnitude (f32 sums of a few
    hundred terms in another order, and the products' 3xTF32), with the
    same elements non-finite (no clamp: scores past 128 overflow exp2);
  - ``full`` equal to the stand-in B1 f32 (``fused_row_block``'s launch)
    bit for bit, and ``attn`` to its y (B1-train's mid);
  - ``full`` against the JAX lab's ``_kernel_prod`` in f32 (interpret mode)
    within 2e-5, the JAX package's kernel tolerance in f32;
  - the wrapper's refusals before any launch.
"""
import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu_torch.ops import _build
from tfswa_tpu_torch.ops import fused_block as fb
from tfswa_tpu_torch.ops import lab_block
from tfswa_tpu_torch.ops.lab_block import STAGES, lab_row_block_parts, lab_row_block_reference

from test_torch_f32_kernels import _inputs

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "tfswa_tpu_torch" / "csrc"
REL = 1e-5

_spec = importlib.util.spec_from_file_location(
    "jax_kernel_lab_f32", TESTS.parent / "tools" / "kernel_lab.py")
jlab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jlab)

# (R, N, C, heads, regime): D = 4, 8, 16 and one WIDE head of 40 channels;
# N past one 32-query score tile, the clamp weights at two of them
CASES = [(2, 20, 32, 8, "clamp"), (1, 24, 32, 4, "flat"), (1, 40, 64, 4, "clamp"),
         (1, 40, 40, 1, "flat")]
FORMS = {"qkv": ("qkv", {}), "scores": ("scores", {}), "exp2": ("exp2", {}),
         "av": ("av", {}), "attn": ("attn", {}), "full": ("full", {}),
         "score_bf16": ("full", {"score_bf16": True}), "p_f32": ("full", {"p_f32": True}),
         "noclamp": ("full", {"clamp": False}),
         "attn_score_bf16_noclamp": ("attn", {"score_bf16": True, "clamp": False})}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the CUDA source's CPU stand-in"
    lib = tmp_path_factory.mktemp("emu") / "libfused_block_f32.so"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-DTFSWA_EMU",
         "-include", str(TESTS / "_cuda_emu.h"), f"-I{CSRC}", "-o", str(lib),
         str(TESTS / "_cuda_emu.cpp"), "-x", "c++", str(CSRC / "fused_block_f32.cu")],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launches on CPU tensors through the emulated library."""
    monkeypatch.setitem(_build._loaded, "fused_block_f32", emulated)
    for mod in (fb, lab_block):
        monkeypatch.setattr(mod, "_check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(mod, "_on_stream", lambda dev, fn, *a: fn(*a, None))


def _held(got, ref, rel=REL):
    """Within rel of max|ref| over the elements both give finite, and the
    same elements non-finite in both."""
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), fin)
    if fin.any():
        scale = max(float(ref[fin].abs().max()), 1e-30)
        err = float((got[fin] - ref[fin]).abs().max())
        assert err <= rel * scale, f"max |diff| {err:.3e} over {rel} x {scale:.3e}"


@pytest.mark.parametrize("R,N,C,H,regime", CASES)
@pytest.mark.parametrize("form", list(FORMS))
def test_f32_lab_form_matches_its_plain_version(kernels, form, R, N, C, H, regime):
    x, p = _inputs(R, N, C, seed=N + C + H, regime=regime)
    stage, kw = FORMS[form]
    got, qkv, _ = lab_row_block_parts(x, p, H, stage, **kw)
    assert got.dtype == torch.float32 and got.shape == x.shape
    ref = lab_row_block_reference(x, p, H, stage, qkv=qkv, **kw)
    _held(got, ref)
    if form == "noclamp" and regime == "clamp":
        q, k = qkv[:, :C].view(R, N, H, -1), qkv[:, C:2 * C].view(R, N, H, -1)
        assert float(torch.einsum("rnhd,rmhd->rhnm", q, k).max()) > fb.SCORE_CLAMP


@pytest.mark.parametrize("R,N,C,H,regime", CASES)
def test_f32_lab_full_is_b1_f32_bit_for_bit(kernels, R, N, C, H, regime):
    """The full form launches B1 f32's kernels: the same bits as B1, and the
    attn cut B1's y (B1-train's mid); p_f32 the same kernels again."""
    x, p = _inputs(R, N, C, seed=7 * N + C, regime=regime)
    b1 = fb._forward_kernel(x, p, H, train=True)
    full, qkv, attn = lab_row_block_parts(x, p, H, "full")
    assert torch.equal(full, b1.out) and torch.equal(qkv, b1.qkv)
    assert torch.equal(attn, b1.attn)
    assert torch.equal(lab_row_block_parts(x, p, H, "attn")[0], b1.mid)
    assert torch.equal(lab_row_block_parts(x, p, H, "full", p_f32=True)[0], full)


def test_f32_lab_full_matches_the_jax_lab(kernels):
    """The full form against the JAX lab's _kernel_prod with cd = float32,
    in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    x, p = _inputs(2, 24, 32, seed=5)
    jp = JaxParams(**{k: jnp.asarray(v.numpy()) for k, v in p._asdict().items()})
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jlab.block_stage("full", jnp.asarray(x.numpy()), jp, 8))
    np.testing.assert_allclose(lab_row_block_parts(x, p, 8, "full")[0].numpy(), ref,
                               atol=2e-5, rtol=2e-5)


CARD_NAN = 0x7FFFFFFF      # the NaN that the card's f32 arithmetic produces


@pytest.mark.parametrize("where", ["rows", "proj_kernel", "fc1_kernel"])
def test_f32_products_keep_the_cards_nan(kernels, where):
    """A NaN of the card's bit pattern (all mantissa bits set, which a plain
    round to TF32 carries into the sign bit: -0) in the rows or in a weight
    that a 3xTF32 product reads: the full form (B1 f32) non-finite exactly
    where the plain f32 version is, and within 1e-5 of it elsewhere."""
    R, N, C, H = 2, 20, 32, 8
    x, p = _inputs(R, N, C, seed=11)
    if where == "rows":
        x = x.clone()
        x.view(torch.int32)[0, 5, 7] = CARD_NAN
    else:
        w = getattr(p, where).clone()
        w.view(torch.int32)[3, 11] = CARD_NAN
        p = p._replace(**{where: w})
    got = lab_row_block_parts(x, p, H, "full")[0]
    ref = lab_row_block_reference(x, p, H, "full")
    assert not bool(ref.isfinite().all())
    _held(got, ref)


@pytest.mark.parametrize("stage,kw,err", [
    ("exp2", {}, "N >= C"),
    ("scores", {"p_f32": True}, "flags"),
    ("softmax", {}, "stage"),
])
def test_f32_lab_refusals_come_before_any_launch(kernels, monkeypatch, stage, kw, err):
    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(lab_block, "_on_stream", no_launch)
    x, p = _inputs(1, 4, 32, seed=1)
    with pytest.raises(ValueError, match=err):
        lab_row_block_parts(x, p, 4, stage, **kw)


def test_f32_lab_refuses_a_head_wider_than_the_lab_takes(kernels):
    x, p = _inputs(1, 8, 256, seed=2)
    with pytest.raises(ValueError, match="head dims up to 128"):
        lab_row_block_parts(x, p, 1, "full")


def test_f32_lab_entry_refuses_what_it_does_not_take(emulated):
    """The C entry itself: a head past 128 channels, flags on a cut, kept
    keys past 256 at stage scores, a missing attention buffer."""
    fn = emulated.fused_block_lab_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    buf = torch.zeros(64)
    ptrs = [buf.data_ptr()] * 16
    for R, N, C, H, hidden, stage, flags in [(1, 8, 256, 1, 8, 5, 0), (1, 8, 32, 8, 8, 1, 1),
                                             (1, 300, 512, 8, 8, 1, 0)]:
        assert fn(*ptrs, R, N, C, H, hidden, stage, flags, None) != 0
    assert fn(*ptrs[:13], None, *ptrs[14:], 1, 8, 32, 8, 8, STAGES.index("av"), 0, None) != 0


# ------------------------------------------------ chip_smoke.py's f32 lab parts

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_lab_f32",
                                                  TESTS.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.MUFU_RATE = 16 * 132 * 1980e6
    return mod


def test_the_score_bf16_plant_makes_the_kernel_ignore_the_flag(chip_smoke, kernels, tmp_path,
                                                                 monkeypatch):
    """--plant lab_f32_score_bf16 edits one place of fused_block_f32.cu, and
    the planted kernel's score_bf16 form is its unflagged full form, bit for
    bit, where the unplanted one rounds (the clamp weights)."""
    assert chip_smoke.F32_PLANT_SOURCES["lab_f32_score_bf16"] == "fused_block_f32.cu"
    old, new = chip_smoke.LAB_F32_PLANTS["lab_f32_score_bf16"]
    src = (CSRC / "fused_block_f32.cu").read_text()
    assert src.count(old) == 1 and old != new
    planted = tmp_path / "fused_block_f32.cu"
    planted.write_text(src.replace(old, new))
    lib = tmp_path / "libplanted.so"
    res = subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-DTFSWA_EMU",
         "-include", str(TESTS / "_cuda_emu.h"), f"-I{CSRC}", "-o", str(lib),
         str(TESTS / "_cuda_emu.cpp"), "-x", "c++", str(planted)],
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    x, p = _inputs(1, 24, 32, seed=9, regime="clamp")
    rounded = lab_row_block_parts(x, p, 8, "full", score_bf16=True)[0]
    monkeypatch.setitem(_build._loaded, "fused_block_f32", ctypes.CDLL(str(lib)))
    ignored = lab_row_block_parts(x, p, 8, "full", score_bf16=True)[0]
    assert torch.equal(ignored, lab_row_block_parts(x, p, 8, "full")[0])
    assert not torch.equal(ignored, rounded)


def test_f32_lab_checks_reach_every_head_width(chip_smoke):
    """The shapes of phase 2b: the 12 serving shapes, wide384's D = 12-96 and
    the edge's D = 3, 4, 8, 16, 32, 64, 128, each (N, C, H) one the kernel
    takes (C a multiple of 8 up to 512, D up to 128)."""
    shapes = chip_smoke.lab_f32_shapes()
    heads = {C // H for _, _, C, H in shapes}
    assert {3, 4, 8, 16, 32, 64, 128, 12, 24, 48, 96} <= heads and max(heads) <= 128
    assert len(shapes) == 2 * len(chip_smoke.SHAPES) + 2 * len(chip_smoke.LAB_F32_EDGE)
    assert all(C % 8 == 0 and C <= 512 and C % H == 0 for _, _, C, H in shapes)


def test_f32_lab_bounds(chip_smoke):
    """The full and flag forms are B1 f32's bound; the cuts grow with the
    stage and stay under it; the cuts before exp2 run no exp2."""
    R, N, C = 6896, 1024, 32
    full = chip_smoke.bound_f32_ms("B1", R, N, C, 4 * C)
    for name in ("full", "score_bf16", "p_f32", "noclamp"):
        assert chip_smoke.bound_lab_f32_ms(name, R, N, C, 4 * C) == full
    cuts = [chip_smoke.bound_lab_f32_ms(n, R, N, C, 4 * C)[0]
            for n in ("qkv", "scores", "exp2", "av", "attn")]
    assert cuts == sorted(cuts) and cuts[-1] <= full[0]
    nbytes = 4 * (2 * R * N * C + 3 * C * C + 2 * C)
    flops = 2 * R * N * 3 * C * C + 2 * R * N * N * C
    assert chip_smoke.bound_lab_f32_ms("scores", R, N, C, 4 * C)[0] == pytest.approx(
        max(nbytes / 3.35e12, flops / (495e12 / 3)) * 1e3)
