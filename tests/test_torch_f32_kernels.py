"""The f32 forms of B1, B1-train, B3, B2 and B4
(``tfswa_tpu_torch/csrc/*_f32*``) on the CPU.

The CPU tests run with no card and no nvcc, so the CUDA sources themselves are
compiled with g++ against a CPU stand-in of the CUDA subset they use
(``tests/_cuda_emu.h``: a block's threads as fibers of one OS thread,
__syncthreads a barrier, a warp's shuffle and mma.sync an exchange at
barriers) and called
through the wrappers' own ctypes launches, on CPU tensors.  Held:
  - every output against the plain f32 version (the wrappers' CPU path)
    within 1e-5 of its largest magnitude: f32 sums of at most a few hundred
    terms in another order (the products' tiles, the key loop), a few f32
    ulp, and the products' 3xTF32 (about 2^-22 of each product left out);
  - the tensor cores' stand-ins (TF32 m16n8k8, int8 m16n8k32) against the
    plain products at every lane, 3xTF32 within f32's error where one TF32
    pass is not, and B2's attention backward on scores planted at the
    clamp taking the plain version's side of it;
  - B3's int8 q, k and row scales exactly (the same true division and
    rounding half to even);
  - B2 twice bit for bit (no atomics), each gradient leaf within 1e-5 of
    its largest magnitude;
  - B1's f32 form against the JAX package's Pallas kernel in f32 (interpret
    mode) within its tests' 2e-5;
  - the routing: f32 rows launch the f32 libraries and bf16 rows the
    others (stand-in libraries), each counted apart; float16 raises; the
    f32 forms' shared memory admits every flagship shape.
"""
import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas.fused_block import fused_row_block as jax_fused_row_block
from tfswa_tpu_torch.models.attention import RowBlockParams
from tfswa_tpu_torch.ops import _build
from tfswa_tpu_torch.ops import fused_block as fb
from tfswa_tpu_torch.ops import row_attention as ra

from test_torch_fused_block import FLAGSHIP_PATHS, FakeCuda, flagship_row_shapes

TESTS = Path(__file__).resolve().parent
CSRC = TESTS.parent / "tfswa_tpu_torch" / "csrc"
LIBS = ("fused_block_f32", "fused_block_bwd_f32", "row_attention_f32")
H = 8
REL = 1e-5


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The three f32 sources built with g++ against tests/_cuda_emu.h, one
    process each, in parallel."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the CUDA sources' CPU stand-in"
    out = tmp_path_factory.mktemp("emu")

    def build(name):
        lib = out / f"lib{name}.so"
        res = subprocess.run(
            [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-DTFSWA_EMU",
             "-include", str(TESTS / "_cuda_emu.h"), f"-I{CSRC}", "-o", str(lib),
             str(TESTS / "_cuda_emu.cpp"), "-x", "c++", str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(LIBS)) as pool:
        return dict(pool.map(build, LIBS))


@pytest.fixture
def kernels(emulated, monkeypatch):
    """The wrappers' launches on CPU tensors through the emulated libraries:
    the card's checks and stream left out."""
    for name, lib in emulated.items():
        monkeypatch.setitem(_build._loaded, name, lib)
    monkeypatch.setattr(fb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ra, "_check_cuda", lambda *a, **k: None)
    for mod in (fb, ra):
        monkeypatch.setattr(mod, "_on_stream", lambda dev, fn, *a: fn(*a, None))


def _inputs(R, N, C, seed, regime="flat", hid=None):
    """Rows and a RowBlockParams from numpy ``seed``; "clamp": qkv std
    1.44 / sqrt(C) and LN1 scale x6, so that scores pass SCORE_CLAMP."""
    rng = np.random.default_rng(seed)
    hid = 4 * C if hid is None else hid

    def r(*s, sc=0.05):
        return torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))

    qkv_std, ln = (0.05, 1.0) if regime == "flat" else (1.44 / C ** 0.5, 6.0)
    p = RowBlockParams(ln * (1.0 + r(C, sc=0.1)), r(C, sc=0.1), r(C, 3 * C, sc=qkv_std),
                       r(C, C), r(C, sc=0.01), 1.0 + r(C, sc=0.1), r(C, sc=0.1), r(C, hid),
                       r(hid, sc=0.01), r(hid, C), r(C, sc=0.01))
    return r(R, N, C, sc=1.0), p


def _close(got, ref, rel=REL):
    scale = max(float(ref.abs().max()), 1e-30)
    err = float((got - ref).abs().max())
    assert err <= rel * scale, f"max |diff| {err:.3e} over {rel} x {scale:.3e}"


CASES = [(2, 20, 32, "flat", None), (2, 130, 64, "clamp", 96)]   # 2 key tiles, ragged MLP


@pytest.mark.parametrize("R,N,C,regime,hid", CASES)
def test_f32_forward_forms_match_their_plain_versions(kernels, R, N, C, regime, hid):
    x, p = _inputs(R, N, C, seed=N, regime=regime, hid=hid)
    run = fb._forward_kernel(x, p, H)
    out, attn = fb.fused_row_block_reference_parts(x, p, H, qkv=run.qkv)
    _close(run.out, out)
    _close(run.attn, attn)
    ln1_s, ln1_b, w_qkv = fb._block_weights(p, C, H, torch.float32)[:3]
    _close(run.qkv, (fb.layer_norm_f32(x, ln1_s, ln1_b) @ w_qkv).reshape(-1, 3 * C))
    tr = fb._forward_kernel(x, p, H, train=True)
    r_out, r_mid, r_acc, r_den = fb.fused_row_block_train_reference(x, p, H, qkv=tr.qkv)
    for got, ref in ((tr.out, r_out), (tr.mid, r_mid), (tr.attn, r_acc), (tr.den, r_den)):
        _close(got, ref)
    assert torch.equal(tr.out, run.out)          # the same kernels with the den export on
    i8 = fb._forward_kernel(x, p, H, int8=True)
    q3 = i8.qkv.view(R, N, 3 * C)
    (qi, sq), (ki, sk) = fb.quantize_rows(q3[..., :C]), fb.quantize_rows(q3[..., C:2 * C])
    qk = i8.qk.view(R, N, 2 * C).float()
    assert torch.equal(qk[..., :C], qi) and torch.equal(qk[..., C:], ki)
    assert torch.equal(i8.scales, torch.cat([sq.reshape(R, 1), sk.reshape(R, 1)], dim=1))
    out8, attn8 = fb.fused_row_block_int8_reference_parts(x, p, H, qkv=i8.qkv)
    _close(i8.out, out8)
    _close(i8.attn, attn8)
    if regime == "clamp":
        q, k = q3[..., :C].view(R, N, H, -1), q3[..., C:2 * C].view(R, N, H, -1)
        assert float(torch.einsum("rnhd,rmhd->rhnm", q, k).max()) > fb.SCORE_CLAMP


def test_f32_forward_matches_the_jax_kernel(kernels):
    """B1's f32 form against the TPU kernel with cd = float32, interpret mode."""
    x, p = _inputs(2, 24, 32, seed=3)
    jp = JaxParams(**{k: jnp.asarray(v.numpy()) for k, v in p._asdict().items()})
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_fused_row_block(jnp.asarray(x.numpy()), jp, H))
    np.testing.assert_allclose(fb._forward_kernel(x, p, H).out.numpy(), ref,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("R,N,C,regime,hid", CASES)
def test_f32_backward_matches_its_plain_version(kernels, R, N, C, regime, hid):
    x, p = _inputs(R, N, C, seed=N + 1, regime=regime, hid=hid)
    g = torch.from_numpy(np.random.default_rng(N + 2).standard_normal((R, N, C))
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


@pytest.mark.parametrize("C,heads", [(64, 4), (64, 2)])
def test_f32_tensor_core_attention_forms_match_their_plain_versions(kernels, C, heads):
    """The attention forms on the tensor cores (a head of 16 and of 32
    channels: attn_kernel<16>, <32> and the backward's, p . v and the
    gradient products in 3xTF32, the scores FMA chains; B3's scores on the
    int8 tensor-core stand-in) at two key tiles with a ragged last one and
    the clamp weights: B1, B1-train, B3 and B2 against their plain versions
    as in the tests above."""
    R, N = 1, 70
    x, p = _inputs(R, N, C, seed=C + heads, regime="clamp")
    run = fb._forward_kernel(x, p, heads)
    for got, ref in zip((run.out, run.attn),
                        fb.fused_row_block_reference_parts(x, p, heads, qkv=run.qkv)):
        _close(got, ref)
    i8 = fb._forward_kernel(x, p, heads, int8=True)
    for got, ref in zip((i8.out, i8.attn),
                        fb.fused_row_block_int8_reference_parts(x, p, heads, qkv=i8.qkv)):
        _close(got, ref)
    tr = fb._forward_kernel(x, p, heads, train=True)
    for got, ref in zip((tr.out, tr.mid, tr.attn, tr.den),
                        fb.fused_row_block_train_reference(x, p, heads, qkv=tr.qkv)):
        _close(got, ref)
    g = torch.from_numpy(np.random.default_rng(C).standard_normal((R, N, C)).astype(np.float32))
    got = fb._bwd_kernel(x, tr.mid, tr.attn, tr.den, g, p, heads)
    ref = fb.fused_row_block_bwd_reference_parts(x, tr.mid, tr.attn, tr.den, g, p, heads,
                                                 qkv=tr.qkv)
    for a, b in zip((got.dx, *got.dp, got.dqkv), (ref.dx, *ref.dp, ref.dqkv)):
        _close(a, b)


@pytest.mark.parametrize("R,N,C,heads", [(2, 20, 32, 8), (1, 40, 64, 4), (1, 33, 32, 2),
                                         (1, 17, 256, 8), (1, 150, 32, 8), (1, 70, 64, 2)])
def test_f32_row_attention_matches_its_plain_version(kernels, R, N, C, heads):
    """B4 at D = 4, 16 and 32 (score chunks and output parts of W = 4, 16
    and 32 channels; key tiles of 64 and 32), at one key tile and at three
    with a ragged last one (N = 150, 70), peaked scores; its exported q|k
    against x Wq_h / sqrt(D) and x Wk_h in f64."""
    rng = np.random.default_rng(C + heads)
    x, wq, wp, b = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, N, C)), rng.standard_normal((C, 3 * C)) * 1.44 / C ** 0.5,
        rng.standard_normal((C, C)) * 0.05, rng.standard_normal(C) * 0.01))
    out, acc, v, qk = ra._kernel(x, wq, wp, b, heads, export=True)
    r_out, r_acc = ra.flash_row_attention_reference_parts(x, wq, wp, b, heads)
    _close(out, r_out)
    _close(acc, r_acc)
    _close(v, (x @ wq[:, 2 * C:]).reshape(-1, C))
    assert qk.dtype == torch.float64                 # q, k and the scores in f64
    xd = x.double().reshape(-1, C)
    _close(qk[:, :C], xd @ wq[:, :C].double() * (C // heads) ** -0.5, rel=1e-12)
    _close(qk[:, C:], xd @ wq[:, C:2 * C].double(), rel=1e-12)
    assert torch.equal(ra._kernel(x, wq, wp, b, heads)[0], out)   # q|k exported or a scratch


CARD_NAN = 0x7FFFFFFF      # the NaN that the card's f32 arithmetic produces


def _nan_score_inputs(N, C, case, seed):
    """(rows, the rows without the case, parameters, the parameters without
    the case): 4 rows and flat parameters that make head 0's scores NaN
    while v stays finite.  "card_nan": k's channel 0 from a weight of the
    card's NaN bit pattern, so that every score of head 0 is that NaN (the
    CPU's arithmetic keeps a NaN operand's bits).  "overflow": k's channels
    0 and 1 at +inf and -inf in every token of row 1 while q's are finite
    and positive, so that each of its q.k is inf - inf (weights of 2^127 on
    LN1's channel 0, exactly 0 in the other rows, whose tokens sum to 0)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(2, 34, (4, N, C // 2)) / 8.0 * rng.choice([-1.0, 1.0], (4, N, C // 2))
    x = np.concatenate([half, -half], axis=-1).astype(np.float32)
    x[..., 0] = x[..., C // 2] = 0.0
    clean = torch.from_numpy(x.copy())
    _, p = _inputs(1, 1, C, seed)
    s1, b1, w = p.norm1_scale.clone(), p.norm1_bias.clone(), p.qkv_kernel.clone()
    if case == "card_nan":
        p_clean = p
        w.view(torch.int32)[3, C] = CARD_NAN
    else:
        s1[0], b1[0] = 1.0, 0.0
        w[0, :2] = 64.0
        w[0, C], w[0, C + 1] = 2.0 ** 127, -(2.0 ** 127)
        x[1, :, 0], x[1, :, C // 2] = 8.0, -8.0
    p = p._replace(norm1_scale=s1, norm1_bias=b1, qkv_kernel=w)
    return torch.from_numpy(x), clean, p, p if case == "overflow" else p_clean


def _same_nonfinite(got, ref):
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, i
        assert torch.equal(a.isfinite(), b.isfinite()), f"output {i}"


@pytest.mark.parametrize("C,heads", [(32, 8), (64, 2)])
@pytest.mark.parametrize("case", ["card_nan", "overflow"])
def test_f32_kernels_keep_a_nan_score(kernels, C, heads, case):
    """A NaN score where v is finite: p = 2^min(s, 110) must stay NaN, as
    jnp.minimum keeps it (fminf would give p the finite 2^110), and B3's
    row scales NaN where q or k holds a NaN.  B1, B1-train, B3, B2 (on
    B1-train's residuals of the rows and parameters without the case) at a
    head of 4 channels (the CUDA-core forms) and of 32 (the tensor-core
    forms): every output non-finite exactly where the plain f32 version's
    is, and non-finite somewhere.  B4 (no clamp; its running max) the same,
    on its own rows: the card_nan weight, or (overflow) channel 0 of row 1
    at 2^80, so that its scores pass f32's range."""
    N = 20
    x, x0, p, p0 = _nan_score_inputs(N, C, case, seed=C + heads)
    run = fb._forward_kernel(x, p, heads)
    ref = fb.fused_row_block_reference_parts(x, p, heads, qkv=run.qkv)
    _same_nonfinite((run.out, run.attn), ref)
    assert not bool(ref[0].isfinite().all())
    i8 = fb._forward_kernel(x, p, heads, int8=True)
    _same_nonfinite((i8.out, i8.attn),
                    fb.fused_row_block_int8_reference_parts(x, p, heads, qkv=i8.qkv))
    tr = fb._forward_kernel(x, p, heads, train=True)
    _same_nonfinite((tr.out, tr.mid, tr.attn, tr.den),
                    fb.fused_row_block_train_reference(x, p, heads, qkv=tr.qkv))
    clean = fb._forward_kernel(x0, p0, heads, train=True)
    g = torch.from_numpy(np.random.default_rng(C).standard_normal((4, N, C)).astype(np.float32))
    got = fb._bwd_kernel(x, clean.mid, clean.attn, clean.den, g, p, heads)
    ref = fb.fused_row_block_bwd_reference_parts(x, clean.mid, clean.attn, clean.den, g, p,
                                                 heads, qkv=tr.qkv)
    _same_nonfinite((got.dx, *got.dp, got.dqkv), (ref.dx, *ref.dp, ref.dqkv))
    assert not bool(ref.dqkv.isfinite().all())
    xb, wb = x0.clone(), p.qkv_kernel
    if case == "overflow":
        wb = _inputs(1, 1, C, seed=C)[1].qkv_kernel
        xb[1, :, 0] = 2.0 ** 80
    w = (wb, p.proj_kernel, p.proj_bias)
    ref = ra.flash_row_attention_reference_parts(xb, *w, heads)
    _same_nonfinite(ra._kernel(xb, *w, heads)[:2], ref)
    assert not bool(ref[0].isfinite().all())


DMMA_PROBE = r"""
// Each warp of the launch multiplies its own 16 x 4 A by its 4 x 8 B and
// adds its 16 x 8 C through the stand-in of mma.sync m16n8k4 f64, every lane
// loading and storing its fragments at the PTX ISA's layout.
__global__ void probe(const double* a, const double* b, const double* c, double* d) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, j = lane % 4;
    const double* cw = c + w * 128;
    double c0 = cw[g * 8 + 2 * j], c1 = cw[g * 8 + 2 * j + 1];
    double c2 = cw[(g + 8) * 8 + 2 * j], c3 = cw[(g + 8) * 8 + 2 * j + 1];
    emu_mma_m16n8k4_f64(c0, c1, c2, c3, a[w * 64 + g * 4 + j], a[w * 64 + (g + 8) * 4 + j],
                        b[w * 32 + j * 8 + g]);
    double* dw = d + w * 128;
    dw[g * 8 + 2 * j] = c0;
    dw[g * 8 + 2 * j + 1] = c1;
    dw[(g + 8) * 8 + 2 * j] = c2;
    dw[(g + 8) * 8 + 2 * j + 1] = c3;
}

extern "C" void run(const double* a, const double* b, const double* c, double* d, int warps) {
    LAUNCH(probe, 1, 32 * warps, nullptr, a, b, c, d);
}
"""


def test_dmma_stand_in_is_the_plain_16x4_by_4x8_product_at_every_lane(tmp_path):
    """The CPU stand-in of the FP64 tensor cores' mma.sync m16n8k4
    (``tests/_cuda_emu.h``), on which B4's f32 source runs here: each of 4
    warps' 16 x 8 results, every lane's four values, against A @ B + C in
    numpy (f64, sums of 4 products: within 1e-15 of the largest)."""
    src = tmp_path / "probe.cu"
    src.write_text(DMMA_PROBE)
    lib = tmp_path / "libprobe.so"
    res = subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-DTFSWA_EMU", "-include", str(TESTS / "_cuda_emu.h"), "-o", str(lib),
         str(TESTS / "_cuda_emu.cpp"), "-x", "c++", str(src)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rng = np.random.default_rng(4)
    warps = 4
    a, b, c = (rng.standard_normal(s) for s in ((warps, 16, 4), (warps, 4, 8), (warps, 16, 8)))
    d = np.zeros((warps, 16, 8))
    fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    fn(*(t.ctypes.data for t in (a, b, c, d)), warps)
    want = a @ b + c
    assert np.abs(d - want).max() <= 1e-15 * np.abs(want).max()
    swapped = a[:, [*range(8, 16), *range(8)]] @ b + c               # the row halves swapped
    assert not np.allclose(d, swapped)


def test_f32_row_attention_holds_the_f32_limit_where_scores_reach_hundreds(kernels):
    """B4's f32 form against its function in f64, with scores in the
    hundreds (the clamp regime's weights on LN1-like rows).  Its scores run
    in f64, since an f32 score that large is off by tens of its ulp: what
    is left is a few f32 ulp, within a tenth of the f32 limit, 1e-4 x
    max(max|ref| / 4, 1).  (With f32 scores B4 lands at a fifth of the
    limit here, the plain f32 version at a quarter of it.)"""
    R, N, C, heads = 1, 64, 32, 8
    rng = np.random.default_rng(7)
    x, wq, wp, b = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((R, N, C)) * 6.0, rng.standard_normal((C, 3 * C)) * 1.44 / C ** 0.5,
        rng.standard_normal((C, C)) * 0.05, rng.standard_normal(C) * 0.01))
    out, acc, _, _ = ra._kernel(x, wq, wp, b, heads)
    a, wv = ra.bilinear_weights(wq, heads, torch.float64)
    xd, D = x.double(), C // heads
    s = torch.einsum("rnc,hce,rme->rhnm", xd, a, xd)
    assert float(s.max()) > 100.0
    p = torch.softmax(s, dim=-1)
    v = (xd @ wv.double()).view(R, N, heads, D).transpose(1, 2)
    t_acc = (p @ v).transpose(1, 2).reshape(R, N, C)
    t_out = t_acc @ wp.double() + b.double()
    for got, ref in ((out, t_out), (acc, t_acc)):
        tol = 1e-4 * max(float(ref.abs().max()) / 4, 1.0)
        assert float((got.double() - ref).abs().max()) <= tol / 10


class _StandIn:
    """A stand-in library: records each function called, returns 0."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        lib = self

        class Fn:
            argtypes = restype = None

            def __call__(self, *args):
                lib.calls.append(f"{lib.name}.{fn}")
                return 1 << 20 if fn.endswith("scratch_bytes") else 0

        f = Fn()
        setattr(self, fn, f)
        return f


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_route_to_the_library_of_their_dtype(monkeypatch, dtype):
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: _StandIn(name, calls))
    monkeypatch.setattr(fb, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(ra, "_check_cuda", lambda *a, **k: None)
    for mod in (fb, ra):
        monkeypatch.setattr(mod, "_on_stream", lambda dev, fn, *a: fn(*a, None))
    x, p = _inputs(2, 16, 32, seed=1)
    x = x.to(dtype)
    fb._forward_kernel(x, p, H, int8=True)
    fb._bwd_kernel(x, x, x, torch.zeros(2, H, 16), x, p, H)
    ra._kernel(x, p.qkv_kernel, p.proj_kernel, p.proj_bias, H)
    sfx = "_f32" if dtype == torch.float32 else ""
    assert [c for c in calls if "scratch" not in c and "offsets" not in c] == [
        f"fused_block{sfx}.fused_block_forward{sfx}",
        f"fused_block_bwd{sfx}.fused_block_backward{sfx}",
        f"row_attention{sfx}.row_attention_forward{sfx}"]
    before = (fb.fused_row_block_bwd.launches, fb.fused_row_block_bwd.launches_f32)
    fb._count(fb.fused_row_block_bwd, dtype)
    f32 = dtype == torch.float32
    assert (fb.fused_row_block_bwd.launches, fb.fused_row_block_bwd.launches_f32) == (
        before[0] + (not f32), before[1] + f32)


@pytest.mark.parametrize("kernel", ["B1", "B3", "B4"])
def test_float16_rows_are_refused_before_any_launch(kernel):
    _, p = _inputs(2, 16, 32, seed=1)
    rows = FakeCuda((2, 16, 32), torch.float16)
    call = {"B1": lambda: fb.fused_row_block(rows, p, H),
            "B3": lambda: fb.fused_row_block_int8(rows, p, H),
            "B4": lambda: ra.flash_row_attention(rows, p.qkv_kernel, p.proj_kernel,
                                                 p.proj_bias, H)}[kernel]
    with pytest.raises(TypeError, match="bfloat16 or float32, got torch.float16"):
        call()


@pytest.mark.parametrize("path", sorted(FLAGSHIP_PATHS))
@pytest.mark.parametrize("stage", range(4))
def test_f32_shared_memory_rule_admits_the_flagship_shapes(path, stage):
    """The f32 forms' shared memory is static, under 48 KB, at every
    flagship (N, C), for B1 / B2 (any MLP width) and B4 (8 heads: D = C / 8,
    B4's plan W = 4 to 32); and B4's plan (``f32_attn_plan``) admits every
    C a multiple of 8 up to 512 at every head count dividing it."""
    for R, N, C in flagship_row_shapes(path, stage):
        fb.check_shape("fused_row_block", R, N, C, 8, 4 * C, torch.float32)
        ra.check_shape(R, N, C, 8, torch.float32)
        assert fb.kernel_smem_bytes(C, 4 * C, torch.float32) <= fb.STATIC_SMEM_BYTES
        assert ra.kernel_smem_bytes(C, 8, torch.float32) <= fb.STATIC_SMEM_BYTES
        D = C // 8
        assert ra.f32_attn_plan(C, 8) == (D, D, 32 if D == 32 else 64)
    for C in range(8, 513, 8):
        for h in (h for h in range(1, C + 1) if C % h == 0):
            ra.check_shape(2, 17, C, h, torch.float32)
            D = C // h
            w, vw, kt = ra.f32_attn_plan(C, h)
            parts = -(-D // vw)
            assert w in (4, 8, 16, 32) and vw <= w < 2 * vw and vw % 4 == 0
            assert parts == -(-D // 32) and D <= parts * vw < D + 4 * parts
            assert ra.kernel_smem_bytes(C, h, torch.float32) <= fb.STATIC_SMEM_BYTES


# --- the tensor cores' TF32 and int8 products on the CPU stand-in ---------

@pytest.fixture(scope="module")
def mma_probe(tmp_path_factory):
    """MMA_PROBE's ``run``, built once for the module."""
    return _probe(tmp_path_factory.mktemp("mma"), MMA_PROBE)


def _probe(tmp_path, src: str):
    """``src`` (with csrc/ on the include path) built with g++ against the
    CUDA stand-in; its ``run``."""
    cu = tmp_path / "probe.cu"
    cu.write_text(src)
    lib = tmp_path / "libprobe.so"
    res = subprocess.run(
        [shutil.which("g++"), "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-DTFSWA_EMU", "-include", str(TESTS / "_cuda_emu.h"), f"-I{CSRC}", "-o", str(lib),
         str(TESTS / "_cuda_emu.cpp"), "-x", "c++", str(cu)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return ctypes.CDLL(str(lib)).run


MMA_PROBE = r"""
#include "block_f32.cuh"
// Each warp multiplies its own A (16 x K) by its B (K x 8) and adds its C
// (16 x 8), every lane loading and storing its fragments at the PTX ISA's
// layout: mode 0 the TF32 form (K = 8, operands as given), 1 its 3xTF32
// (f32::mma3 on f32::split_tf32 of each operand), 2 one TF32 pass of the
// split's big parts; 3 the int8 form (K = 32, A and B int8 as floats).
__global__ void probe(const float* a, const float* b, const float* c, float* d, int mode) {
    const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int K = mode == 3 ? 32 : 8;
    const float* aw = a + w * 16 * K;
    const float* bw = b + w * K * 8;
    const float* cw = c + w * 128;
    float acc[4];
    int iacc[4];
    for (int e = 0; e < 4; ++e) {
        acc[e] = cw[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)];
        iacc[e] = (int)acc[e];
    }
    if (mode == 3) {
        uint32_t fa[4], fb[2];
        for (int i = 0; i < 4; ++i) {
            uint32_t word = 0;
            for (int u = 0; u < 4; ++u)
                word |= (uint32_t)(uint8_t)(int8_t)aw[(g + 8 * (i & 1)) * K + 4 * t + 16 * (i >> 1) + u] << (8 * u);
            fa[i] = word;
        }
        for (int i = 0; i < 2; ++i) {
            uint32_t word = 0;
            for (int u = 0; u < 4; ++u)
                word |= (uint32_t)(uint8_t)(int8_t)bw[(4 * t + 16 * i + u) * 8 + g] << (8 * u);
            fb[i] = word;
        }
        f32::mma_s8(iacc, fa, fb);
        for (int e = 0; e < 4; ++e) acc[e] = (float)iacc[e];
    } else {
        uint32_t fa[2][4], fb[2][2];
        for (int i = 0; i < 4; ++i)
            f32::split_tf32(aw[(g + 8 * (i & 1)) * K + t + 4 * (i >> 1)], fa[0][i], fa[1][i]);
        for (int i = 0; i < 2; ++i) f32::split_tf32(bw[(t + 4 * i) * 8 + g], fb[0][i], fb[1][i]);
        if (mode == 0) {
            for (int i = 0; i < 4; ++i) fa[0][i] = __float_as_uint(aw[(g + 8 * (i & 1)) * K + t + 4 * (i >> 1)]);
            for (int i = 0; i < 2; ++i) fb[0][i] = __float_as_uint(bw[(t + 4 * i) * 8 + g]);
        }
        if (mode == 1) f32::mma3(acc, fa, fb);
        else f32::mma_tf32(acc, fa[0], fb[0]);
    }
    float* dw = d + w * 128;
    for (int e = 0; e < 4; ++e) dw[(g + 8 * (e >> 1)) * 8 + 2 * t + (e & 1)] = acc[e];
}

extern "C" void run(const float* a, const float* b, const float* c, float* d, int warps, int mode) {
    LAUNCH(probe, 1, 32 * warps, nullptr, a, b, c, d, mode);
}
"""


def _mma(run, a, b, c, mode):
    d = np.zeros(c.shape, np.float32)
    a, b, c = (np.ascontiguousarray(x, np.float32) for x in (a, b, c))
    run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    run(a.ctypes.data, b.ctypes.data, c.ctypes.data, d.ctypes.data, a.shape[0], mode)
    return d


def _tf32(x):
    """cvt.rna.tf32.f32 in numpy: to nearest, ties away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


@pytest.mark.parametrize("mode", ["tf32", "int8"])
def test_tensor_core_stand_ins_are_the_plain_products_at_every_lane(mma_probe, mode):
    """The CPU stand-ins of mma.sync m16n8k8 TF32 and m16n8k32 int8
    (``tests/_cuda_emu.h``), on which the f32 sources run here: each of 4
    warps' 16 x 8 results, every lane's four values, against A @ B + C in
    numpy (TF32 operands: exact products, f32 sums of 8, within 1e-6 of the
    largest; int8: exact); the result with the row halves of A swapped is
    not it."""
    run = mma_probe
    rng = np.random.default_rng(5)
    warps = 4
    if mode == "tf32":
        a = _tf32(rng.standard_normal((warps, 16, 8)))
        b = _tf32(rng.standard_normal((warps, 8, 8)))
        c = rng.standard_normal((warps, 16, 8)).astype(np.float32)
        d = _mma(run, a, b, c, 0)
        want = a.astype(np.float64) @ b + c
        assert np.abs(d - want).max() <= 1e-6 * np.abs(want).max()
    else:
        a = rng.integers(-128, 128, (warps, 16, 32)).astype(np.float32)
        b = rng.integers(-128, 128, (warps, 32, 8)).astype(np.float32)
        c = rng.integers(-1000, 1000, (warps, 16, 8)).astype(np.float32)
        d = _mma(run, a, b, c, 3)
        want = a.astype(np.int64) @ b.astype(np.int64) + c.astype(np.int64)
        assert np.array_equal(d.astype(np.int64), want)
    swapped = a[:, [*range(8, 16), *range(8)]].astype(np.float64) @ b + c
    assert not np.allclose(d, swapped)


def test_3xtf32_keeps_f32s_accuracy_where_one_tf32_pass_does_not(mma_probe):
    """The f32 tile's product (``f32::mma3`` on ``f32::split_tf32``,
    csrc/block_f32.cuh) on full-mantissa f32 operands against the f64
    product: within 2^-20 of sum |a_k b_k| at every element (f32's own
    error for sums of 8 is 8 x 2^-24 of it; the split leaves up to about
    5 x 2^-22), while one TF32 pass of the big parts (what the f32_1xtf32 plant
    leaves) is off by more than 100 times that somewhere."""
    run = mma_probe
    rng = np.random.default_rng(6)
    warps = 4
    a = (rng.standard_normal((warps, 16, 8)) * 3.0).astype(np.float32)
    b = (rng.standard_normal((warps, 8, 8)) * 3.0).astype(np.float32)
    c = np.zeros((warps, 16, 8), np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    three = np.abs(_mma(run, a, b, c, 1) - want) / scale
    one = np.abs(_mma(run, a, b, c, 2) - want) / scale
    assert three.max() <= 2.0 ** -20
    assert one.max() > 100 * 2.0 ** -20


def _three_pass(a, b):
    """The 3xTF32 product of two f32 scalars as the tile sums it: the small
    parts truncated to TF32 (as the tensor cores read them), the small
    terms first, each product exact, each sum rounded to f32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = ((np.float32(x) - xb).view(np.uint32) & np.uint32(0xffffe000)
               for x, xb in ((a, ab), (b, bb)))
    as_, bs = as_.view(np.float32), bs.view(np.float32)
    x = np.float32(np.float64(as_) * np.float64(bb))
    x = np.float32(np.float64(x) + np.float64(ab) * np.float64(bs))
    return np.float32(np.float64(x) + np.float64(ab) * np.float64(bb))


@pytest.mark.parametrize("C,heads", [(32, 8), (32, 2), (64, 2), (128, 1)])
def test_f32_attention_backward_takes_the_plain_sides_of_the_clamp(kernels, emulated, C,
                                                                   heads):
    """Scores planted at SCORE_CLAMP: head 0's q and k have one channel, q
    = a for every query and k_j = 110 / a stepped by single f32 ulps, with
    a chosen so that some exact product a k_j lies within 2^-18 of 110.
    The f32 scores straddle the clamp (some round below 110, some to 110 or
    above), and a 3xTF32 score would put at least one on the other side;
    d_s jumps there by d_p p ln 2 (p = 2^110).  At each form of the
    attention backward: D = 4 (the CUDA-core attn_bwd_{q,kv}_ffma_kernel),
    16 and 32 (attn_bwd_{q,kv}_kernel on the tensor cores) and 128 (its
    wide form).  The attention backward alone
    (fused_block_attn_backward_f32) against the plain version fed the same
    q|k|v, d_oe and d_den: d_q, d_k and d_v within 1e-5 of their largest
    magnitude, so every pair took the plain version's side."""
    R, N, D = 1, 24, C // heads
    rng = np.random.default_rng(11)
    qkv = (rng.standard_normal((R * N, 3 * C)) * 0.3).astype(np.float32)
    d_oe = rng.standard_normal((R * N, C)).astype(np.float32)
    d_den = rng.standard_normal((R * N, heads)).astype(np.float32)
    steps = np.arange(-6, 7, dtype=np.int32)
    for a in np.linspace(9.0, 12.0, 400, dtype=np.float32):
        k = (np.float32(110.0) / a).view(np.int32) + np.resize(steps, N)
        k = k.view(np.float32)
        exact = np.float64(a) * k.astype(np.float64)
        s = exact.astype(np.float32)
        three = np.array([_three_pass(a, kj) for kj in k])
        if (np.abs(exact - 110.0).min() <= 2.0 ** -18 and (s < 110).any() and (s >= 110).any()
                and ((three < 110) != (s < 110)).any()):
            break
    else:
        pytest.fail("no a plants a score at the clamp")
    qkv[:, 0:D] = 0.0
    qkv[:, C:C + D] = 0.0
    qkv[:, 0] = a
    qkv[:, C] = k
    got = torch.zeros(R * N, 3 * C)
    fn = emulated["fused_block_bwd_f32"].fused_block_attn_backward_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    t = [torch.from_numpy(x) for x in (qkv, d_oe, d_den)]
    assert fn(*(x.data_ptr() for x in t), got.data_ptr(), R, N, C, heads, None) == 0
    x, p = _inputs(R, N, C, seed=1)
    ref = fb.fused_row_block_bwd_reference_parts(
        x, x, x, torch.ones(R, heads, N), x, p, heads, qkv=t[0],
        d_oe=t[1].view(R, N, C), d_den=t[2].view(R, N, heads))
    want = ref.dqkv.view(R * N, 3 * C)
    for part in range(3):
        cols = slice(part * C, (part + 1) * C)
        _close(got[:, cols], want[:, cols])
    assert float(want[:, :C].abs().max()) > 1e30                  # p = 2^110 reached d_q
