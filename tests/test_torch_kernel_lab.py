"""The port's kernel lab against the JAX package's ``tools/kernel_lab.py``.

``lab_row_block_reference`` (the plain PyTorch version of the lab forms of
the CUDA kernel, and what the wrapper runs on a CPU tensor) must compute
what the JAX lab's ``_call_kernel(_kernel_prod, ...)`` forms compute, run in
interpret mode as the JAX package's own tests run its Pallas kernels on
the CPU; the port's variants (``tfswa_tpu_torch.tools.kernel_lab``) what the
JAX tool's variants compute.  The JAX tool is loaded from its file.

Tolerances: f32 atol = rtol = 2e-5 (the same arithmetic in f32, sums in
another order; tests/test_torch_fused_block.py); bf16 2 bf16 ULP,
elementwise (an f32 sum in another order now and then flips one bf16
rounding).  The ULP is that of the reference, and for a form whose output
is the block's residual sum (stages attn and full, and every variant) that
of the larger of the reference and the block's input at the element: a
flipped rounding inside moves the sum by the ULP of its terms, and where
x + attention cancels, that is many ULP of the sum (16 seen for stage
attn).  The score_bf16 forms (exp2bf16, sbf16) round the score to bf16
inside, where a one-f32-ULP difference in a score can flip it, so on f32
rows too they are held to the bf16 limit (0.32 bf16 ULP seen).
"""
import importlib.util
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models.attention import RowBlockParams as JaxParams
from tfswa_tpu.ops.pallas.fused_block import fused_row_block as jax_fused_row_block
from tfswa_tpu_torch.models.attention import RowBlockParams
from tfswa_tpu_torch.ops.lab_block import (STAGES, lab_row_block, lab_row_block_parts,
                                           lab_row_block_reference)
from tfswa_tpu_torch.tools import kernel_lab

_spec = importlib.util.spec_from_file_location(
    "jax_kernel_lab", Path(__file__).resolve().parent.parent / "tools" / "kernel_lab.py")
jlab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jlab)

R, N, C, H = 3, 64, 32, 8
# the JAX tool's variants that are not B1 or the plain block
LAB_VARIANTS = ["exp2bf16", "sbf16", "d16", "d4", "wofold", "ptf32", "noclamp", "hpair",
                "nopair"]


def row_block_params_from_jax(p) -> RowBlockParams:
    """The JAX package's ``RowBlockParams`` -> the port's, float32 tensors in
    the same (in, out) layout."""
    return RowBlockParams(*(torch.from_numpy(np.array(getattr(p, name), dtype=np.float32))
                            for name in RowBlockParams._fields))


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, qkv_scale=0.25, n=N):
    """Rows and JAX parameters (LN scales and biases not 1 and 0; qkv std
    ``qkv_scale``: 0.25 gives scores of std ~3, a peaked softmax)."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((R, n, C)).astype(np.float32)

    def r(*s, sc=0.05):
        return jnp.asarray(rng.standard_normal(s) * sc, jnp.float32)

    p = JaxParams(norm1_scale=1.0 + r(C, sc=0.1), norm1_bias=r(C, sc=0.1),
                  qkv_kernel=r(C, 3 * C, sc=qkv_scale), proj_kernel=r(C, C),
                  proj_bias=r(C, sc=0.01), norm2_scale=1.0 + r(C, sc=0.1),
                  norm2_bias=r(C, sc=0.1), fc1_kernel=r(C, 4 * C),
                  fc1_bias=r(4 * C, sc=0.01), fc2_kernel=r(4 * C, C), fc2_bias=r(C, sc=0.01))
    return rows, p


def _both_rows(rows, dtype):
    jdt, tdt = DTYPES[dtype]
    rj = jnp.asarray(rows, jdt)
    return rj, torch.from_numpy(np.array(rj, np.float32)).to(tdt)


def _assert_close(got: torch.Tensor, ref, dtype, rows=None, bf16_inside=False):
    """Within the module's tolerance; ``rows``: the block's input, for a
    residual output; ``bf16_inside``: a form that rounds to bf16 inside."""
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32" and not bf16_inside:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
        return
    mag = np.abs(ref) if rows is None else np.maximum(np.abs(ref), np.abs(rows.float().numpy()))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0 ** -20))) - 7)
    bad = np.abs(got - ref) > 2 * ulp
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], ref[bad][:5])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(stage, dtype):
    rows, jp = _inputs(seed=STAGES.index(stage))
    rj, rt = _both_rows(rows, dtype)
    ref = jlab.block_stage(stage, rj, jp, H)
    got = lab_row_block_reference(rt, row_block_params_from_jax(jp), H, stage)
    assert got.dtype == rt.dtype
    _assert_close(got, ref, dtype, rows=rt if stage in ("attn", "full") else None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", LAB_VARIANTS)
def test_variant_matches_jax(name, dtype):
    rows, jp = _inputs(seed=10 + LAB_VARIANTS.index(name))
    rj, rt = _both_rows(rows, dtype)
    ref = jlab.VARIANTS[name](rj, jp, H)
    with torch.no_grad():
        got = kernel_lab.VARIANTS[name](rt, row_block_params_from_jax(jp), H)
    _assert_close(got, ref, dtype, rows=rt, bf16_inside=name in ("exp2bf16", "sbf16"))


@pytest.mark.parametrize("name", ["noclamp", "exp2bf16"])
def test_clamp_regime_matches_jax(name):
    """Scores past SCORE_CLAMP (and, without the clamp, past 128, where
    exp2 overflows): the same values, and non-finite values at the same
    places (assert_allclose compares NaN and inf positions).  B1 itself
    there: tests/test_torch_fused_block.py."""
    rows, jp = _inputs(seed=30, qkv_scale=2.0, n=37)
    rj, rt = _both_rows(rows, "float32")
    ref = np.asarray(jlab.VARIANTS[name](rj, jp, H))
    got = kernel_lab.VARIANTS[name](rt, row_block_params_from_jax(jp), H).numpy()
    if name == "noclamp":
        assert not np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=2e-5)


@pytest.mark.parametrize("n,c,heads", [(72, 32, 8), (16, 24, 3)])
def test_hpair_guard(n, c, heads):
    """hpair refuses 2N > 128 and an odd head count, as the JAX form."""
    rows = np.zeros((2, n, c), np.float32)
    with pytest.raises(ValueError, match="hpair"):
        jlab.block_hpair(jnp.asarray(rows), None, heads)
    with pytest.raises(ValueError, match="hpair"):
        kernel_lab.block_hpair(torch.from_numpy(rows), None, heads)


@pytest.mark.parametrize("name", LAB_VARIANTS)
def test_lab_variants_raise_under_grad(name):
    """The JAX forms have no gradient (no differentiation rule for the
    Pallas kernel's reciprocal); the port's raise too."""
    rows, jp = _inputs(seed=40)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda r: jnp.sum(jlab.VARIANTS[name](r, jp, H)))(jnp.asarray(rows))
    with pytest.raises(RuntimeError, match="no gradient"):
        kernel_lab.grad_call(kernel_lab.VARIANTS[name], torch.from_numpy(rows),
                             row_block_params_from_jax(jp), H)


@pytest.mark.parametrize("stage", STAGES)
def test_lab_stages_raise_under_grad(stage):
    rows, jp = _inputs(seed=41)
    x = torch.from_numpy(rows).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        lab_row_block(x, row_block_params_from_jax(jp), H, stage)


def test_prod_gradient_matches_jax():
    """--grad's prod: autograd through fused_row_block (B1-train and B2,
    their plain versions here) against jax.grad through the JAX package's
    fused_row_block, f32, each leaf within 1e-4 of its largest value."""
    rows, jp = _inputs(seed=42, n=24)
    ref = jax.grad(lambda r, p: jnp.sum(jnp.square(jax_fused_row_block(r, p, H))),
                   argnums=(0, 1))(jnp.asarray(rows), jp)
    ref = [ref[0]] + list(ref[1])
    got = kernel_lab.grad_call(kernel_lab.VARIANTS["prod"], torch.from_numpy(rows),
                               row_block_params_from_jax(jp), H)
    assert len(got) == len(ref) == 12
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30)


def _cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = kernel_lab.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_check_on_cpu():
    """--check --device cpu: every variant within the block limit of the
    plain block; the last line is the launch counts, all 0 on the CPU."""
    rc, lines = _cli(["--check", "--device", "cpu", "--variants",
                      ",".join(kernel_lab.VARIANTS)])
    assert rc == 0
    checked = [ln for ln in lines if ln.endswith(" ok")]
    assert len(checked) == len(kernel_lab.VARIANTS) - 1
    counts = json.loads(lines[-1])["launches"]
    assert counts["lab_row_block"] == 0 and set(counts.values()) == {0}


def test_cli_ablate_prints_each_stage(monkeypatch):
    rc, lines = _cli(["--ablate", "--device", "cpu", "--iters", "1",
                      "--custom", "tiny:2,16,32,8"])
    assert rc == 0
    assert all(f" {s} " in lines[1] for s in STAGES) and lines[1].count("(+") + \
        lines[1].count("(-") == len(STAGES) - 1
    # with no card it refuses, rather than run elsewhere
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_lab.main(["--ablate"]) == 2


@pytest.mark.parametrize("grad", [False, True])
def test_cli_timing_exit_code(monkeypatch, grad):
    """Timing mode: the refusals the JAX tool has too (hpair's guard at
    2N > 128; under --grad the lab forms) print FAILED and exit 0; any other
    failure, such as a failed launch, prints FAILED and exits 1."""
    argv = ["--device", "cpu", "--iters", "1", "--custom", "tiny:2,80,32,8",
            "--variants", "prod,hpair,ptf32"] + (["--grad"] if grad else [])
    rc, lines = _cli(argv)
    assert rc == 0 and lines[1].count("FAILED") == (2 if grad else 1)

    def launch_fails(rows, p, num_heads):
        raise RuntimeError("fused_block_lab_forward (stage full, flags 2) failed: "
                           "CUDA error 700")

    monkeypatch.setitem(kernel_lab.VARIANTS, "ptf32", launch_fails)
    rc, lines = _cli(argv)
    assert rc == 1 and lines[1].count("FAILED") == 2


def test_wrapper_counts_no_launch_on_cpu():
    rows, jp = _inputs(seed=43)
    before = lab_row_block.launches
    with torch.no_grad():
        lab_row_block(torch.from_numpy(rows), row_block_params_from_jax(jp), H, "av")
    assert lab_row_block.launches == before


@pytest.mark.parametrize("kw,err", [
    (dict(stage="softmax"), "stage"),
    (dict(stage="av", p_f32=True), "flags"),
    (dict(stage="scores", clamp=False), "flags"),
])
def test_wrapper_refuses_unknown_forms(kw, err):
    rows, jp = _inputs(seed=44)
    with pytest.raises(ValueError, match=err):
        lab_row_block(torch.from_numpy(rows), row_block_params_from_jax(jp), H, **kw)


def test_wrapper_refuses_off_cpu_and_wrong_cuda_input():
    """A tensor on another device raises; so does a CUDA tensor that is not
    bf16 (a stand-in object, since this machine has no card): no fallback
    to the plain version."""
    rows, jp = _inputs(seed=45)
    p = row_block_params_from_jax(jp)
    with pytest.raises(ValueError, match="no kernel"):
        lab_row_block(torch.from_numpy(rows).to("meta"), p, H)

    class FakeCuda:
        device = torch.device("cuda", 0)
        dtype = torch.float32
        requires_grad = False
        shape = (R, N, C)

    with pytest.raises(TypeError, match="bfloat16"):
        lab_row_block(FakeCuda(), p, H, "exp2")
    with pytest.raises(ValueError, match="N >= C"):
        lab_row_block_parts(torch.zeros(2, 3, 32), p, H, "exp2")
