"""The port's measuring tools (``tfswa_tpu_torch/tools/``: forward_ablation,
bench_pipeline, bench_train_ablate, bench_train, geom_probe,
bench_ola_windows, bench_device_rate, bench_block, bench_attention) against
the JAX package's ``tools/`` (loaded from their files).

Held on the CPU at small sizes (a small model, n_fft 256 / hop 64 at 8
kHz), with the same seeded inputs and the JAX model on the port model's
weights (``weights.py``):
  - the tables and deterministic parts exactly: the stage shapes, the
    shape lists, bench_block's seeded parameters, the OLA sweep's
    ``ola_window_segments`` for each geometry;
  - the identity arm's forward, the pipeline's STFT, forward and mask +
    iSTFT, and the train ablation's ``fwd`` loss within 1e-5 (f32 sums in
    another order through a few convolutions; the shift-mask tests' limit);
  - every CLI's exit code 2 with no card, and each tool's timing parts on
    the CPU at a small size: finite positive numbers, no kernel launch.
"""
import importlib.util
import io
import json
import math
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tfswa_tpu.models.attention as jax_attn
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.masking import apply_trainer_masks as jax_trainer_masks
from tfswa_tpu.ops.masking import trainer_masked_complex as jax_masked_complex
from tfswa_tpu.ops.stft import STFTProcessor as JaxSTFT
from tfswa_tpu.training.losses import source_separation_loss as jax_loss
from tfswa_tpu_torch.config import Config, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.tools import (_common, bench_attention, bench_block, bench_device_rate,
                                   bench_ola_windows, bench_pipeline, bench_train,
                                   bench_train_ablate, forward_ablation, geom_probe)
from tfswa_tpu_torch.training.train_state import create_train_state, make_train_step
from tfswa_tpu_torch.weights import variables_from_state_dict

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
SR, N_FFT, HOP = 8000, 256, 64
TOOLS = (forward_ablation, bench_pipeline, bench_train_ablate, bench_train, geom_probe,
         bench_ola_windows, bench_device_rate, bench_block, bench_attention)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound tests from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    """The small port model (f32, weights from seed 0, convs x0.4 so that the
    sigmoid head does not saturate, as tests/_torch_small_model.py) and the
    JAX model on its weights."""
    model = TFSWAUNet(4, 4, generator=torch.Generator().manual_seed(0), **SMALL).eval()
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dim() == 4:
                t.mul_(0.4)
    variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(model.state_dict(), SMALL["depths"]))
    return model, JaxUNet(in_channels=4, out_channels=4, **SMALL), variables


def _procs():
    return (STFTProcessor(STFTConfig(n_fft=N_FFT, hop_length=HOP, sample_rate=SR)),
            JaxSTFT(JaxSTFTConfig(n_fft=N_FFT, hop_length=HOP, sample_rate=SR)))


def _close(got, ref, tol=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=tol * max(np.abs(ref).max(), 1.0), rtol=0)


# ------------------------------------------------------------- tables and parts

@pytest.mark.parametrize("F,T", [(1025, 862), (1024, 768), (129, 20)])
def test_geom_probe_stage_shapes_equal_jax(F, T):
    jgp = _jax_tool("geom_probe")
    assert geom_probe.stage_shapes(F, T) == jgp.stage_shapes(F, T)
    assert geom_probe.stage_shapes(F, T, B=2) == jgp.stage_shapes(F, T, B=2)


def test_shape_tables_equal_jax():
    assert bench_block.SHAPES == _jax_tool("bench_block").SHAPES
    assert bench_attention.SHAPES == _jax_tool("bench_attention").SHAPES


def test_bench_block_params_equal_jax():
    """Rows, then parameters, from numpy seed 0, the JAX tool's draws."""
    jbb = _jax_tool("bench_block")
    rows, p = bench_block.shape_inputs(3, 5, 16, torch.float32, "cpu")
    rng = np.random.default_rng(0)
    jrows = rng.standard_normal((3, 5, 16))
    jp = jbb.make_params(16, rng, jnp.float32)
    np.testing.assert_array_equal(rows.numpy(), jrows.astype(np.float32))
    for name in p._fields:
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(jp, name)))


def test_identity_arm_forward_matches_jax(small):
    """forward_ablation's identity arm (every row block returns its rows)
    against the JAX tool's patched model, and the full arm moved by it."""
    model, jm, variables = small
    x = np.random.default_rng(1).standard_normal((2, 4, 33, 20)).astype(np.float32)
    with forward_ablation.attention_as_identity():
        got = forward_ablation.forward(model, torch.from_numpy(x))
    orig = jax_attn.row_transformer_block
    jax_attn.row_transformer_block = lambda rows, p, num_heads, **kw: rows
    try:
        ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, jnp.asarray(x))
    finally:
        jax_attn.row_transformer_block = orig
    _close(got.numpy(), ref)
    full = forward_ablation.forward(model, torch.from_numpy(x))
    assert float((full - got).abs().max()) > 1e-4


def test_pipeline_parts_match_jax(small):
    model, jm, variables = small
    proc, jproc = _procs()
    S = SR // 4
    wav = np.random.default_rng(2).standard_normal((1, 2, S)).astype(np.float32)
    spec = bench_pipeline.stft_part(proc, torch.from_numpy(wav))
    jspec = jproc.stft(jnp.asarray(wav))
    _close(spec.numpy(), jspec)
    out = bench_pipeline.forward_part(model, proc, spec)
    jout = jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                              jproc.to_model_input(jspec))
    _close(out.numpy(), jout)
    audio = bench_pipeline.mask_istft_part(proc, out, spec, S)
    mono = jnp.mean(jspec, axis=1)
    jaudio = jproc.istft(jax_masked_complex(jout, jnp.abs(mono), jnp.angle(mono), 2), length=S)
    _close(audio.numpy(), jaudio)


def _small_cfg():
    cfg = Config()
    cfg.model.depths, cfg.model.dims = SMALL["depths"], SMALL["dims"]
    cfg.model.window_size, cfg.model.shift_size = SMALL["window_size"], SMALL["shift_size"]
    cfg.model.num_heads = SMALL["num_heads"]
    cfg.stft = STFTConfig(n_fft=N_FFT, hop_length=HOP, sample_rate=SR)
    cfg.train.use_mrstft = False
    return cfg


def test_train_ablation_fwd_loss_matches_jax():
    """The fwd variant's loss against the JAX tool's loss_value (its code
    in the JAX package's terms), train-mode BatchNorm, same weights and
    batch."""
    cfg = _small_cfg()
    model, state = create_train_state(cfg, device="cpu")
    proc, jproc = _procs()
    mix, targets = bench_train_ablate.make_batch(2, SR // 4, "cpu")
    loss = float(bench_train_ablate.variants(state, proc, mix, targets)["fwd"]())
    jm = JaxUNet(in_channels=4, out_channels=4, **SMALL)
    v = variables_from_state_dict(model.state_dict(), SMALL["depths"])

    @jax.jit
    def jax_loss_value(params, batch_stats, mixtures, targets):
        jspec = jproc.stft(mixtures)
        out, _ = jm.apply({"params": params, "batch_stats": batch_stats},
                          jproc.to_model_input(jspec), train=True, mutable=["batch_stats"])
        pred = jax_trainer_masks(out, jnp.abs(jnp.mean(jspec, axis=1)), 2)
        tmags = {k: jnp.abs(jnp.mean(jproc.stft(t), axis=1)) for k, t in targets.items()}
        return jax_loss({k: pred[:, i] for i, k in enumerate(bench_train_ablate.STEMS)},
                        tmags, use_mrstft=False)["total_loss"]

    ref = float(jax_loss_value(v["params"], v["batch_stats"], jnp.asarray(mix.numpy()),
                               {k: jnp.asarray(t.numpy()) for k, t in targets.items()}))
    assert abs(loss - ref) <= 1e-5 * abs(ref)


@pytest.mark.parametrize("bucket,seg,overlap", [(60.0, 10.0, 0.25), (121.0, 10.0, 0.25),
                                                (30.0, 6.0, 0.5), (8.0, 10.0, 0.25),
                                                (45.0, 3.0, 0.0)])
def test_ola_window_segments_equal_jax(small, bucket, seg, overlap):
    model = small[0]
    proc, jproc = _procs()
    sep = bench_ola_windows.separator(model, proc, bucket, seg, 8, "float16", overlap, "full",
                                      "cpu")
    jsep = JaxSeparator(small[1], None, jproc, segment_length=seg, overlap=overlap,
                        segment_batch=8, transfer_dtype="float16", device_ola=True,
                        ola_bucket_seconds=bucket)
    assert sep.ola_window_segments == jsep.ola_window_segments


# ------------------------------------------------------------------- the CLIs

@pytest.mark.parametrize("tool", TOOLS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cli_exits_2_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _positive(d, keys):
    for k in keys:
        assert math.isfinite(d[k]) and d[k] > 0, (k, d[k])


def test_timing_parts_run_on_the_cpu(small):
    """Each tool's timing part on the small model at 8 kHz: finite positive
    times and rates, and no kernel launch (the plain versions)."""
    model = small[0]
    proc = _procs()[0]
    before = _common.counts()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 33, 16))
                         .astype(np.float32))
    res = forward_ablation.forward_arms(model, x, 1)
    _positive(res, ("full_ms", "identity_ms"))
    assert res["launches"] == {"full": {}, "identity": {}}
    wav = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 2, SR // 4))
                           .astype(np.float32))
    _positive(bench_pipeline.pipeline_times(model, proc, wav, 1),
              ("stft_ms", "forward_ms", "mask_istft_ms", "d2h_ms", "audio_s_per_s"))
    audio = bench_ola_windows.track(2.0, SR)
    rows = bench_ola_windows.sweep(model, proc, audio, [(1.0, 0.5, 4, "float16", 0.25)], 1,
                                   "full", "cpu")
    assert rows[0]["K"] == 2 and rows[0]["audio_s_per_s"] > 0
    sep = bench_ola_windows.separator(model, proc, 1.0, 0.5, 4, "float16", 0.25, "full", "cpu")
    rates = bench_device_rate.rates(sep, 2, 1)
    _positive(rates, ("device_only_audio_s_per_s", "wall_audio_s_per_s"))
    assert _common.counts() == before


def test_train_parts_run_on_the_cpu():
    cfg = _small_cfg()
    model, state = create_train_state(cfg, device="cpu")
    proc = _procs()[0]
    mix, targets = bench_train_ablate.make_batch(1, SR // 4, "cpu")
    with redirect_stdout(io.StringIO()):
        res = bench_train_ablate.ablate(state, proc, mix, targets, 1)
    _positive(res, [f"{k}_ms" for k in ("pre", "fwd", "fwdbwd", "opt", "full")])
    step = make_train_step(model, proc, stems=bench_train_ablate.STEMS)
    thr = bench_train.throughput(state, step, mix, targets, 1, 0.25)
    _positive(thr, ("step_time_ms", "steps_per_sec", "audio_sec_per_sec"))
    assert bench_train.step_flops(model, proc, mix) > 0


def test_kernel_benches_run_on_the_cpu(monkeypatch):
    """bench_block (with --check), bench_attention and geom_probe's probe
    at small shapes, in one JSON line each."""
    monkeypatch.setattr(bench_block, "SHAPES", [("tiny", 3, 16, 32, 8)])
    monkeypatch.setattr(bench_attention, "SHAPES", [("tiny", 3, 16, 32, 8)])
    for tool, argv in ((bench_block, ["--check", "--iters", "1", "--dtype", "float32"]),
                       (bench_attention, ["--iters", "1"])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert tool.main(argv + ["--device", "cpu"]) == 0
        out = json.loads(buf.getvalue().splitlines()[-1])["shapes"][0]
        assert all(out[k] > 0 for k in out if k.endswith("_ms"))
    assert out["pallas_tflops"] > 0
    monkeypatch.setattr(geom_probe, "stage_shapes",
                        lambda F, T: [("s0 tsa", 2, 16, 32, 4), ("s3 swa", 1, 64, 256, 2)])
    with redirect_stdout(io.StringIO()):
        res = geom_probe.probe(("tiny", 16, 16, 1.0), 1, "cpu")
    assert res["total_ms"] > 0 and len(res["shapes"]) == 2


# ------------------------------------------------ chip_smoke.py's tools phase

@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_tools", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tools_phase_runs_the_nine_tools_at_minimal_repeats(chip_smoke):
    runs = dict(chip_smoke.TOOL_RUNS)
    assert set(runs) == {m.__name__.rsplit(".", 1)[-1] for m in TOOLS}
    assert runs["forward_ablation"][:4] == ["--batch", "8", "--seconds", "10"]
    assert runs["bench_ola_windows"][:3] == ["--buckets", "60", "121"]
    assert "--check" in runs["bench_block"]


def test_tool_problems_hold_the_launches_to_the_design(chip_smoke):
    """A forward_ablation and a bench_train line as the card prints them
    pass; a missing launch, an extra kernel or a non-positive time do not."""
    want = {"forward": chip_smoke.forward_launches(),
            "step_remat": chip_smoke.step_launches(remat=True)}
    assert want == {"forward": 66, "step_remat": {"B1-train": 132, "B2": 66}}
    good = {"full_ms": 500.0, "identity_ms": 200.0,
            "launches": {"full": {"B1": 66.0}, "identity": {}}}
    assert chip_smoke.tool_problems("forward_ablation", good, want) == []
    bad = dict(good, identity_ms=0.0, launches={"full": {"B1": 66.0}, "identity": {"B1": 1.0}})
    assert len(chip_smoke.tool_problems("forward_ablation", bad, want)) == 2
    step = {"step_time_ms": 700.0, "steps_per_sec": 1.4, "audio_sec_per_sec": 34.0,
            "mfu": 0.02, "launches": {"B1-train": 132.0, "B2": 66.0}}
    assert chip_smoke.tool_problems("bench_train", step, want) == []
    step["launches"] = {"B1-train": 66.0, "B2": 66.0}
    assert chip_smoke.tool_problems("bench_train", step, want)
