"""The port's headline benchmark, ``python -m tfswa_tpu_torch.bench``,
against the JAX package's root ``bench.py``, on the CPU.

Held:
  - its separator, STFT, track and statistic settings equal the root
    bench.py's, read from that file's source with ``ast`` (they live inside
    its ``main``, which imports JAX and is not run here), and its separator
    knobs equal ``EvalConfig.fast_serving()`` in both packages;
  - at a small model (depths (1, 1, 1, 1), dims (8, 16, 32, 64)) and a 12 s
    track, with the STFT cut to 1 kHz and n_fft 128 / hop 64 (a 10 s segment
    of 64 x 157 bins, not 1024 x 862) and every separator knob bench.py's, the
    port's bench separator and the JAX SourceSeparator with bench.py's
    knobs agree on every stem: the same weights (``weights.py``), the plain
    route on both sides, float16 transfers; within 1e-3 where the Hann
    envelope is at least 0.5 (one float16 rounding flipped by an f32 sum in
    another order, test_torch_separation.py's limit) and at SNR >= 50 dB
    over the whole track;
  - the guard's floor, retry, best reading and health tags follow
    bench.py's ``_guard_secondary`` (run from the root file, which imports
    JAX only inside its ``main``);
  - main on the CPU (the small model, 1 s segments in 3 s windows, a 4 s
    track) prints bench.py's fields; a secondary that raises ends the
    process with a non-zero exit code and no JSON line; with no card it
    exits 2.
"""
import ast
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.config import EvalConfig as JaxEvalConfig
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.evaluation.inference import SourceSeparator as JaxSeparator
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu_torch import bench
from tfswa_tpu_torch.config import EvalConfig, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.weights import variables_from_state_dict

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
SMALL_STFT = dict(n_fft=128, hop_length=64, sample_rate=1000)
SMALL_TRACK_S = 12.0
# main's control flow at a tiny size: test_torch_separation.py's knobs
TINY_KNOBS = dict(segment_length=1.0, overlap=0.25, mask_mode="trainer",
                  stem_names=("vocals", "other"), segment_batch=3, transfer_dtype="float16",
                  device_ola=True, ola_bucket_seconds=3.0, freq_policy="crop_pow2")
TINY_TRACK_S = 4.0


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_main():
    tree = ast.parse((ROOT / "bench.py").read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _call_kwargs(fn, name):
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == name)
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if not isinstance(k.value, (ast.Name, ast.Attribute))}


def _assigned(fn, name):
    return next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == name)


def test_settings_equal_the_root_bench():
    main = _root_main()
    assert _call_kwargs(main, "STFTConfig") == bench.STFT
    assert _call_kwargs(main, "SourceSeparator") == bench.separator_knobs()
    assert ast.literal_eval(_assigned(main, "track_seconds")) == bench.TRACK_SECONDS
    src = ast.get_source_segment((ROOT / "bench.py").read_text(), main)
    assert "for _ in range(5):" in src and bench.TIMED_RUNS == 5
    assert "[audio, audio, audio]" in src and bench.STREAM_TRACKS == 3
    assert "max_in_flight=2" in src and bench.STREAM_IN_FLIGHT == 2
    assert "t1, t5 = _run(1), _run(5)" in src and bench.CHAIN_WINDOWS == 5
    root = _root_bench()
    assert (root.BASELINE_AUDIO_SEC_PER_SEC, root._STREAM_FLOOR_FRAC,
            root._DEVICE_ONLY_FLOOR_FRAC) == (bench.BASELINE_AUDIO_SEC_PER_SEC,
                                              bench.STREAM_FLOOR_FRAC,
                                              bench.DEVICE_ONLY_FLOOR_FRAC)
    # the track: bench.py's expression for `audio`, evaluated on 1 s at 44.1 kHz
    sr = 44100
    n = sr
    expr = ast.Expression(_assigned(main, "audio"))
    ref = eval(compile(expr, "bench.py", "eval"), {"np": np, "n": n, "t": np.arange(n) / sr})
    np.testing.assert_array_equal(bench.track(1.0, sr), ref)


def test_separator_knobs_are_the_fast_serving_preset():
    """bench.py's knobs are EvalConfig.fast_serving()'s in both packages
    (the stems are the bench's own: EvalConfig has none)."""
    knobs = bench.separator_knobs()
    for ev in (EvalConfig.fast_serving(), JaxEvalConfig.fast_serving()):
        assert knobs == dict(segment_length=ev.segment_seconds, overlap=ev.overlap,
                             mask_mode=ev.mask_mode, stem_names=("vocals", "other"),
                             segment_batch=ev.segment_batch,
                             transfer_dtype=ev.transfer_dtype, device_ola=ev.device_ola,
                             ola_bucket_seconds=ev.ola_bucket_seconds,
                             freq_policy=ev.freq_policy)
        assert ev.stft_precision == bench.STFT["precision"]


def _small_model():
    model = TFSWAUNet(4, 4, generator=torch.Generator().manual_seed(0), **SMALL).eval()
    with torch.no_grad():
        for t in model.state_dict().values():
            if t.dim() == 4:
                t.mul_(0.4)                   # the sigmoid head does not saturate
    return model


def _snr_db(ref, out):
    return 10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                         / max(np.sum((ref.astype(np.float64) - out) ** 2), 1e-30))


def test_bench_separator_matches_jax_at_a_small_model():
    model = _small_model()
    ps = bench.bench_separator(model, STFTProcessor(STFTConfig(**SMALL_STFT)), "cpu")
    variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(model.state_dict(), SMALL["depths"]))
    jm = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **SMALL)
    js = JaxSeparator(jm, variables, JaxProcessor(JaxSTFTConfig(**SMALL_STFT)),
                      **_call_kwargs(_root_main(), "SourceSeparator"))
    assert ps.ola_window_segments == js.ola_window_segments
    audio = bench.track(SMALL_TRACK_S, SMALL_STFT["sample_rate"])
    ref, out = js.separate(audio), ps.separate(audio)
    assert set(out) == set(ref) == {"vocals", "other"}
    for name in out:
        assert out[name].shape == ref[name].shape == (1, audio.size)
        assert np.isfinite(out[name]).all() and np.abs(ref[name]).max() > 1e-3
        lo = ps.hop_samples // 3               # the envelope is >= 0.5 from here on
        np.testing.assert_allclose(out[name][:, lo:], ref[name][:, lo:], atol=1e-3, rtol=0)
        assert _snr_db(ref[name], out[name]) > 50.0


GUARD_CASES = [
    [95.0],                 # at or above the floor: one reading
    [60.0, 90.0],           # under, then over: the better one, "ok"
    [60.0, 70.0],           # under twice: "degraded_sample"
    [80.0],                 # exactly the floor
    [79.99, 10.0],          # the first under and better
]


@pytest.mark.parametrize("readings", GUARD_CASES)
def test_guard_follows_the_root_bench(readings):
    root = _root_bench()
    got = bench.guard_secondary("stream", iter(readings).__next__, 80.0)
    ref = root._guard_secondary("stream", iter(readings).__next__, 80.0)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str):
            assert got[k] == v
        elif isinstance(v, list):
            assert [round(a, 2) for a in got[k]] == v
        else:
            assert round(got[k], 3) == round(v, 3)


def test_guard_lets_an_exception_through():
    def boom():
        raise RuntimeError("stream failed")

    with pytest.raises(RuntimeError, match="stream failed"):
        bench.guard_secondary("stream", boom, 80.0)


# main at a tiny size: the flagship, the bench's STFT, knobs and track patched
TINY_MAIN = (
    "import sys, torch\n"
    "from tfswa_tpu_torch import bench\n"
    "from tfswa_tpu_torch.models import TFSWAUNet\n"
    "torch.set_num_threads(2)\n"
    f"bench._common.flagship = lambda device: TFSWAUNet(4, 4, generator="
    f"torch.Generator().manual_seed(0), **{SMALL!r}).eval()\n"
    f"bench.STFT = dict(bench.STFT, **{SMALL_STFT!r})\n"
    f"bench.separator_knobs = lambda: {TINY_KNOBS!r}\n"
    f"bench.TRACK_SECONDS = {TINY_TRACK_S}\n"
    "bench.TIMED_RUNS = 1\n"
)


def test_main_prints_the_root_bench_fields_at_a_tiny_size(monkeypatch):
    monkeypatch.setattr(bench._common, "flagship", lambda device: _small_model())
    monkeypatch.setattr(bench, "STFT", dict(bench.STFT, **SMALL_STFT))
    monkeypatch.setattr(bench, "separator_knobs", lambda: TINY_KNOBS)
    monkeypatch.setattr(bench, "TRACK_SECONDS", TINY_TRACK_S)
    monkeypatch.setattr(bench, "TIMED_RUNS", 1)
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert bench.main(["--device", "cpu"]) == 0
    lines = buf.getvalue().strip().splitlines()
    assert lines[0] == "cpu"
    res = json.loads(lines[-1])
    assert res["metric"] == "separation_throughput"
    assert res["unit"] == "audio_sec_per_sec_per_chip"
    for k in ("value", "vs_baseline", "stream_value", "stream_vs_baseline",
              "device_only_value", "device_only_vs_baseline"):
        assert math.isfinite(res[k]) and res[k] > 0, k
    assert res["vs_baseline"] == res["value"] / 24.0
    assert len(res["runs_s"]) == 1
    assert res["stream_health"] in ("ok", "degraded_sample")
    assert res["device_only_health"] in ("ok", "degraded_sample")
    assert res["launches_per_separation"] == {}          # the plain versions on the CPU
    assert (res["device"], res["card"]) == ("cpu", "cpu")


def test_a_secondary_that_raises_ends_the_run_non_zero():
    code = TINY_MAIN + (
        "def boom(sep, audio):\n"
        "    raise RuntimeError('device-only failed')\n"
        "bench.device_only_rate = boom\n"
        "sys.exit(bench.main(['--device', 'cpu']))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "device-only failed" in res.stderr
    assert "{" not in res.stdout                           # no JSON line


def test_exits_2_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "tfswa_tpu_torch.bench"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 2
    assert "no CUDA device" in res.stderr
    assert res.stdout == ""


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bench", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
GOOD = {"metric": "separation_throughput", "value": 96.0, "vs_baseline": 4.0,
        "runs_s": [1.25] * 5, "stream_value": 85.0, "stream_health": "ok",
        "device_only_value": 102.0, "device_only_health": "degraded_sample",
        "launches_per_separation": {"B1": 132.0}, "card": CARD}


@pytest.mark.parametrize("bad", [
    {"value": 106.0},                                            # > 10 % from phase 4
    {"launches_per_separation": {"B1": 132.0, "B4": 66.0}},     # another kernel
    {"launches_per_separation": {"B1": 66.0}},
    {"stream_value": float("nan")},
    {"runs_s": [1.25] * 4},
    {"device_only_health": "failed"},
    {"card": "NVIDIA H100 80GB HBM3, 500.00 W"},
])
def test_chip_smoke_holds_the_bench_line(chip_smoke, bad):
    """chip_smoke.py's bench phase: a line as the card prints it passes at
    phase 4's rate 95; each fault of ``bad`` is reported."""
    assert chip_smoke.bench_problems(GOOD, CARD, 95.0) == []
    assert chip_smoke.bench_problems(dict(GOOD, **bad), CARD, 95.0)
