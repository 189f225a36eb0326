"""chip_smoke.py's yardstick for B2's attention backward and LN1 backward,
its planted faults, the launch counts of its training phases and the
row shapes of the training recipe and of the quality A/B it checks, on the
CPU.

The script is loaded by file path with the H100's exp2 rate set by hand
(16 a clock an SM x 132 SMs x 1980 MHz), as main() sets it from the card.
The bounds are reckoned here from the shapes, independently of the script:
  - the attention-backward pair at stage-0 TSA of TRAIN_SHAPES (N = 1025,
    C = 32, R = 2068): H N^2 exp2 a row, once, over the MUFU rate;
  - ln1_bwd_kernel at stage-0 FSA (N = 517, C = 32, R = 4100): 14 C bytes
    a token over the HBM rate, plus W_qkv and the partials.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
MUFU_RATE = 16 * 132 * 1980e6          # 4.18e12 exp2 a second


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.MUFU_RATE = MUFU_RATE
    return mod


def _train_shape(mod, stage, attn):
    (shape,) = [s for s in mod.TRAIN_SHAPES if s[:2] == (stage, attn)]
    return shape


def test_attention_backward_pair_is_bound_by_one_exp2_a_pair(chip_smoke):
    _, _, N, C, R = _train_shape(chip_smoke, 0, "TSA")
    ms, by = chip_smoke.bound_launch_ms("attn_bwd", R, N, C, 4 * C, "B2")
    exp2_ms = R * 8 * N * N / MUFU_RATE * 1e3
    assert by == "operations"
    assert ms == pytest.approx(exp2_ms, rel=1e-9)
    assert ms == pytest.approx(4.16, abs=0.005)
    # the function's floor counts exp2 once: B2's whole bound is no smaller
    assert chip_smoke.bound_bwd_ms(R, N, C, 4 * C)[0] >= ms


def test_ln1_backward_is_bound_by_its_bytes(chip_smoke):
    _, _, N, C, R = _train_shape(chip_smoke, 0, "FSA")
    M = R * N
    ms, by = chip_smoke.bound_launch_ms("ln1_bwd_kernel", R, N, C, 4 * C, "B2")
    blocks = min(-(-M // 64), 1024)
    nbytes = 14 * C * M + 2 * (3 * C * C + C) + 8 * C * blocks
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-9)
    assert ms == pytest.approx(0.2836, abs=5e-4)
    assert ms > 6 * M * C * C / 989e12 * 1e3          # its product is far below


@pytest.mark.parametrize("launch", ["attn_bwd_q_kernel", "attn_bwd_kv_kernel", "ln1_bwd_kernel"])
def test_b2_launches_are_timed_and_held_to_the_tensor_cores(chip_smoke, launch):
    assert launch in chip_smoke.SASS_HMMA["fused_block_bwd"]
    assert any(name in launch for name in chip_smoke.PRODUCT_LAUNCHES["B2"])


@pytest.mark.parametrize("name", ["no_d_den", "no_clamp", "drop_last_split", "ragged_keys"])
def test_each_planted_fault_edits_one_place_of_the_backward_source(chip_smoke, name):
    src = (ROOT / "tfswa_tpu_torch" / "csrc" / "fused_block_bwd.cu").read_text()
    old, new = chip_smoke.PLANTS[name]
    assert src.count(old) == 1 and old != new


@pytest.mark.parametrize("name", ["b4_tf32_scores"])
def test_each_planted_f32_fault_edits_one_place_of_b4s_f32_source(chip_smoke, name):
    src = (ROOT / "tfswa_tpu_torch" / "csrc" / "row_attention_f32.cu").read_text()
    old, new = chip_smoke.F32_PLANTS[name]
    assert src.count(old) == 1 and old != new


def test_the_1xtf32_plant_drops_the_two_correction_products_of_the_f32_tile(chip_smoke):
    """--plant f32_1xtf32 edits one place of csrc/block_f32.cuh, the tile
    every f32 product runs on: mma3 keeps its big-by-big pass alone (one
    TF32 pass), and nothing else of the header changes."""
    assert chip_smoke.F32_PLANT_SOURCES["f32_1xtf32"] == "block_f32.cuh"
    src = (ROOT / "tfswa_tpu_torch" / "csrc" / "block_f32.cuh").read_text()
    old, new = chip_smoke.F32_PLANTS["f32_1xtf32"]
    assert src.count(old) == 1 and old != new
    planted = src.replace(old, new)
    body = planted[planted.index("void mma3("):]
    body = body[:body.index("}\n")]
    assert body.count("mma_tf32(") == 1 and "mma_tf32(t, a[0], b[0]);" in body
    assert len(src) - len(planted) == len(old)


@pytest.mark.parametrize("kind,C,attn", [("B1", 32, "attn_ffma_kernel"),
                                         ("B1", 128, "attn_kernel"),
                                         ("B2", 64, "attn_bwd_q_ffma_kernel"),
                                         ("B2", 256, "attn_bwd_kv_kernel")])
def test_f32_launches_timed_apart_follow_the_head_width(chip_smoke, kind, C, attn):
    """Phase 15 (a) times each f32 launch that runs at a shape: the _ffma
    attention for a head of at most 8 channels (8 heads: C = 32, 64), the
    tensor-core one above; B3 alone the quantisation launches; every name
    one of the f32 libraries' kernels (SASS_TF32 or SASS_CHAIN) or a row
    kernel of block_f32.cuh."""
    names = chip_smoke.f32_launches_at(kind, C)
    assert attn in names
    assert ("qk_scale_kernel" in names) == (kind == "B3")
    src = (ROOT / "tfswa_tpu_torch" / "csrc" / "block_f32.cuh").read_text() + "".join(
        (ROOT / "tfswa_tpu_torch" / "csrc" / f"{lib}.cu").read_text()
        for lib in chip_smoke.F32_LIBS)
    for n in names:
        assert f"{n}(" in src, n


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches_with_and_without_remat(chip_smoke, monkeypatch, remat):
    """The new phase's designed counts a step (66 B1-train + 66 B2 at the
    flagship depths; 132 + 66 with remat, whose backward runs each block's
    forward again) and, at a small depth, the calls one CPU step of the
    "pallas" route makes to the two wrappers."""
    import numpy as np
    import torch

    from tfswa_tpu_torch.config import Config, STFTConfig
    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.ops.stft import STFTProcessor
    from tfswa_tpu_torch.training import train_state as pts

    assert chip_smoke.step_launches(remat=remat) == {"B1-train": 132 if remat else 66, "B2": 66}
    calls = {"B1-train": 0, "B2": 0}
    for name, key in (("fused_row_block_train", "B1-train"), ("fused_row_block_bwd", "B2")):
        real = getattr(fb, name)

        def counted(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(fb, name, counted)
    depths = (1, 1, 0, 2)
    model = TFSWAUNet(4, 4, depths=depths, dims=(8, 16, 32, 64), window_size=4, shift_size=2,
                      num_heads=2, attention_impl="pallas", remat=remat,
                      generator=torch.Generator().manual_seed(0))
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    step = pts.make_train_step(model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64,
                                                               sample_rate=8000)),
                               ("vocals", "other"))
    mix = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 1500)).astype(np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # six tier-1 workers share the cores
    try:
        step(pts.TrainState(0, model, tx), mix, {"vocals": mix * 0.5, "other": mix * 0.5})
    finally:
        torch.set_num_threads(threads)
    assert calls == chip_smoke.step_launches(depths, remat) == \
        {"B1-train": (2 if remat else 1) * 3 * 6, "B2": 3 * 6}


def test_cli_launches_are_designed_from_the_recipe(chip_smoke):
    """The CLI run of the new phase (configs/musdb_repro.yaml, 2 epochs of 4
    steps, 2 SDR tracks): 8 remat steps; 2 validations of 20 synthetic
    segments of 5.938 s in batches of 4; one SDR evaluation of 2 tracks of
    30 s, each 5 ten-second segments at 50 % overlap, one batch of 8."""
    from tfswa_tpu_torch.config import Config

    cfg = Config.from_yaml(str(ROOT / "configs" / "musdb_repro.yaml")).apply_overrides(
        ["train.sdr_eval_num_tracks=2"])
    assert chip_smoke.cli_designed_launches(cfg, 8, 2, 1) == {
        "train_epoch": {"B1-train": 8 * 132, "B2": 8 * 66},
        "validate": {"B1": 2 * 5 * 66}, "evaluate_sdr": {"B1": 2 * 66}}


def test_row_shapes_reproduce_the_serving_and_training_tables(chip_smoke):
    """row_shapes at F x T of the serving batch (1024 x 862) and of the
    training batch (1025 x 517) gives the (N, C) of SHAPES and of
    TRAIN_SHAPES."""
    dims = (32, 64, 128, 256)
    assert chip_smoke.row_shapes(1024, 862, dims, 8) == {
        (N, C) for _, _, N, C, _ in chip_smoke.SHAPES}
    assert chip_smoke.row_shapes(1025, 517, dims, 8) == {
        (N, C) for _, _, N, C, _ in chip_smoke.TRAIN_SHAPES}


def test_recipe_shapes_beyond_the_tables(chip_smoke):
    """The recipe trains at F = 1024 (crop_pow2), T = 512 (5.938 s), and its
    SDR evaluation separates 10 s at F = 1025: the (N, C) the tables lack,
    which phase_recipe_kernels checks."""
    from tfswa_tpu_torch.config import Config

    shapes = chip_smoke.recipe_row_shapes(Config.from_yaml(str(ROOT / chip_smoke.RECIPE)))
    train = {(N, C) for _, _, N, C, _ in chip_smoke.TRAIN_SHAPES}
    served = {(N, C) for _, _, N, C, _ in chip_smoke.SHAPES}
    assert shapes["train"] == shapes["val"]
    assert shapes["train"] - train == {(1024, 32), (512, 32), (256, 64), (128, 128)}
    assert (shapes["val"] | shapes["sdr"]) - served == {
        (512, 32), (256, 64), (128, 128), (1025, 32)}


def test_recipe_shapes_are_what_the_trainer_launches(chip_smoke, monkeypatch, tmp_path):
    """At a small size of the recipe (8 kHz, n_fft 256, crop_pow2 to F = 128,
    0.5 s segments: T = 63; 1 s SDR segments: T = 126), the (N, C) the
    trainer's step, validation and SDR evaluation give the row-block
    wrappers on the "pallas" route are recipe_row_shapes'."""
    import torch

    from tfswa_tpu_torch.config import Config
    from tfswa_tpu_torch.data.synthetic import SyntheticDataset
    from tfswa_tpu_torch.ops import fused_block as fb
    from tfswa_tpu_torch.training.trainer import Trainer

    cfg = Config.from_yaml(str(ROOT / chip_smoke.RECIPE)).apply_overrides([
        "data.sample_rate=8000", "stft.sample_rate=8000", "stft.n_fft=256",
        "stft.hop_length=64", "model.depths=(1,1,1,1)", "model.dims=(8,16,32,64)",
        "model.window_size=4", "model.shift_size=2", "model.num_heads=2",
        "data.segment_seconds=0.5", "data.batch_size=2", "data.num_workers=0",
        "train.steps_per_epoch=1", "train.sdr_eval_num_tracks=1",
        "train.sdr_eval_segment_seconds=1.0", f"train.checkpoint_dir={tmp_path / 'ck'}",
        f"train.log_dir={tmp_path / 'log'}"])
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
    seen, phase = {}, []
    for name, kind in (("fused_row_block_train", "B1-train"), ("fused_row_block_parts", "B1"),
                       ("fused_row_block_bwd_parts", "B2")):
        def shape_of(rows, *a, _real=getattr(fb, name), _kind=kind):
            seen.setdefault((phase[-1], _kind), set()).add(tuple(rows.shape[1:]))
            return _real(rows, *a)

        monkeypatch.setattr(fb, name, shape_of)
    data = dict(segment_seconds=0.5, sample_rate=8000, seed=0)
    trainer = Trainer(cfg, SyntheticDataset(num_tracks=2, track_seconds=1.0, **data),
                      SyntheticDataset(num_tracks=1, track_seconds=1.5, random_segments=False,
                                       **data), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)          # six tier-1 workers share the cores
    try:
        for name in ("train_epoch", "validate", "evaluate_sdr"):
            phase.append(name)
            getattr(trainer, name)()
    finally:
        torch.set_num_threads(threads)
        trainer.logger.close()
    want = chip_smoke.recipe_row_shapes(cfg)
    assert want["train"] == chip_smoke.row_shapes(128, 63, (8, 16, 32, 64), 4)
    assert want["sdr"] == chip_smoke.row_shapes(129, 126, (8, 16, 32, 64), 4)
    assert seen == {("train_epoch", "B1-train"): want["train"],
                    ("train_epoch", "B2"): want["train"],
                    ("validate", "B1"): want["val"], ("evaluate_sdr", "B1"): want["sdr"]}


def test_quality_shapes_beyond_the_earlier_phases(chip_smoke):
    """Phase 14 (a): the quality A/B trains on 2 s segments at F = 1025 (T =
    173), validates there and evaluates SDR on 10 s (T = 862): the (N, C)
    that phases 2, 6 and the recipe's checks lack are its four FSA rows,
    for B1-train / B2 and for B1 alike."""
    cfg = chip_smoke.quality_config()
    shapes = chip_smoke.recipe_row_shapes(cfg)
    assert shapes["train"] == shapes["val"] == chip_smoke.row_shapes(
        1025, 173, (32, 64, 128, 256), 8)
    assert shapes["sdr"] == chip_smoke.row_shapes(1025, 862, (32, 64, 128, 256), 8)
    covered = chip_smoke.initial_covered()
    recipe = chip_smoke.recipe_row_shapes(chip_smoke.recipe_config())
    covered["train"] |= recipe["train"]
    covered["B1"] |= recipe["val"] | recipe["sdr"]
    new = [(21, 256), (43, 128), (86, 64), (173, 32)]
    assert chip_smoke.unchecked_shapes(shapes, covered) == {"train": new, "B1": new}


def test_quality_config_is_the_tools_direct_arm(chip_smoke, tmp_path):
    """quality_config() is what tools/quality_ab.py's direct arm trains:
    the flagship in bf16 with remat through "pallas", 2 x 2 s, 60 steps an
    epoch, direct masks, its directories under the output root."""
    cfg = chip_smoke.quality_config(str(tmp_path))
    m, d, t = cfg.model, cfg.data, cfg.train
    assert (m.depths, m.dims, m.in_channels, m.out_channels) == (
        (2, 2, 6, 2), (32, 64, 128, 256), 4, 4)
    assert (m.dtype, m.remat, m.attention_impl) == ("bfloat16", True, "pallas")
    assert (d.batch_size, d.segment_seconds, d.num_workers) == (2, 2.0, 0)
    assert (t.steps_per_epoch, t.train_mask_mode, t.max_epochs) == (60, "direct", 1)
    assert (t.checkpoint_dir, t.log_dir) == (str(tmp_path / "direct" / "ck"),
                                             str(tmp_path / "direct"))


def test_quality_launches_are_designed_from_the_recipe(chip_smoke):
    """Phase 14 (c) and (d): 60 steps of 132 B1-train + 66 B2 (remat), one
    validation of the 60 two-second segments of the 4 validation tracks in
    batches of 2 (30 forwards of 66 B1), one SDR evaluation of 4 tracks of
    5 ten-second segments at 50 % overlap (one forward each); overlap_table
    at 0.5 and 0.25 separates each track in one forward of 8 segments (5
    and 3 of them)."""
    cfg = chip_smoke.quality_config()
    assert chip_smoke.cli_designed_launches(cfg, chip_smoke.QUALITY_STEPS, 1, 1) == {
        "train_epoch": {"B1-train": 60 * 132, "B2": 60 * 66},
        "validate": {"B1": 30 * 66}, "evaluate_sdr": {"B1": 4 * 66}}
    assert chip_smoke.overlap_launches(cfg, chip_smoke.QUALITY_OVERLAPS) == 2 * 4 * 66
    assert chip_smoke.overlap_launches(cfg, (0.1,)) == 4 * 66     # 3 segments
    assert chip_smoke.overlap_launches(cfg, (0.9,)) == 4 * 3 * 66  # 21 segments


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep the separations below from oversubscribing them."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _separator(**knobs):
    """A small separator on the CPU (8 kHz, n_fft 256, 1 s segments)."""
    import torch

    from tfswa_tpu_torch.config import STFTConfig
    from tfswa_tpu_torch.evaluation import SourceSeparator
    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    model = TFSWAUNet(4, 4, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4,
                      shift_size=2, num_heads=2, generator=torch.Generator().manual_seed(0))
    kw = dict(segment_length=1.0, overlap=0.25, segment_batch=3, ola_bucket_seconds=3.0,
              transfer_dtype="float16", device_ola=True, freq_policy="crop_pow2")
    return SourceSeparator(model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64,
                                                           sample_rate=8000)),
                           device="cpu", **dict(kw, **knobs))


@pytest.mark.parametrize("knobs", [{}, {"device_ola": False}, {"segment_batch": 8}],
                         ids=["device_ola", "host_ola", "one_batch"])
def test_track_forwards_counts_the_separators_forwards(chip_smoke, knobs):
    import numpy as np

    sep = _separator(**knobs)
    batches = []
    sep.model.register_forward_pre_hook(lambda m, a: batches.append(a[0].shape[0]))
    for seconds in (0.6, 1.0, 2.3, 5.3):
        total = int(seconds * 8000)
        batches.clear()
        sep.separate(np.zeros(total, np.float32))
        assert len(batches) == chip_smoke.track_forwards(sep, total), seconds


def test_phase_11_designs_its_launches_from_the_fast_preset(chip_smoke):
    """At the fast preset (10 s segments, 25 % overlap, windows of 8
    segments, batches of 8): one forward a window of 62.5 s, one for a
    track of a segment or less.  So the stream's 120, 75 and 8 s tracks
    take 2 + 2 + 1 forwards, each CLI input 2 and 1, each evaluated 30 s
    or 20 s track 1."""
    import torch

    from tfswa_tpu_torch.config import EvalConfig
    from tfswa_tpu_torch.evaluation import SourceSeparator
    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops.stft import STFTProcessor

    ev = EvalConfig.fast_serving()
    sep = SourceSeparator(
        TFSWAUNet(4, 4, depths=(1, 1, 1, 1), generator=torch.Generator().manual_seed(0)),
        STFTProcessor(), segment_length=ev.segment_seconds, overlap=ev.overlap,
        segment_batch=ev.segment_batch, transfer_dtype=ev.transfer_dtype, device_ola=True,
        ola_bucket_seconds=ev.ola_bucket_seconds, freq_policy=ev.freq_policy, device="cpu")
    assert sep.ola_window_segments == 8
    f = lambda s: chip_smoke.track_forwards(sep, int(s * 44100))        # noqa: E731
    assert [f(s) for s in chip_smoke.STREAM_TRACKS] == [2, 2, 1]
    frames = [chip_smoke.resampled_frames(int(s * sr), sr, 44100)
              for s, sr in chip_smoke.CLI_INPUTS]
    assert frames == [5292000, 1323000]
    assert [chip_smoke.track_forwards(sep, n) for n in frames] == [2, 1]
    assert f(30.0) == f(chip_smoke.CUSTOM_SECONDS) == 1
    # a 120 s track sends back 2 windows of 2 x 2,756,250 samples: 22.05 MB
    # in float16, half that and 64 bytes of scales in int8
    assert chip_smoke.d2h_bytes(sep, 5292000) == 2 * 2 * 2756250 * 2
    sep.int8_output = True
    assert chip_smoke.d2h_bytes(sep, 5292000) == 2 * (2 * 2756250 + 32)


@pytest.mark.parametrize("transfer_dtype", ["int8", "float16"])
def test_d2h_bytes_are_the_bytes_a_track_fetches(chip_smoke, monkeypatch, transfer_dtype):
    """d2h_bytes against the bytes of every tensor the separation copies
    back."""
    import numpy as np

    from tfswa_tpu_torch.evaluation import SourceSeparator

    sep = _separator(transfer_dtype=transfer_dtype)
    fetched = []
    real = SourceSeparator._fetch
    monkeypatch.setattr(SourceSeparator, "_fetch",
                        staticmethod(lambda t: fetched.append(t.nbytes) or real(t)))
    audio = np.sin(np.arange(int(5.3 * 8000)) * 0.05).astype(np.float32) * 0.5
    sep.separate(audio)
    assert sum(fetched) == chip_smoke.d2h_bytes(sep, audio.size)


def test_int8_checks_of_phase_11(chip_smoke):
    """int8_window_errors on the CPU: each window's decoded codes within
    half a step of its scale of the float32 accumulation of the same
    input, and each window's scales the ones the codec sent; the int8
    track within one step of the peak (int8_step) of the float16 track
    where the Hann envelope is at least 0.5."""
    import numpy as np
    import torch

    sep8, sep16, sep32 = (_separator(transfer_dtype=td) for td in ("int8", "float16", "float32"))
    audio = (np.sin(np.arange(int(5.3 * 8000)) * 0.05) * 0.5).astype(np.float32)
    windows = chip_smoke.int8_window_errors(torch, np, sep8, sep32, audio)
    with torch.inference_mode():
        meta = sep8._dispatch_long_device(audio[None])
    assert [[sc for _, sc in w] for w in windows] == \
        [sep8._host(h[1])[:2].tolist() for h in meta["handles"]]
    assert len(windows) == 2 and all(e <= 0.501 * chip_smoke.int8_step(sc)
                                      for w in windows for e, sc in w)
    i8, f16 = sep8.separate(audio), sep16.separate(audio)
    for name in i8:
        peak = np.abs(sep32.separate(audio)[name]).max()
        assert chip_smoke.int8_step(peak) == peak / 127
        assert np.abs(i8[name] - f16[name])[:, sep8.hop_samples // 3:].max() <= \
            chip_smoke.int8_step(peak)


@pytest.mark.parametrize("frames,sr_in", [(1440000, 48000), (12345, 48000), (999, 22050),
                                         (44100, 44100)])
def test_resampled_frames_is_the_length_resample_poly_gives(chip_smoke, frames, sr_in):
    import numpy as np

    from tfswa_tpu_torch.evaluation.inference import _resample_poly

    out = _resample_poly(np.zeros((1, frames), np.float32), sr_in, 44100)
    assert out.shape[1] == chip_smoke.resampled_frames(frames, sr_in, 44100)


# ------------------------------------------------ phase 12's pure helpers

def test_phase_12_designs_its_launches_from_the_shift_pattern(chip_smoke, monkeypatch):
    """55 B1 launches a masked forward of the flagship (the 11 shifted SWAs
    go to the plain route), 66 unmasked; the design holds for a small model
    whose row blocks are counted on the CPU."""
    import torch

    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.models import attention

    assert chip_smoke.shifted_blocks() == 11
    assert chip_smoke.forward_launches() == 66
    assert chip_smoke.forward_launches(masked=True) == 55
    small = dict(depths=(3, 1, 2, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
                 num_heads=2)
    calls = []
    real = attention.fused_row_block
    monkeypatch.setattr(attention, "fused_row_block",
                        lambda rows, *a: calls.append(rows.shape) or real(rows, *a))
    for masked in (False, True):
        calls.clear()
        model = TFSWAUNet(4, 4, attention_impl="pallas", use_shift_mask=masked, **small)
        with torch.no_grad():
            model(torch.zeros(1, 4, 16, 16))
        assert len(calls) == chip_smoke.forward_launches(small["depths"], masked)


def test_dense_mask_size_of_the_serving_batch(chip_smoke):
    """8 segments x 128 x 108 windows x 64 x 64 x 4 B (T = 862 pads to 864)."""
    assert chip_smoke.dense_mask_gb(8, 1024, 862) == pytest.approx(
        8 * 128 * 108 * 64 * 64 * 4 / 1e9, rel=1e-12)
    assert chip_smoke.dense_mask_gb(8, 1024, 862) == pytest.approx(1.81, abs=0.005)


def test_flagship_parameter_count_is_jaxs(chip_smoke):
    import jax
    import jax.numpy as jnp

    from tfswa_tpu.models import TFSWAUNet as JaxUNet
    from tfswa_tpu_torch.models import TFSWAUNet

    shapes = jax.eval_shape(JaxUNet(in_channels=4, out_channels=4).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32)))
    count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert count == chip_smoke.FLAGSHIP_PARAMETERS == TFSWAUNet(4, 4).count_parameters()


def test_conditioned_weights_do_not_saturate_the_head(chip_smoke):
    """At the seed's init the head saturates (every output 0 or 1); the
    conditioned weights keep it inside (0.05, 0.95) at a small width."""
    import torch

    from tfswa_tpu_torch.models import TFSWAUNet

    small = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
                 num_heads=4)
    model = TFSWAUNet(4, 4, generator=torch.Generator().manual_seed(0), **small)
    before = model.stem[1].running_var.clone()
    chip_smoke.condition_weights(torch, np, model)
    assert not torch.equal(before, model.stem[1].running_var)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 4, 33, 13))
                         .astype(np.float32))
    with torch.no_grad():
        y = model(x)
    assert ((y > 0.05) & (y < 0.95)).all()


def test_int8_product_check_counts_every_product(chip_smoke):
    """check_int8_products runs each product both ways (on the CPU both are
    the plain version): 4 a row block; the plain-product forward equals it."""
    import torch

    from tfswa_tpu_torch.models import TFSWAUNet
    from tfswa_tpu_torch.ops import int8 as int8_ops
    from tfswa_tpu_torch.optimization import quantize_dynamic

    small = dict(depths=(1, 1, 1, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
                 num_heads=4)
    qmodel, _ = quantize_dynamic(TFSWAUNet(4, 4, **small), compute="int8")
    x = torch.zeros(1, 4, 16, 16).normal_(generator=torch.Generator().manual_seed(0))
    n, differ, out = chip_smoke.check_int8_products(torch, qmodel, x)
    assert (n, differ) == (4 * 3 * 7, 0)
    assert int8_ops.int8_product.__name__ == "int8_product"     # restored
    assert torch.equal(out, chip_smoke.plain_products_forward(torch, qmodel, x))
    assert chip_smoke.rel_max(torch.tensor([1.0, 2.5]), torch.tensor([1.0, 2.0])) == 0.25


def test_witness_file_holds_every_leaf_phase_13_holds_against_it(chip_smoke):
    """The committed witness of phase 13 (b) is the run WITNESS_RUN names,
    and it holds a cosine (within f64 rounding of [-1, 1]) for every
    flagship leaf of nonzero gradient: the leaves the kernel run is held
    on against it."""
    import json

    import torch

    from tfswa_tpu_torch.models import TFSWAUNet

    rec = json.load(open(chip_smoke.WITNESS_FILE))
    tag, mesh, n, seconds, impl, dtype, held_by = chip_smoke.WITNESS_RUN
    assert rec["run"] == [tag, list(mesh), n, seconds, impl, dtype] and held_by == "witness"
    assert [r[6] for r in chip_smoke.RANK_RUNS if r[6] not in (None,)] == [tag]
    with torch.device("meta"):
        names = {k for k, _ in TFSWAUNet(4, 4).named_parameters()}
    zero = chip_smoke.zero_gradient_leaves()
    assert len(zero) == 118 and zero <= names
    assert set(rec["cosines"]) == names - zero
    assert all(abs(v) <= 1.0 + 1e-12 for v in rec["cosines"].values())     # f64 rounding


def test_dp_plant_keeps_each_ranks_own_gradient_of_the_planted_leaves(chip_smoke):
    """DP_PLANTS["unsummed_zero_leaves"]: after the (stubbed) sum over the
    data axis, the planted leaves hold their own gradient over d, the rest
    the sum's result."""
    import types

    import torch

    params = [torch.nn.Parameter(torch.zeros(3)) for _ in range(2)]
    for p, g in zip(params, (1.0, 2.0)):
        p.grad = torch.full((3,), g)

    def summed(ps, axis):
        for p in ps:
            p.grad.mul_(axis.size).add_(10.0)

    module = types.SimpleNamespace(_average_gradients=summed)
    chip_smoke.plant_unsummed_zero_leaves(module, {id(params[0])})
    module._average_gradients(params, types.SimpleNamespace(size=2))
    assert params[0].grad.tolist() == [0.5] * 3
    assert params[1].grad.tolist() == [14.0] * 3
    assert chip_smoke.DP_PLANTS == {"unsummed_zero_leaves": chip_smoke.RANK_RUNS[0][0]}


# ------------------------------------------------ phase 15's pure parts

def test_phase_15_is_in_the_docstring_before_the_kernels_line(chip_smoke):
    doc = chip_smoke.__doc__
    at = doc.index(" 15. the f32 forms")
    assert at < doc.index(" 16. every width") < doc.index(" 17. a JSON line of the kernels")
    for part in ("(a)", "(b)", "(c)", "(d)", "(e)", "(f)"):
        assert part in doc[at:doc.index(" 16. ")], part
    for part in ("(a)", "(b)", "(c)", "(d)", "(e)"):
        assert part in doc[doc.index(" 16. "):doc.index(" 17. ")], part


@pytest.mark.parametrize("ref_max,tol", [(0.5, 1e-4), (4.0, 1e-4), (40.0, 1e-3)])
def test_f32_limit_scales_with_the_output(chip_smoke, ref_max, tol):
    """1e-4 x max(max|ref| / 4, 1): B1's bf16 limit's form at f32's scale."""
    assert chip_smoke.f32_tol(ref_max) == pytest.approx(tol)
    assert chip_smoke.F32_SNR_MIN_DB == 70.0 > chip_smoke.SNR_MIN_DB
    assert (chip_smoke.F32_STEP_LOSS_REL, chip_smoke.F32_STEP_COSINE,
            chip_smoke.F32_STEP_LEAF_COSINE) == (1e-5, 0.99999, 0.9999)


def test_f32_launches_at_full_depth_and_at_the_export_depth(chip_smoke):
    """132 f32 B1 launches in the 120 s separation (2 forwards of 66), 21 a
    forward of an exported program at depths (1, 1, 1, 1), 66 + 66 a step."""
    assert chip_smoke.f32_forward_launches() == 132
    assert chip_smoke.f32_forward_launches(seconds=10.0) == 66
    assert chip_smoke.forward_launches(chip_smoke.EXPORT_DEPTHS) == 21
    assert chip_smoke.step_launches() == {"B1-train": 66, "B2": 66}
    assert set(chip_smoke.F32_ROUTES.values()) <= set(chip_smoke.counters())
    assert set(chip_smoke.SASS_TF32) == set(chip_smoke.F32_LIBS)
    for lib in chip_smoke.F32_LIBS:
        assert (ROOT / "tfswa_tpu_torch" / "csrc" / f"{lib}.cu").exists()


def test_f32_bound_of_b1_at_stage_0_tsa(chip_smoke):
    """B1's f32 form at stage-0 TSA of the serving batch (N = 1024, C = 32,
    R = 6896): f32 rows in and out and the weights over the HBM rate, the
    products over 495 / 3 TFLOP/s (3xTF32), H N^2 exp2 a row over the MUFU
    rate; the exp2 bound the largest."""
    (shape,) = [s for s in chip_smoke.SHAPES if s[:2] == (0, "TSA")]
    _, _, N, C, R = shape
    hid, M, H = 4 * C, R * N, 8
    nbytes = 4 * (2 * M * C + 4 * C * C + 2 * C * hid + 6 * C + hid)
    flops = 2 * M * (4 * C * C + 2 * C * hid) + 2 * 2 * R * N * N * C
    want = max(nbytes / 3.35e12, flops / (495e12 / 3), R * H * N * N / MUFU_RATE) * 1e3
    got, by = chip_smoke.bound_f32_ms("B1", R, N, C, hid)
    assert got == pytest.approx(want) and by == "operations"
    ffma, _ = chip_smoke.bound_f32_ms("B1", R, N, C, hid, chip_smoke.PEAK_FFMA_FLOPS)
    assert ffma >= got


@pytest.mark.parametrize("table,H,total", [("SHAPES", 8, 174.59), ("WIDE_SHAPES", 4, 253.69)])
def test_f32_bound_of_b4_counts_its_functions_work_once(chip_smoke, table, H, total):
    """B4's f32 form at each serving shape of the flagship and of wide384,
    reckoned here: q|k (4 M C^2) and the scores (2 R N^2 C) in f64 over the
    FP64 tensor cores' 67 TFLOP/s, v and the out-projection (4 M C^2) and
    p . v (2 R N^2 C) over 3xTF32's 165, H N^2 exp a row over the MUFU
    rate; f32 rows in and out and the weights over the HBM rate.  The FFMA
    column takes the f64 parts at DFMA's 34 TFLOP/s.  Summed over a
    forward's 66 calls: about 175 ms (flagship) and 254 ms (wide384)."""
    got_total = 0.0
    for stage, _, N, C, R in getattr(chip_smoke, table):
        M = R * N
        f64 = 4 * M * C * C + 2 * R * N * N * C
        f32 = 4 * M * C * C + 2 * R * N * N * C
        t_bytes = (4 * 2 * M * C + 4 * 4 * C * C + 4 * C) / 3.35e12
        t_ops = max(f64 / 67e12 + f32 / (495e12 / 3), R * H * N * N / MUFU_RATE)
        got, by = chip_smoke.bound_f32_ms("B4", R, N, C, 4 * C, H=H)
        assert got == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12) and by == "operations"
        ffma, _ = chip_smoke.bound_f32_ms("B4", R, N, C, 4 * C, chip_smoke.PEAK_FFMA_FLOPS, H)
        want = max(t_bytes, f64 / 34e12 + f32 / 67e12, R * H * N * N / MUFU_RATE) * 1e3
        assert ffma == pytest.approx(want, rel=1e-12) and ffma >= got
        got_total += chip_smoke.BLOCKS_PER_STAGE[stage] * got
    assert got_total == pytest.approx(total, abs=0.01)


# --- phase 16: wide384 (dims (48, 96, 192, 384), 4 heads) ------------------

def test_wide384_row_shapes_come_from_its_dims(chip_smoke):
    """wide384's tables are SHAPES and TRAIN_SHAPES at its widths: row_shapes
    at the serving (1024 x 862) and training (1025 x 517) spectrograms with
    its dims gives their (N, C), and their row counts are the flagship's."""
    dims = chip_smoke.WIDE384["dims"]
    assert dims == (48, 96, 192, 384) and chip_smoke.WIDE384["num_heads"] == 4
    for table, flagship, (F, T) in ((chip_smoke.WIDE_SHAPES, chip_smoke.SHAPES, (1024, 862)),
                                    (chip_smoke.WIDE_TRAIN_SHAPES, chip_smoke.TRAIN_SHAPES,
                                     (1025, 517))):
        assert chip_smoke.row_shapes(F, T, dims, 8) == {(N, C) for _, _, N, C, _ in table}
        assert [(s, a, N, R) for s, a, N, _, R in table] == \
            [(s, a, N, R) for s, a, N, _, R in flagship]
        assert all(C == dims[s] for s, _, _, C, _ in table)
    assert chip_smoke.wide_row_shapes("serving") == [
        (R, N, C) for _, _, N, C, R in chip_smoke.WIDE_SHAPES]


def test_bounds_at_the_flagship_heads_are_the_flagships(chip_smoke):
    """The bound functions take the head count; at H = 8 (the default) they
    give the flagship's figures."""
    _, _, N, C, R = chip_smoke.SHAPES[0]
    for fn, args in ((chip_smoke.bound_ms, (R, N, C, 4 * C)),
                     (chip_smoke.bound_attn_ms, (R, N, C)),
                     (chip_smoke.bound_bwd_ms, (R, N, C, 4 * C)),
                     (chip_smoke.bound_f32_ms, ("B4", R, N, C, 4 * C))):
        assert fn(*args) == fn(*args, H=8)
    assert chip_smoke.bound_launch_ms("attn_bwd", R, N, C, 4 * C, "B2") == \
        chip_smoke.bound_launch_ms("attn_bwd", R, N, C, 4 * C, "B2", H=8)


def test_wide_attention_backward_pair_is_bound_by_one_exp2_a_pair(chip_smoke):
    """At wide384's stage-0 TSA (N = 1025, C = 48, R = 2068) the pair is
    still exp2-bound, with 4 heads: half the flagship's exp2 time."""
    (shape,) = [s for s in chip_smoke.WIDE_TRAIN_SHAPES if s[:2] == (0, "TSA")]
    _, _, N, C, R = shape
    ms, by = chip_smoke.bound_launch_ms("attn_bwd", R, N, C, 4 * C, "B2", H=4)
    assert by == "operations"
    assert ms == pytest.approx(R * 4 * N * N / MUFU_RATE * 1e3, rel=1e-9)
    assert ms == pytest.approx(4.16 / 2, abs=0.005)


@pytest.mark.parametrize("i", range(12))
def test_wide_b1_bound_is_reckoned_from_its_shape(chip_smoke, i):
    """B1's bound at each of wide384's serving shapes, reckoned here: bf16
    rows in and out and the weights over the HBM rate, the products and
    scores / AV over the bf16 peak, H N^2 exp2 a row over the MUFU rate."""
    _, _, N, C, R = chip_smoke.WIDE_SHAPES[i]
    H, hid = 4, 4 * C
    nbytes = 2 * (2 * R * N * C + 4 * C * C + 2 * C * hid + 6 * C + hid)
    flops = 2 * R * N * (4 * C * C + 2 * C * hid) + 2 * 2 * R * N * N * C
    t_bytes, t_ops = nbytes / 3.35e12, max(flops / 989e12, R * H * N * N / MUFU_RATE)
    got, by = chip_smoke.bound_ms(R, N, C, hid, H=H)
    assert got == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")
