"""chip_smoke.py's yardstick for B2's attention backward and LN1 backward,
its planted faults, the launch counts of its training phases and the
row shapes of the training recipe it checks, on the CPU.

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
