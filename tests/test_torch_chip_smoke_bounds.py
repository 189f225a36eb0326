"""chip_smoke.py's yardstick for B2's attention backward and LN1 backward,
and its planted faults, on the CPU.

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
