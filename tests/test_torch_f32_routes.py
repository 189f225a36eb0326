"""The float32 model through each kernel route against the JAX package on
the CPU: ``ModelConfig(dtype="float32")`` (the default) with
``attention_impl`` "pallas", "pallas_int8" or "pallas_attn", built by
``TFSWAUNet.from_config``, forward in eval mode against the JAX model with
the same weights, its Pallas kernels in interpret mode and its autotune
gates sending every (N, C) to the kernel (and B3's int8 core on), as
``test_torch_int8_block.py`` forces them.  On a card the same routes
launch the f32 kernels (``csrc/*_f32*``, held in ``chip_smoke.py`` phase
15); here each row block runs the route's plain version (3 a
TFSWABlock), as its custom op does on the CPU.  The f32 train steps of
"pallas" and "pallas_attn" are held against JAX's in
``test_torch_train_step.py``; "pallas_int8" has no gradient.

Tolerance: 1e-4 absolute on the sigmoid masks (f32 sums in another order
through a dozen layers; the JAX package's own kernel-vs-XLA limit is 2e-5
a block).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.pallas import autotune
from tfswa_tpu_torch.config import ModelConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops import fused_block, row_attention
from tfswa_tpu_torch.weights import variables_from_state_dict

SMALL = dict(depths=(1, 0, 0, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
             num_heads=4)
# the plain version each route runs on the CPU
PLAIN = {"pallas": (fused_block, "fused_row_block_reference_parts"),
         "pallas_int8": (fused_block, "fused_row_block_int8_reference"),
         "pallas_attn": (row_attention, "flash_row_attention_reference")}


def _gate_everything_to_the_kernels(path):
    route = {f"{n},{c},float32": "pallas" for n in range(1, 300) for c in SMALL["dims"]}
    int8 = {f"{n},{c}": "1" for n in range(1, 300) for c in SMALL["dims"]}
    (path / "autotune.json").write_text(json.dumps(
        {"cpu": {"attn_route": route, "fused_int8": int8}}))


@pytest.mark.parametrize("impl", sorted(PLAIN))
def test_f32_model_through_each_kernel_route_matches_jax(impl, monkeypatch, tmp_path):
    cfg = ModelConfig(in_channels=4, out_channels=4, attention_impl=impl, **SMALL)
    assert cfg.dtype == "float32"
    pm = TFSWAUNet.from_config(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():       # scores that shape the output; masks that do not saturate
        for name, w in pm.named_parameters():
            if name.endswith("attn.qkv.weight"):
                w.mul_(40.0)
            elif w.dim() == 4:
                w.mul_(0.4)
    variables = variables_from_state_dict(pm.state_dict(), SMALL["depths"])
    x = np.random.default_rng(5).standard_normal((1, 4, 33, 13)).astype(np.float32)
    _gate_everything_to_the_kernels(tmp_path)
    monkeypatch.setenv("TFSWA_AUTOTUNE_DIR", str(tmp_path))
    autotune.reset()
    try:
        jm = JaxUNet(in_channels=4, out_channels=4, attention_impl=impl, **SMALL)
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                      jnp.asarray(x), train=False))
    finally:
        autotune.reset()
    mod, name = PLAIN[impl]
    plain = getattr(mod, name)
    calls = []
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or plain(*a, **k))
    with torch.inference_mode():
        out = pm(torch.from_numpy(x)).numpy()
    assert len(calls) == 3 * (2 * sum(SMALL["depths"][:3]) + SMALL["depths"][3])
    assert out.shape == ref.shape == (1, 4, 33, 13)
    assert ((ref > 0.02) & (ref < 0.98)).all() and ref.std() > 0.005  # neither saturated nor flat
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
