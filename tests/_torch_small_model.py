"""The small TFSWA-UNet that the port's option tests share: the port model
with weights from a seed, and the JAX model's eval forward on its weights."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.weights import variables_from_state_dict

SMALL = dict(depths=(2, 1, 1, 1), dims=(16, 32, 64, 128), window_size=4, shift_size=2,
             num_heads=4)


def perturbed_model(seed: int = 0, qkv_gain: float = 20.0, **kw) -> TFSWAUNet:
    """The small port model with weights from a seed, convs x0.4 (the
    sigmoid head does not saturate), qkv x ``qkv_gain`` (scores that a mask
    moves) and random BatchNorm statistics."""
    pm = TFSWAUNet(4, 4, generator=torch.Generator().manual_seed(seed), **SMALL, **kw)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in pm.state_dict().items():
            if name.endswith("attn.qkv.weight"):
                t.mul_(qkv_gain)
            elif t.dim() == 4:
                t.mul_(0.4)
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))
            elif name.endswith(("running_mean", "bias")):
                t.add_(torch.from_numpy((0.05 * rng.standard_normal(t.shape)).astype(np.float32)))
    return pm


def jax_forward(pm: TFSWAUNet, x: np.ndarray, **kw) -> np.ndarray:
    """The JAX model with the port model's weights, eval mode, jitted."""
    jm = JaxUNet(in_channels=4, out_channels=4, **SMALL, **kw)
    variables = jax.tree_util.tree_map(
        jnp.asarray, variables_from_state_dict(pm.state_dict(), SMALL["depths"]))
    return np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables,
                                                                       jnp.asarray(x)))
