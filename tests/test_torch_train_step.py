"""The port's train step against the JAX package's ``make_train_step``, on
the CPU, with a small model, f32, an 8 kHz STFT (n_fft 256, hop 64) and
the same weights and batch.  The model is ``test_torch_separation.py``'s
SMALL (dims (8, 16, 32, 64)) with one block at the first stage and the
bottleneck and none at the two middle stages: TSA, FSA and SWA still run
forward and backward at two widths, with every stage's down/up convs and
BatchNorms, and the JAX compile, the bulk of this file's time, halves.

The JAX step runs once, jitted, with its plain ("xla") attention and an
optax transform that hands the raw gradients out through its state, so
that loss, gradients and batch_stats come from ``make_train_step`` itself.
It is compiled at XLA's lowest backend optimization level, which changes
no value checked here and halves the compile, the bulk of this file's
time.  The port runs three of its routes: "pallas" (on the CPU the plain
versions of B1-train and B2 inside the autograd.Function), "pallas_attn"
(the plain version of B4, and the plain attention's VJP a chunk of rows at
a time) and "xla" (autograd).  The optimizer, BatchNorm and the other pieces of the step
are held against JAX in ``test_torch_training.py``.

Tolerances (all f32, sums in another order: FFT vs DFT, convs, attention):
  - loss_dict: rtol 1e-5;
  - gradients, leaf by leaf: 1e-4 of each leaf's largest magnitude.  Some
    leaves are 0 in exact arithmetic (the last bias of a branch whose shift
    the next train-mode BatchNorm removes, or a conv bias just before one)
    and hold rounding noise (~1e-10 against a largest gradient ~1e-2);
    every leaf also gets an absolute 1e-6 of the largest gradient;
  - batch_stats after the step: atol 1e-5 (running means and variances are
    O(0.1-1)).  A variance stored unbiased, n/(n-1) too large, misses it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.weights import variables_from_state_dict

SR = 8000
SMALL = dict(depths=(1, 0, 0, 1), dims=(8, 16, 32, 64), window_size=4,
             shift_size=2, num_heads=2)
STEMS = ("vocals", "other")


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


def _batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    targets = {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32)
               for k in STEMS}
    return mix, targets


def _port_model(impl):
    return TFSWAUNet(4, 4, attention_impl=impl,
                     generator=torch.Generator().manual_seed(0), **SMALL)


@pytest.fixture(scope="module")
def jax_step():
    """One jitted JAX train step from the port's seeded weights: loss_dict,
    raw gradients and batch_stats after the step."""
    variables = variables_from_state_dict(_port_model("xla").state_dict(), SMALL["depths"])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=capture.init(params), tx=capture)
    step = jax.jit(jts.make_train_step(
        JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", **SMALL),
        JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS),
        compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = _batch()
    new, loss = step(state, jnp.asarray(mix), {k: jnp.asarray(v) for k, v in targets.items()})
    return ({k: float(v) for k, v in loss.items()}, dict(_flat(new.opt_state)),
            dict(_flat(new.batch_stats)))


@pytest.mark.parametrize("impl", ["pallas", "pallas_attn", "xla"])
def test_train_step_matches_jax(jax_step, impl):
    ref_loss, ref_grads, ref_bs = jax_step
    model = _port_model(impl)
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    state = pts.TrainState(0, model, tx)
    step = pts.make_train_step(
        model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS)
    grads = {}
    mix, targets = _batch()
    # read the raw gradients just before the optimizer clips and applies them
    orig = tx.step
    tx.step = lambda: grads.update({n: p.grad.clone() for n, p in model.named_parameters()}) \
        or orig()
    state, loss = step(state, torch.from_numpy(mix),
                       {k: torch.from_numpy(v) for k, v in targets.items()})
    assert state.step == 1 and set(loss) == set(ref_loss)
    for k, v in ref_loss.items():
        np.testing.assert_allclose(float(loss[k]), v, rtol=1e-5, err_msg=k)
    got = dict(_flat(variables_from_state_dict(grads, SMALL["depths"])["params"]))
    assert set(got) == set(ref_grads)
    floor = 1e-6 * max(np.abs(g).max() for g in ref_grads.values())
    for k, ref in ref_grads.items():
        assert np.abs(got[k] - ref).max() <= 1e-4 * np.abs(ref).max() + floor, k
    got_bs = dict(_flat(variables_from_state_dict(model.state_dict(),
                                                  SMALL["depths"])["batch_stats"]))
    for k, ref in ref_bs.items():
        np.testing.assert_allclose(got_bs[k], ref, atol=1e-5, rtol=0, err_msg=k)
