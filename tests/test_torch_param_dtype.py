"""``param_dtype="bfloat16"`` against the JAX package on the CPU, with
``test_torch_train_step.py``'s small model, STFT and batch.

Held:
  - which leaves are bf16: every parameter, as flax makes each param in
    ``param_dtype``; the BatchNorm running statistics f32, as flax keeps
    them (leaf for leaf, through ``weights.py``'s map);
  - ``weights.py`` both ways, bf16 leaves bit for bit;
  - one train step (loss, updated parameters, Adam moments) of the port
    (``TFSWAUNet.from_config``, ``ClippedAdamW``) against the JAX step with
    optax's adamw from the same bf16 weights, for (dtype, param_dtype) =
    (float32, bfloat16) and (bfloat16, bfloat16).  The moments are kept in
    the parameters' dtype on both sides (optax's default).  Tolerances:
      - the loss: rtol 1e-5 in f32 compute, 2e-2 in bf16 compute (bf16
        activations rounded at other points by the two frameworks);
      - updated parameters: within one bf16 spacing plus 2^-5 of the
        update, for at least 99.9 % of the elements in f32 compute and 95 %
        in bf16 compute (99.98 % and 98.2 % when this test was written).
        The first Adam update u is lr * m_hat / (sqrt(v_hat) + eps), about
        lr * sign(g); optax forms it in bf16 through about ten roundings
        (each at most 2^-9 of it), torch's AdamW through fewer, and p + u
        is rounded to bf16 (one spacing).  Where g is at the noise floor
        of the two frameworks' sums (f32, or bf16 activations) its sign,
        and so u, is a coin toss: those elements are the few that miss.
        The leaves whose gradient is 0 in exact arithmetic (a conv bias
        before a train-mode BatchNorm, each row block's fc2 bias) are all
        noise and are held by dtype and shape only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfswa_tpu.config import Config as JaxConfig
from tfswa_tpu.config import ModelConfig as JaxModelConfig
from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.weights import (conv_bn_pairs, row_blocks, state_dict_from_jax,
                                     variables_from_state_dict)

SR = 8000
SMALL = dict(depths=(1, 0, 0, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
STEMS = ("vocals", "other")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _cfg(dtype="float32", param_dtype="bfloat16", impl="xla"):
    return ModelConfig(in_channels=4, out_channels=4, attention_impl=impl, dtype=dtype,
                       param_dtype=param_dtype, **SMALL)


def _port_model(dtype="float32", impl="xla"):
    model = TFSWAUNet.from_config(_cfg(dtype, impl=impl),
                                  generator=torch.Generator().manual_seed(0))
    with torch.no_grad():              # convs x0.4: the sigmoid head does not saturate
        for p in model.parameters():
            if p.dim() == 4:
                p.copy_(p * 0.4)
    return model


def _batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    targets = {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32) for k in STEMS}
    return mix, targets


def test_parameter_dtypes_are_the_jax_models_leaf_for_leaf():
    jm = JaxUNet.from_config(JaxModelConfig(in_channels=4, out_channels=4,
                                            param_dtype="bfloat16", **SMALL))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 4, 33, 12), jnp.float32)))
    ref = {k: str(v.dtype) for k, v in _flat(jax.tree_util.tree_map(lambda a: a, shapes))}
    ours = {k: str(np.asarray(v).dtype) for k, v in _flat(variables_from_state_dict(
        _port_model().state_dict(), SMALL["depths"]))}
    assert ours == ref
    assert {v for k, v in ref.items() if k.startswith("params/")} == {"bfloat16"}
    assert {v for k, v in ref.items() if k.startswith("batch_stats/")} == {"float32"}


def test_weights_carry_bf16_leaves_both_ways():
    jm = JaxUNet.from_config(JaxModelConfig(in_channels=4, out_channels=4,
                                            param_dtype="bfloat16", **SMALL))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, 33, 12), jnp.float32)))
    sd = state_dict_from_jax(variables, SMALL["depths"])
    model = _port_model()
    model.load_state_dict(sd)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    back = variables_from_state_dict(model.state_dict(), SMALL["depths"])
    ref = dict(_flat(variables))
    for k, v in _flat(back):
        assert v.dtype == ref[k].dtype and np.array_equal(v.view(np.uint8),
                                                          ref[k].view(np.uint8)), k
    again = state_dict_from_jax(back, SMALL["depths"])
    for k, v in model.state_dict().items():
        assert again[k].dtype == v.dtype and torch.equal(again[k], v), k


def _zero_gradient_leaves():
    """The JAX paths of the parameters whose gradient is 0 in exact
    arithmetic: every conv bias before a train-mode BatchNorm and every
    row block's fc2 bias."""
    names = ({f"{c}.bias" for c, _ in conv_bn_pairs(SMALL["depths"])}
             | {f"{n}.mlp.3.bias" for n, _ in row_blocks(SMALL["depths"])})
    marked = variables_from_state_dict({n: torch.zeros(1) for n in names}, SMALL["depths"])
    return {k for k, _ in _flat(marked)}


def _jax_step(variables, dtype):
    cfg = JaxConfig()
    tx, _ = jts.make_optimizer(cfg, 10)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), tx=tx)
    model = JaxUNet(in_channels=4, out_channels=4, attention_impl="xla",
                    dtype=jnp.dtype(dtype), param_dtype=jnp.bfloat16, **SMALL)
    step = jax.jit(jts.make_train_step(
        model, JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS),
        compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = _batch()
    new, loss = step(state, jnp.asarray(mix), {k: jnp.asarray(v) for k, v in targets.items()})
    mu = new.opt_state[1][0].mu
    return ({k: float(v) for k, v in loss.items()}, dict(_flat(new.params)),
            {str(a.dtype) for a in jax.tree_util.tree_leaves(mu)}
            | {str(a.dtype) for a in jax.tree_util.tree_leaves(new.opt_state[1][0].nu)})


def _bf16_spacing(a):
    """One bf16 spacing at each element's magnitude (8 significant bits)."""
    mag = np.maximum(np.abs(a), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_with_bf16_parameters_matches_jax(dtype):
    model = _port_model(dtype)
    variables = variables_from_state_dict(model.state_dict(), SMALL["depths"])
    start = {k: np.asarray(v).astype(np.float32) for k, v in _flat(variables["params"])}
    ref_loss, ref_params, ref_moments = _jax_step(variables, dtype)
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    state = pts.TrainState(0, model, tx)
    step = pts.make_train_step(
        model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS)
    mix, targets = _batch()
    state, loss = step(state, torch.from_numpy(mix),
                       {k: torch.from_numpy(v) for k, v in targets.items()})
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(loss["total_loss"]), ref_loss["total_loss"],
                               rtol=1e-5 if f32 else 2e-2)
    moments = {str(v.dtype) for s in tx.adamw.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")}
    assert moments == {"torch.bfloat16"} and ref_moments == {"bfloat16"}
    got = dict(_flat(variables_from_state_dict(model.state_dict(), SMALL["depths"])["params"]))
    zero = {k.split("/", 1)[1] for k in _zero_gradient_leaves()}
    agree, count = 0, 0
    for k, ref in ref_params.items():
        ours, ref = got[k], np.asarray(ref)
        assert ours.dtype == ref.dtype == np.dtype("bfloat16") and ours.shape == ref.shape, k
        if k in zero:
            continue
        o, r, before = ours.astype(np.float32), ref.astype(np.float32), start[k]
        tol = _bf16_spacing(np.maximum(np.abs(o), np.abs(r))) + 2.0 ** -5 * np.abs(r - before)
        agree += int((np.abs(o - r) <= tol).sum())
        count += r.size
    assert agree >= (0.999 if f32 else 0.95) * count, agree / count


def test_from_config_builds_bf16_parameters_for_every_route():
    for impl in ("pallas", "pallas_int8", "pallas_attn", "xla", "int8"):
        model = TFSWAUNet.from_config(_cfg(impl=impl))
        assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
        assert {b.dtype for n, b in model.named_buffers() if "running" in n} == {torch.float32}
