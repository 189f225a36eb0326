"""The port's training pieces against the JAX package, on the CPU: the
optimizer and its schedule against optax, train-mode BatchNorm against
flax, ``from_config``'s refusals, the eval step, the Nyquist crop, the
train-step options not ported yet and the synthetic dataset.  The whole
step is in ``test_torch_train_step.py``.

Tolerances: the optimizer, fed identical gradients, 1e-6 (the same f32
update arithmetic) and its schedule 1e-6 relative; BatchNorm's output
1e-5 and its running stats 1e-6 (f32 statistics over 360 values); the
dataset bit for bit (the same numpy code and seeds).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from tfswa_tpu.config import Config as JaxConfig
from tfswa_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig, TrainConfig
from tfswa_tpu_torch.data import SyntheticDataset
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.models.layers import batch_norm
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import train_state as pts

SR = 8000
SMALL = dict(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64), window_size=4,
             shift_size=2, num_heads=2)
STEMS = ("vocals", "other")


def _batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    targets = {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32)
               for k in STEMS}
    return mix, targets


def _port_model(impl):
    return TFSWAUNet(4, 4, attention_impl=impl,
                     generator=torch.Generator().manual_seed(0), **SMALL)


def test_optimizer_matches_optax_with_warmup():
    cfg_j, cfg_p = JaxConfig(), Config()
    for c in (cfg_j, cfg_p):
        c.train.warmup_steps, c.train.max_epochs = 2, 1
    tx_j, sched_j = jts.make_optimizer(cfg_j, 6)
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params_t = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    tx_p, sched_p = pts.make_optimizer(cfg_p, 6, params_t)
    params_j = [jnp.asarray(a) for a in init]
    opt_state = tx_j.init(params_j)
    for step in range(4):
        grads = [(rng.standard_normal(s) * (3.0 if step % 2 else 0.1)).astype(np.float32)
                 for s in shapes]
        updates, opt_state = tx_j.update([jnp.asarray(g) for g in grads], opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        for p, g in zip(params_t, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = tx_p.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            [jnp.asarray(g) for g in grads])), rtol=1e-6)
        for a, b in zip(params_t, params_j):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
    for count in (0, 1, 2, 3, 5, 6, 9):
        np.testing.assert_allclose(sched_p(count), float(sched_j(count)), rtol=1e-6)


def test_batch_norm_train_mode_matches_flax():
    """Train-mode BN normalises with the batch's biased variance and updates
    the running stats as flax does (momentum 0.9), in f32."""
    import flax.linen as fnn

    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2.0 + 0.5).astype(np.float32)
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 6).astype(np.float32)))
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                            "bias": jnp.asarray(bn.bias.detach().numpy())},
                 "batch_stats": {"mean": jnp.asarray(bn.running_mean.numpy()),
                                 "var": jnp.asarray(bn.running_var.numpy())}}
    ref, upd = fbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn.train()
    out = batch_norm(torch.from_numpy(x), bn)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=0)
    bn.eval()                                      # eval mode reads the running stats
    y = batch_norm(torch.from_numpy(x), bn)
    ref_eval = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_eval), atol=1e-5, rtol=0)


@pytest.mark.parametrize("field,value", [("remat", True), ("param_dtype", "bfloat16")])
def test_from_config_raises_on_unported_fields(field, value):
    cfg = ModelConfig(in_channels=4, out_channels=4, **SMALL, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        TFSWAUNet.from_config(cfg)


def test_eval_step_keeps_running_stats_and_matches_eval_forward():
    model = _port_model("pallas")
    proc = STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR))
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    state = pts.TrainState(0, model, tx)
    mix, targets = _batch()
    mix_t = torch.from_numpy(mix)
    targets_t = {k: torch.from_numpy(v) for k, v in targets.items()}
    step = pts.make_train_step(model, proc, STEMS)
    state, _ = step(state, mix_t, targets_t)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = pts.make_eval_step(model, proc, STEMS)(state, mix_t, targets_t)
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    spec = proc.stft(mix_t)
    with torch.no_grad():
        out = model(proc.to_model_input(spec))
    mag = spec.mean(dim=1).abs()
    pairs = out.reshape(2, 2, 2, *out.shape[2:])
    pred = torch.sigmoid(torch.sqrt(pairs[:, :, 0] ** 2 + pairs[:, :, 1] ** 2 + 1e-8)) * mag[:, None]
    l1 = [(pred[:, i] - proc.stft(targets_t[k]).mean(dim=1).abs()).abs().mean()
          for i, k in enumerate(STEMS)]
    torch.testing.assert_close(loss["total_loss"], (l1[0] + l1[1]) / 2)


def test_crop_pow2_drops_the_nyquist_row():
    spec = torch.zeros(2, 2, 129, 5)
    assert pts._crop_nyquist(spec).shape[-2] == 128
    assert pts._crop_nyquist(spec[..., :128, :]).shape[-2] == 128


@pytest.mark.parametrize("kw", [dict(use_mrstft=True), dict(spec_augment=object()),
                                dict(data_axis="data")])
def test_unported_train_step_options_raise(kw):
    with pytest.raises(NotImplementedError):
        pts.make_train_step(_port_model("xla"), STFTProcessor(STFTConfig()), STEMS, **kw)


@pytest.mark.parametrize("field", ["use_mrstft_loss", "checkpoint_dir", "steps_per_epoch"])
def test_train_config_refuses_options_nothing_reads(field):
    """TrainConfig keeps only the fields the port reads: an option that no
    code honours is refused, not dropped."""
    assert hasattr(JaxConfig().train, field)
    with pytest.raises(TypeError, match=field):
        TrainConfig(**{field: getattr(JaxConfig().train, field)})


def test_synthetic_dataset_matches_jax():
    kw = dict(num_tracks=3, track_seconds=1.0, segment_seconds=0.5, sample_rate=SR, seed=3)
    a, b = SyntheticDataset(**kw), JaxSynthetic(**kw)
    assert len(a) == len(b)
    for i in range(len(a)):
        (ma, ta), (mb, tb) = a[i], b[i]
        np.testing.assert_array_equal(ma, mb)
        for k in tb:
            np.testing.assert_array_equal(ta[k], tb[k])
