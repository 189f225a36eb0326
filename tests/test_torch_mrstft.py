"""The port's multi-resolution STFT loss against the JAX package's, on the
CPU:
  - ``multi_resolution_stft_loss`` on (B, C, S) and (B, S) audio, its value
    and its gradient with respect to the prediction, also against a float64
    reference (``torch.stft`` in float64);
  - ``source_separation_loss(use_mrstft=True)``: every key of the loss dict;
  - one ``make_train_step(use_mrstft=True, mrstft_weight=0.25)`` step under
    ``freq_policy="crop_pow2"`` (the Nyquist row zero-padded back before
    the iSTFT) against JAX's: the loss dict and every gradient, with the
    whole loss and with its magnitude terms alone.  The model and the JAX
    step are ``test_torch_train_step.py``'s, its plain ("xla") route on the
    JAX side, the port's "pallas" (the plain versions of B1-train and B2
    on the CPU) and "xla" routes;
  - the Trainer hands ``use_mrstft_loss`` and ``mrstft_weight`` to the step.

Tolerances (f32, sums in another order: FFT against the DFT matmul):
  - loss values: rtol 1e-5;
  - the gradient of the log-magnitude term is ill-conditioned in f32: at a
    bin it is the bin's phase over (|X| + 1e-5), and the rounding of X
    (about 2e-6 absolute here, 1e-7 of the frame's energy) turns the phase
    of a bin of magnitude 2e-3 by 1e-3 while it weighs 500 times more than
    a bin of the mean magnitude.  Against the float64 gradient both
    packages' f32 gradients miss by up to 3.4e-4 of its largest entry on
    this data (JAX: 1.9e-4 and 3.4e-4, the port 4e-5 and 3.4e-4).  So the
    port's distance from the float64 gradient is held to at most 1.1 times
    JAX's plus 1e-4 of the largest entry: no less accurate than the
    reference, the form ``chip_smoke.py`` holds B2 to;
  - the step's gradients: with the magnitude terms alone, as in
    ``test_torch_train_step.py`` (1e-4 of each leaf's largest magnitude
    plus 1e-6 of the largest gradient); with the whole loss, which adds the
    ill-conditioned term above, a cosine of at least 0.99999 and a relative
    L2 distance of at most 5e-3 over all the gradients (measured: 0.9999993
    and 1.2e-3), and grad_norm within 5e-3 relative.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.training import losses as jl
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, DataConfig, ModelConfig, STFTConfig, TrainConfig
from tfswa_tpu_torch.data.synthetic import SyntheticDataset
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.training import losses as pl
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.training import trainer as ptrainer
from tfswa_tpu_torch.weights import variables_from_state_dict

SR = 8000
SMALL = dict(depths=(1, 0, 0, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
STEMS = ("vocals", "other")
STEP = dict(mrstft_weight=0.25, use_mrstft=True, freq_policy="crop_pow2")


def _audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def _stft64(x, n_fft=2048, hop_length=512, win_length=None):
    """The port's STFT in float64 (torch.stft with a float64 window)."""
    win = torch.from_numpy(0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    return torch.stft(x, n_fft=n_fft, hop_length=hop_length, window=win, center=True,
                      pad_mode="reflect", return_complex=True)


@pytest.mark.parametrize("shape", [(2, 1, 4000), (3, 2600)], ids=["BCS", "BS"])
def test_multi_resolution_stft_loss_and_gradient_match_jax(shape, monkeypatch):
    pred, target = _audio(shape, 0), _audio(shape, 1)
    want, want_grad = jax.value_and_grad(jl.multi_resolution_stft_loss)(
        jnp.asarray(pred), jnp.asarray(target))
    x = torch.from_numpy(pred).requires_grad_()
    got = pl.multi_resolution_stft_loss(x, torch.from_numpy(target))
    got.backward()
    monkeypatch.setattr(pl, "stft", _stft64)
    x64 = torch.from_numpy(pred.astype(np.float64)).requires_grad_()
    pl.multi_resolution_stft_loss(x64, torch.from_numpy(target.astype(np.float64))).backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    exact = x64.grad.numpy()
    scale = np.abs(exact).max()
    port_err = np.abs(x.grad.numpy() - exact).max()
    jax_err = np.abs(np.asarray(want_grad) - exact).max()
    assert port_err <= 1.1 * jax_err + 1e-4 * scale


def test_source_separation_loss_with_mrstft_matches_jax():
    specs = {k: _audio((2, 65, 40), i) ** 2 for i, k in enumerate(STEMS)}
    targets = {k: _audio((2, 65, 40), 5 + i) ** 2 for i, k in enumerate(STEMS)}
    audios = {k: _audio((2, 1, 3000), 10 + i) for i, k in enumerate(STEMS)}
    t_audios = {k: _audio((2, 1, 3000), 20 + i) for i, k in enumerate(STEMS)}
    kw = dict(l1_weight=0.7, mrstft_weight=0.25, use_mrstft=True)
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}       # noqa: E731
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}            # noqa: E731
    got = pl.source_separation_loss(t(specs), t(targets), t(audios), t(t_audios), **kw)
    want = jl.source_separation_loss(j(specs), j(targets), j(audios), j(t_audios), **kw)
    assert set(got) == set(want) == {"total_loss", "l1_loss", "l1_vocals", "l1_other",
                                     "mrstft_loss", "mrstft_vocals", "mrstft_other"}
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="audios"):
        pl.source_separation_loss(t(specs), t(targets), use_mrstft=True)


def _flat(tree, prefix=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


def _batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    targets = {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32) for k in STEMS}
    return mix, targets


def _port_model(impl):
    return TFSWAUNet(4, 4, attention_impl=impl, generator=torch.Generator().manual_seed(0),
                     **SMALL)


TERMS = {"both": {}, "magnitude": dict(log_magnitude_weight=0.0)}


@contextlib.contextmanager
def _mrstft_terms(terms):
    """Both packages' loss dicts take the MR-STFT loss with these terms."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jl, pl):
            mp.setattr(mod, "multi_resolution_stft_loss",
                       functools.partial(mod.multi_resolution_stft_loss, **TERMS[terms]))
        yield


@pytest.fixture(scope="module", params=list(TERMS))
def jax_step(request):
    """One jitted JAX MR-STFT train step from the port's seeded weights:
    its loss dict and raw gradients (handed out through the optimizer's
    state, as in test_torch_train_step.py)."""
    with _mrstft_terms(request.param):
        return (request.param, *_jax_step())


def _jax_step():
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
        JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS, **STEP),
        compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = _batch()
    new, loss = step(state, jnp.asarray(mix), {k: jnp.asarray(v) for k, v in targets.items()})
    return {k: float(v) for k, v in loss.items()}, dict(_flat(new.opt_state))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mrstft_train_step_matches_jax(jax_step, impl):
    terms, ref_loss, ref_grads = jax_step
    with _mrstft_terms(terms):
        loss, got = _port_step(impl)
    assert set(loss) == set(ref_loss) and "mrstft_vocals" in loss
    for k, v in ref_loss.items():
        rtol = 5e-3 if (k, terms) == ("grad_norm", "both") else 1e-5
        np.testing.assert_allclose(float(loss[k]), v, rtol=rtol, err_msg=k)
    assert set(got) == set(ref_grads)
    if terms == "both":
        a, b = (np.concatenate([g[k].ravel() for k in sorted(ref_grads)]).astype(np.float64)
                for g in (got, ref_grads))
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.99999
        assert np.linalg.norm(a - b) <= 5e-3 * np.linalg.norm(b)
        return
    floor = 1e-6 * max(np.abs(g).max() for g in ref_grads.values())
    for k, ref in ref_grads.items():
        assert np.abs(got[k] - ref).max() <= 1e-4 * np.abs(ref).max() + floor, k


def _port_step(impl):
    """The port's step from the same weights and batch: its loss dict and
    the raw gradients, read just before the optimizer clips them."""
    model = _port_model(impl)
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    state = pts.TrainState(0, model, tx)
    step = pts.make_train_step(
        model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS,
        **STEP)
    grads = {}
    orig = tx.step
    tx.step = lambda: grads.update({n: p.grad.clone() for n, p in model.named_parameters()}) \
        or orig()
    mix, targets = _batch()
    state, loss = step(state, torch.from_numpy(mix),
                       {k: torch.from_numpy(v) for k, v in targets.items()})
    return loss, dict(_flat(variables_from_state_dict(grads, SMALL["depths"])["params"]))


def test_trainer_hands_the_mrstft_fields_to_the_step(tmp_path, monkeypatch):
    seen = {}
    real = ptrainer.make_train_step
    monkeypatch.setattr(ptrainer, "make_train_step",
                        lambda *a, **kw: seen.update(kw) or real(*a, **kw))
    cfg = Config(model=ModelConfig(**dict(SMALL, depths=(1, 1, 1, 1))),
                 stft=STFTConfig(n_fft=256, hop_length=64, sample_rate=SR),
                 data=DataConfig(segment_seconds=0.5, sample_rate=SR, batch_size=2,
                                 num_workers=0),
                 train=TrainConfig(use_mrstft_loss=True, mrstft_weight=0.25,
                                   checkpoint_dir=str(tmp_path / "ck"),
                                   log_dir=str(tmp_path / "logs")))
    ds = SyntheticDataset(num_tracks=2, track_seconds=1.0, segment_seconds=0.5, sample_rate=SR)
    trainer = ptrainer.Trainer(cfg, ds, device="cpu")
    assert (seen["use_mrstft"], seen["mrstft_weight"]) == (True, 0.25)
    trainer.logger.close()
