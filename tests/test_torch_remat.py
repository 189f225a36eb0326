"""Remat (``ModelConfig.remat``: each TFSWABlock under
``torch.utils.checkpoint``) on the CPU, with ``test_torch_train_step.py``'s
small model and batch:
  - one step with remat equals one without, route by route: loss, every
    gradient, the BatchNorm running stats and ``num_batches_tracked``
    within f32 rounding (rtol 1e-6; they are the same operations in the
    same order, and agree bit for bit here);
  - the recompute leaves the running stats alone: each BatchNorm counts
    one batch a step;
  - one step with remat equals the JAX ``make_train_step`` with
    ``remat=True`` within ``test_torch_train_step.py``'s tolerances;
  - the save policies ("dots", "dots_no_batch", "everything"): a step
    under each equals the step without remat as above; on a small function
    (two matmuls, a GELU, a bmm) the gradients equal those without
    checkpointing bit for bit, and the ops the backward runs again (counted
    with a TorchDispatchMode) are those whose outputs the same JAX policy
    does not save (``jax.ad_checkpoint.print_saved_residuals``);
  - the helpers of ``optimization/remat.py``.
"""
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
from tfswa_tpu.models import TFSWAUNet as JaxUNet
from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
from tfswa_tpu.optimization import remat as jremat
from tfswa_tpu.training import train_state as jts
from tfswa_tpu_torch.config import Config, ModelConfig, STFTConfig
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.models.layers import frozen_stats
from tfswa_tpu_torch.ops.stft import STFTProcessor
from tfswa_tpu_torch.optimization import remat as premat
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.weights import variables_from_state_dict

SR = 8000
SMALL = dict(depths=(1, 0, 0, 1), dims=(8, 16, 32, 64), window_size=4, shift_size=2,
             num_heads=2)
STEMS = ("vocals", "other")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound steps from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    mix = (rng.standard_normal((2, 2, 2000)) * 0.3).astype(np.float32)
    targets = {k: (rng.standard_normal((2, 2, 2000)) * 0.2).astype(np.float32) for k in STEMS}
    return mix, targets


def _step(impl, remat, depths=SMALL["depths"], policy="none"):
    """One port train step: (loss, raw gradients, state_dict after)."""
    model = TFSWAUNet(4, 4, attention_impl=impl, remat=remat,
                      generator=torch.Generator().manual_seed(0), **dict(SMALL, depths=depths))
    model.remat_policy = policy
    tx, _ = pts.make_optimizer(Config(), 10, model.parameters())
    state = pts.TrainState(0, model, tx)
    step = pts.make_train_step(
        model, STFTProcessor(STFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS)
    grads = {}
    orig = tx.step
    tx.step = lambda: grads.update({n: p.grad.clone() for n, p in model.named_parameters()}) \
        or orig()
    mix, targets = _batch()
    _, loss = step(state, torch.from_numpy(mix),
                   {k: torch.from_numpy(v) for k, v in targets.items()})
    return ({k: float(v) for k, v in loss.items()}, grads,
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("impl,policy", [("pallas", "none"), ("pallas_attn", "none"),
                                         ("xla", "none"), ("pallas", "dots"), ("xla", "dots"),
                                         ("xla", "dots_no_batch"), ("xla", "everything")])
def test_remat_step_equals_the_step_without(impl, policy):
    depths = (1, 1, 1, 2)           # every stage, a W-MSA and an SW-MSA block
    (la, ga, sa), (lb, gb, sb) = (_step(impl, False, depths),
                                  _step(impl, True, depths, policy))
    assert la.keys() == lb.keys()
    for k in la:
        assert lb[k] == pytest.approx(la[k], rel=1e-6), k
    assert ga.keys() == gb.keys()
    for k in ga:
        torch.testing.assert_close(gb[k], ga[k], rtol=1e-6, atol=1e-6 * float(ga[k].abs().max()))
    for k in sa:
        if k.endswith("num_batches_tracked"):
            assert int(sa[k]) == int(sb[k]) == 1, k
        else:
            torch.testing.assert_close(sb[k], sa[k], rtol=1e-6, atol=1e-7)


def test_remat_runs_only_in_train_mode_with_autograd(monkeypatch):
    model = TFSWAUNet(4, 4, remat=True, generator=torch.Generator().manual_seed(0), **SMALL)
    calls = []
    import tfswa_tpu_torch.models.tfswa_unet as mod
    real = mod.checkpoint
    monkeypatch.setattr(mod, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 4, 33, 12)
    model(x)                                   # eval mode
    model.train()
    with torch.no_grad():
        model(x)
    assert not calls
    model(x).sum().backward()
    assert len(calls) == sum(SMALL["depths"][:3]) * 2 + SMALL["depths"][3]


def test_frozen_stats_normalises_but_leaves_the_running_stats():
    from tfswa_tpu_torch.models.layers import batch_norm

    bn = torch.nn.BatchNorm2d(3).train()
    x = torch.randn(2, 5, 4, 3)
    y0 = batch_norm(x, bn)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with frozen_stats(bn):
        y1 = batch_norm(x, bn)
    torch.testing.assert_close(y1, y0, rtol=0, atol=0)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    batch_norm(x, bn)
    assert int(bn.num_batches_tracked) == 2


@pytest.fixture(scope="module")
def jax_remat_step():
    """The JAX step with remat=True from the port's seeded weights:
    loss_dict, raw gradients, batch_stats after the step."""
    def flat(tree, prefix=()):
        if hasattr(tree, "items"):
            for k, v in tree.items():
                yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix), np.asarray(tree, np.float32)

    port = TFSWAUNet(4, 4, generator=torch.Generator().manual_seed(0), **SMALL)
    variables = variables_from_state_dict(port.state_dict(), SMALL["depths"])
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        opt_state=capture.init(params), tx=capture)
    step = jax.jit(jts.make_train_step(
        JaxUNet(in_channels=4, out_channels=4, attention_impl="xla", remat=True, **SMALL),
        JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=SR)), STEMS),
        compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = _batch()
    new, loss = step(state, jnp.asarray(mix), {k: jnp.asarray(v) for k, v in targets.items()})
    return ({k: float(v) for k, v in loss.items()}, dict(flat(new.opt_state)),
            dict(flat(new.batch_stats)), flat)


def test_remat_step_matches_jax_remat(jax_remat_step):
    ref_loss, ref_grads, ref_bs, flat = jax_remat_step
    loss, grads, sd = _step("pallas", True)
    assert set(ref_loss) <= set(loss)
    for k, v in ref_loss.items():
        np.testing.assert_allclose(loss[k], v, rtol=1e-5, err_msg=k)
    got = dict(flat(variables_from_state_dict(grads, SMALL["depths"])["params"]))
    assert set(got) == set(ref_grads)
    floor = 1e-6 * max(np.abs(g).max() for g in ref_grads.values())
    for k, ref in ref_grads.items():
        assert np.abs(got[k] - ref).max() <= 1e-4 * np.abs(ref).max() + floor, k
    got_bs = dict(flat(variables_from_state_dict(sd, SMALL["depths"])["batch_stats"]))
    for k, ref in ref_bs.items():
        np.testing.assert_allclose(got_bs[k], ref, atol=1e-5, rtol=0, err_msg=k)


def test_from_config_carries_remat():
    cfg = ModelConfig(in_channels=4, out_channels=4, remat=True, **SMALL)
    assert TFSWAUNet.from_config(cfg).remat
    assert premat.CheckpointConfig().apply(ModelConfig()).remat
    assert not premat.CheckpointConfig(enabled=False).apply(cfg).remat
    from tfswa_tpu.config import ModelConfig as JaxModelConfig

    for policy in premat.POLICIES:            # any policy, as the JAX object takes it
        for enabled in (True, False):
            ours = premat.CheckpointConfig(enabled, policy).apply(cfg)
            ref = jremat.CheckpointConfig(enabled, policy).apply(JaxModelConfig())
            assert ours.remat == ref.remat == enabled
            assert ours.dims == cfg.dims


def test_checkpoint_fn_recomputes_and_refuses_save_policies():
    """The name is older than the save policies (refused until they were
    ported): every JAX policy is taken, and an unknown name raises
    ValueError, as JAX's checkpoint_fn does."""
    x = torch.randn(5, requires_grad=True)
    for policy in premat.POLICIES:
        x.grad = None
        f = premat.checkpoint_fn(lambda t: (t.sin() * t).sum(), policy)
        f(x).backward()
        torch.testing.assert_close(x.grad, x.detach().cos() * x.detach() + x.detach().sin())
    assert set(premat.POLICIES) == set(jremat.POLICIES)
    with pytest.raises(ValueError, match="unknown remat policy"):
        jremat.checkpoint_fn(lambda t: t, "some")
    with pytest.raises(ValueError, match="unknown remat policy"):
        premat.checkpoint_fn(lambda t: t, "some")


# the small function of the policy tests, one op a line, in both frameworks
# (keys: the ops' names below; the JAX residuals name their source line)
POLICY_OPS = ("mm1", "gelu", "mm2", "bmm")


def _policy_inputs():
    rng = np.random.default_rng(0)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((3, 5, 8), (8, 16), (16, 8), (3, 8, 5))]


def _torch_fn(x, w1, w2, y):
    a = x @ w1                                    # mm1
    h = torch.nn.functional.gelu(a)               # gelu
    z = h @ w2                                    # mm2
    b = torch.bmm(z, y)                           # bmm
    return (b * b).sum() + (z * z).sum()


def _jax_fn(x, w1, w2, y):
    a = x @ w1                                    # mm1
    h = jax.nn.gelu(a, approximate=False)         # gelu
    z = h @ w2                                    # mm2
    b = jnp.einsum("bnc,bcm->bnm", z, y)          # bmm
    return (b * b).sum() + (z * z).sum()


def _jax_saved_ops(policy):
    """The ops of POLICY_OPS whose outputs (or, for the GELU, any of its
    inner values) JAX's policy keeps as residuals, from
    print_saved_residuals' source lines."""
    import inspect

    from jax.ad_checkpoint import print_saved_residuals

    src, first = inspect.getsourcelines(_jax_fn)
    lines = {op: first + i for i, l in enumerate(src) for op in POLICY_OPS
             if l.rstrip().endswith(f"# {op}")}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(jremat.checkpoint_fn(_jax_fn, policy),
                              *map(jnp.asarray, _policy_inputs()))
    saved = {int(m) for m in re.findall(r"test_torch_remat\.py:(\d+)", buf.getvalue())}
    return {op for op, line in lines.items() if line in saved}


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The ATen ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _backward_ops(fn, inputs):
    """The products and GELUs the backward of fn runs, as a multiset."""
    leaves = [torch.from_numpy(a).requires_grad_(i < 3) for i, a in enumerate(inputs)]
    out = fn(*leaves)
    with _Ops() as mode:
        grads = torch.autograd.grad(out, leaves[:3])
    names = [n for n in mode.ops if n in ("mm", "bmm", "gelu")]
    return grads, {n: names.count(n) for n in ("mm", "bmm", "gelu")}


@pytest.mark.parametrize("policy", ["none", "dots", "dots_no_batch", "everything"])
def test_save_policy_recomputes_what_jax_does_not_save(policy):
    inputs = _policy_inputs()
    ref_grads, plain = _backward_ops(_torch_fn, inputs)
    grads, ops = _backward_ops(premat.checkpoint_fn(_torch_fn, policy), inputs)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)
    again = {n: ops[n] - plain[n] for n in ops}        # the forward's ops run again
    ran = {op for op, n in (("mm1", again["mm"] >= 1), ("mm2", again["mm"] >= 2),
                            ("gelu", again["gelu"] >= 1), ("bmm", again["bmm"] >= 1)) if n}
    saved = _jax_saved_ops(policy)
    # JAX recomputes an op that its policy does not keep and that the
    # backward needs: the GELU's input (mm1) only where the GELU's own
    # values are not kept
    needed = set(POLICY_OPS) - ({"mm1"} if "gelu" in saved else set())
    assert ran == needed - saved, (again, saved)


@pytest.mark.parametrize("args", [(4, 1024, 512, (32, 64, 128, 256), (2, 2, 6, 2), 2),
                                  (1, 513, 259, (8, 16, 32, 64), (1, 1, 1, 1), 4)])
def test_activation_estimate_matches_jax(args):
    assert premat.estimate_activation_memory(*args) == \
        pytest.approx(jremat.estimate_activation_memory(*args), rel=1e-12)


def test_memory_reports_are_empty_without_a_card(monkeypatch):
    from tfswa_tpu_torch.utils.profiling import device_memory_report

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert premat.get_memory_stats() == {} == device_memory_report()
