"""The port's separation metrics against the JAX package's on the same
numpy inputs: every function, batched and 1-D, full-signal and framewise
(with its torch.median lower-middle convention), within rtol 1e-4 and
atol 1e-4 dB (f32 sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfswa_tpu.evaluation import metrics as jm
from tfswa_tpu_torch.evaluation import metrics as pm

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((3, 2000)).astype(np.float32)
    est = (0.8 * ref + 0.3 * rng.standard_normal((3, 2000))).astype(np.float32)
    sources = rng.standard_normal((3, 4, 2000)).astype(np.float32)
    sources[:, 2] = ref
    return est, ref, sources


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["sdr", "si_sdr"])
@pytest.mark.parametrize("batched", [True, False])
def test_two_argument_metrics_match_jax(signals, fn, batched):
    est, ref, _ = signals
    if not batched:
        est, ref = est[0], ref[0]
    got = getattr(pm, fn)(_t(est), _t(ref)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jm, fn)(jnp.asarray(est), jnp.asarray(ref))),
                               **TOL)


@pytest.mark.parametrize("fn", ["sir", "sar"])
@pytest.mark.parametrize("batched", [True, False])
def test_source_metrics_match_jax(signals, fn, batched):
    est, ref, src = signals
    if not batched:
        est, ref, src = est[0], ref[0], src[0]
    got = getattr(pm, fn)(_t(est), _t(ref), _t(src)).numpy()
    want = getattr(jm, fn)(jnp.asarray(est), jnp.asarray(ref), jnp.asarray(src))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_bss_eval_matches_jax(signals):
    est, ref, src = signals
    got = pm.bss_eval(_t(est), _t(ref), _t(src))
    want = jm.bss_eval(jnp.asarray(est), jnp.asarray(ref), jnp.asarray(src))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def test_silent_estimate_and_shape_mismatch():
    ref = _t(np.ones(100, np.float32))
    np.testing.assert_allclose(float(pm.sdr(torch.zeros(100), ref)),
                               float(jm.sdr(jnp.zeros(100), jnp.ones(100))), **TOL)
    with pytest.raises(ValueError):
        pm.sdr(torch.zeros(3), torch.zeros(4))


@pytest.mark.parametrize("window", [3, 5])
def test_median_filter_matches_jax(window):
    v = np.random.default_rng(1).standard_normal(11).astype(np.float32)
    got = pm.median_filter_metrics({"a": _t(v), "s": torch.tensor(2.0)}, window)
    want = jm.median_filter_metrics({"a": jnp.asarray(v), "s": jnp.asarray(2.0)}, window)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]), **TOL)
    assert float(got["s"]) == 2.0


@pytest.mark.parametrize("segment", [None, 300, 500, 4000])
@pytest.mark.parametrize("with_sources", [True, False])
def test_metrics_calculator_matches_jax(signals, segment, with_sources):
    est, ref, src = signals
    src = src if with_sources else None
    got = pm.MetricsCalculator(8000, segment, device="cpu").compute(est, ref, src)
    want = jm.MetricsCalculator(8000, segment).compute(est, ref, src)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_framewise_median_is_the_lower_middle(signals):
    """Four segments: the median is the second smallest per-segment value."""
    est, ref, _ = signals
    calc = pm.MetricsCalculator(8000, 500, device="cpu")
    per_seg = pm.sdr(_t(est[0]).reshape(4, 500), _t(ref[0]).reshape(4, 500))
    assert calc.compute(est[0], ref[0])["sdr"] == pytest.approx(
        float(per_seg.sort().values[1]), rel=1e-6)


def test_compute_musdb_metrics_matches_jax(signals):
    est, ref, _ = signals
    ests = {"vocals": np.stack([est[0], est[0]]), "other": np.stack([est[1], est[1]]),
            "bass": np.stack([est[2], est[2]])}
    refs = {"vocals": np.stack([ref[0], ref[0]]), "other": np.stack([ref[1], ref[1]])}
    with pytest.warns(UserWarning, match="bass"):
        got = pm.compute_musdb_metrics(ests, refs, sample_rate=30, device="cpu")
    with pytest.warns(UserWarning, match="bass"):
        want = jm.compute_musdb_metrics(ests, refs, sample_rate=30)
    assert set(got) == set(want) == {"vocals", "other"}
    for stem in want:
        for k in want[stem]:
            np.testing.assert_allclose(got[stem][k], want[stem][k], **TOL)
