"""The port's multi-GPU path on CPU ranks: gloo process groups of spawned
processes (``tests/_torch_parallel_worker.py``, one intra-op thread each,
a file store under the test's temporary directory, a timeout on every
spawn) against one process, and against the JAX package on one device.

Two worlds run at once: two ranks (the training CLI on a (2, 1) mesh from
its multi-host flags, then the train and eval steps, the collectives of a
step and the separations at (2, 1) and (1, 2), the trainer's validation at
(2, 1)) and four ranks (the train step and the validation at (2, 2)).
The small config is the JAX package's ``tests/test_tensor_parallel.py``'s,
and so are the optimizer swap to
clip + SGD (Adam's first update is about lr * sign(g), so reduction-order
noise in near-zero gradients would flip signs) and the tolerances: loss
rtol 1e-5, parameters atol 2e-5 after the step; stems atol 1e-5.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parallel_worker as W

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(WORKER))
WORLDS = {"two": 2, "four": 4}
SPAWN_TIMEOUT_S = 300
TRAIN_CASES = {  # result name -> (one-process config kwargs, max_norm, steps)
    "train_21_xla": (dict(impl="xla"), 1.0, 1),
    "train_21_pallas": (dict(impl="pallas"), 1.0, 1),
    "train_12_xla": (dict(impl="xla"), 1.0, 1),
    "train_12_pallas": (dict(impl="pallas"), 1.0, 1),
    "train_22_xla": (dict(impl="xla"), 1.0, 1),
    "train_22_pallas": (dict(impl="pallas"), 1.0, 1),
    "train_21_remat": (dict(remat=True), 1.0, 1),
    "train_12_dropout": (dict(dropout=0.1), 1.0, 2),
    "train_12_clip": (dict(), 1e-3, 1),
}


def _one_process_results(out):
    """Every scenario in one process, and the JAX step, computed while the
    ranks run."""
    refs = {name: W.train_once(W.small_config(**kw), None, max_norm, steps)
            for name, (kw, max_norm, steps) in TRAIN_CASES.items()}
    refs.update({f"separate_{impl}": W.separate_all(impl) for impl in ("xla", "pallas")})
    refs["eval"] = W.eval_once(W.small_config())
    refs["validate"] = W.validate_once(str(out / "one"))
    refs["initial"] = {name: _initial_model(kw).state_dict()
                       for name, (kw, _, _) in TRAIN_CASES.items()}
    refs["jax"] = _jax_step()
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn both worlds, compute the one-process results meanwhile, wait
    for every rank (killing all at the timeout); returns ({group: rank 0's
    results}, the output dir, the one-process results)."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for group, world in WORLDS.items():
        d = out / group
        d.mkdir()
        for r in range(world):
            log = open(d / f"log{r}.txt", "w")
            procs.append((subprocess.Popen(
                [sys.executable, WORKER, group, str(world), str(r), str(d / "store"), str(d)],
                stdout=log, stderr=subprocess.STDOUT, env=env), log, d / f"log{r}.txt"))
    # the mesh scaling tool at dp = 1, 2, beside them
    log = open(out / "bench.txt", "w")
    procs.append((subprocess.Popen(
        [sys.executable, "-m", "tfswa_tpu_torch.tools.bench_mesh_scaling", "--device", "cpu",
         "--small", "--dps", "1,2", "--serve_seconds", "0.25", "--train_seconds", "0.128",
         "--timeout", str(SPAWN_TIMEOUT_S), "--json", str(out / "bench.json")],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log, out / "bench.txt"))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # beside the ranks' own threads
    try:
        refs = _one_process_results(out)
        for p, _, _ in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        torch.set_num_threads(threads)
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(path, p.returncode) for p, _, path in procs if p.returncode != 0]
    if bad:
        tails = "\n".join(f"{path} rc {rc}:\n" + open(path).read()[-3000:] for path, rc in bad)
        pytest.fail(f"a rank failed or hung:\n{tails}")
    return {g: torch.load(out / g / f"{g}.pt", weights_only=False) for g in WORLDS}, out, refs


def _result(ranks, name):
    res = ranks[0]
    return res["four"][name] if "_22" in name else res["two"][name]


def _assert_step_equal(got, want):
    (loss, params), (ref_loss, ref_params) = got, want
    assert set(loss) == set(ref_loss)
    for k, v in ref_loss.items():
        np.testing.assert_allclose(loss[k], v, rtol=1e-5, err_msg=k)
    assert set(params) == set(ref_params)
    for k, v in ref_params.items():
        np.testing.assert_allclose(params[k].numpy(), v.numpy(), atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_train_step_on_a_mesh_equals_one_process(ranks, name):
    ref = ranks[2][name]
    _assert_step_equal(_result(ranks, name), ref)
    before = ranks[2]["initial"][name]
    assert max(float((v - before[k]).abs().max()) for k, v in ref[1].items()) > 1e-6


def _initial_model(cfg_kw):
    from tfswa_tpu_torch.training.train_state import create_train_state

    return create_train_state(W.small_config(**cfg_kw), device="cpu")[0]


def _jax_step():
    """The JAX package's make_train_step on one device, plain attention,
    clip + SGD, from the port's seeded weights: (loss, whole params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tfswa_tpu.config import STFTConfig as JaxSTFTConfig
    from tfswa_tpu.models import TFSWAUNet as JaxUNet
    from tfswa_tpu.ops.stft import STFTProcessor as JaxProcessor
    from tfswa_tpu.training import train_state as jts
    from tfswa_tpu_torch.training.train_state import create_train_state
    from tfswa_tpu_torch.weights import variables_from_state_dict

    model, _ = create_train_state(W.small_config(), device="cpu")
    depths = W.SMALL["depths"]
    variables = variables_from_state_dict(model.state_dict(), depths)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(W.LR))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = jts.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                              variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx)
    jmodel = JaxUNet(attention_impl="xla", **W.SMALL)
    step = jax.jit(jts.make_train_step(
        jmodel, JaxProcessor(JaxSTFTConfig(n_fft=256, hop_length=64, sample_rate=W.SR)),
        W.STEMS), compiler_options={"xla_backend_optimization_level": 0})
    mix, targets = W.batch()
    new, loss = step(state, jnp.asarray(mix.numpy()),
                     {k: jnp.asarray(v.numpy()) for k, v in targets.items()})
    return {k: float(v) for k, v in loss.items()}, jax.tree_util.tree_map(np.asarray,
                                                                         new.params), depths


@pytest.mark.parametrize("name", ["train_21_xla", "train_12_xla", "train_22_xla"])
def test_train_step_on_a_mesh_equals_jax_on_one_device(ranks, name):
    from tfswa_tpu_torch.weights import variables_from_state_dict

    ref_loss, ref_params, depths = ranks[2]["jax"]
    loss, whole = _result(ranks, name)
    for k, v in ref_loss.items():
        np.testing.assert_allclose(loss[k], v, rtol=1e-5, err_msg=k)
    got = variables_from_state_dict(whole, depths)["params"]
    checked = 0

    def walk(a, b, path):
        nonlocal checked
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                walk(a[k], b[k], path + (k,))
        else:
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0, err_msg="/".join(path))
            checked += 1

    walk(got, ref_params, ())
    assert checked > 50


@pytest.mark.parametrize("track", sorted(W.TRACKS))
@pytest.mark.parametrize("name", ["separate_21_xla", "separate_12_xla", "separate_12_pallas"])
def test_separation_on_a_mesh_equals_one_process(ranks, name, track):
    ref = ranks[2]["separate_" + name.rsplit("_", 1)[1]][track]
    got = _result(ranks, name)[track]
    assert set(got) == set(ref)
    for stem in ref:
        assert got[stem].shape == ref[stem].shape == (1, int(W.SR * W.TRACKS[track]))
        np.testing.assert_allclose(got[stem], ref[stem], atol=1e-5, rtol=0, err_msg=stem)


@pytest.mark.parametrize("name", ["eval_21", "eval_12"])
def test_eval_step_on_a_mesh_equals_one_process(ranks, name):
    ref = ranks[2]["eval"]
    got = _result(ranks, name)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["validate_21", "validate_22"])
def test_validation_on_a_mesh_keeps_every_item(ranks, name):
    """Trainer.validate() on five items at a global batch of 4, where data
    rank 1's slice of the last batch is empty, equals one process's."""
    ref = ranks[2]["validate"]
    got = _result(ranks, name)
    assert set(got) == set(ref) and "total_loss" in ref
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)


def _counts_a_step(tp: bool) -> int:
    """The all_reduces of one sharded train step of the small model: every
    BatchNorm's statistics forward and backward (over the data axis, of 1
    rank too), the gradients, the losses; under TP each row block's two
    sums forward and two backward, and the clip's norm."""
    bns = 1 + 2 * 7 + 3 + 3 + 1               # stem, 7 TFSWABlocks, down, up, head
    return 2 * bns + 2 + (4 * 3 * 7 + 1 if tp else 0)


@pytest.mark.parametrize("name,tp", [("collectives_21", False), ("collectives_12", True)])
def test_collectives_of_a_step_from_its_trace(ranks, name, tp):
    stats = _result(ranks, name)
    assert stats["counts"] == {"all_reduce": _counts_a_step(tp)}
    grads = sum(t.numel() for k, t in ranks[2]["initial"]["train_21_xla"].items()
                if "running" not in k and "num_batches" not in k) * 4
    assert stats["bytes"]["all_reduce"] > (grads // 2 if tp else grads)


def test_clip_under_tp_takes_the_whole_gradients_norm(ranks):
    """The clip at 1e-3 engages, and the norm it divides by is the norm of
    the whole gradients (one process), not of a rank's shards."""
    loss, _ = _result(ranks, "train_12_clip")
    ref, _ = ranks[2]["train_12_clip"]
    assert loss["grad_norm"] > 1e-3
    np.testing.assert_allclose(loss["grad_norm"], ref["grad_norm"], rtol=1e-5)


def test_cli_on_two_ranks_writes_from_rank_0_and_resumes(ranks):
    d = ranks[1] / "two"
    seen = [json.load(open(d / f"two_rank{r}.json"))["cli"] for r in range(2)]
    assert seen == [{"main": True, "ckpt": True, "shard": 0, "shards": 2},
                    {"main": False, "ckpt": False, "shard": 1, "shards": 2}]
    assert sorted(os.listdir(d / "ck")) == ["config.json", "epoch_000000", "epoch_000001",
                                          "latest"]
    files = os.listdir(d / "logs")
    assert "metrics.jsonl" in files
    # TensorBoard's event files, where it imports, carry the writer's pid
    assert len({f.rsplit(".", 2)[1] for f in files if f.startswith("events.")}) <= 1
    recs = [json.loads(line) for line in open(d / "logs" / "metrics.jsonl")]
    steps = [r["step"] for r in recs if "train/total_loss" in r]
    assert steps == [1, 2, 3, 4]               # once a step: rank 1 wrote nothing
    from tfswa_tpu_torch.training.checkpointing import read_checkpoint

    tree, meta = read_checkpoint(str(d / "ck"), "latest")
    assert (meta["epoch"], meta["global_step"], tree["optimizer"]["count"]) == (1, 4, 4)


def test_mesh_scaling_tool_counts_each_ranks_share(ranks):
    """tools/bench_mesh_scaling at dp = 1, 2 on CPU ranks: the serving
    forward has no collective and half the FLOPs at dp = 2, its batch call
    one gather; the train step half the FLOPs, and its collectives are the
    BatchNorms' (forward and backward), the gradients' and the losses'."""
    rows = json.load(open(ranks[1] / "bench.json"))
    s1, s2 = rows["serving"]
    assert s1["collective_count"] == s2["collective_count"] == 0
    assert s2["per_rank_flops"] * 2 == s1["per_rank_flops"]
    assert s2["batch_call_collectives"] == {"all_reduce": 1}
    t1, t2 = rows["train"]
    assert t2["per_rank_flops"] * 2 == t1["per_rank_flops"]
    assert t1["collectives"] == t2["collectives"] == {"all_reduce": _counts_a_step(False)}
