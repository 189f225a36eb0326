"""The port's ``parallel`` package in one process, against the JAX
package's ``tfswa_tpu/parallel`` on its 8 virtual CPU devices: the mesh's
rank coordinates, the sharding rules, the loader's shards, the weight
shards in the JAX layout, the accounting; and, at world size 1, the
sharded steps and ``Trainer(mesh=)`` equal to the plain ones bit for bit.
The ranks' own tests are ``tests/test_torch_parallel_ranks.py``.  Also the
small API of this slice: the trainer's MFU, ``num_frames``,
``STFTProcessor.from_model_output``, the ops and training exports and
``PerceptualLoss``, each against JAX."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from tfswa_tpu.data.pipeline import DataLoader as JaxLoader
from tfswa_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from tfswa_tpu.parallel import analysis as janalysis
from tfswa_tpu.parallel import mesh as jmesh
from tfswa_tpu.parallel import sharding as jsharding
from tfswa_tpu_torch import parallel
from tfswa_tpu_torch.data.pipeline import DataLoader
from tfswa_tpu_torch.data.synthetic import SyntheticDataset
from tfswa_tpu_torch.models import TFSWAUNet
from tfswa_tpu_torch.ops.row_attention import dropout
from tfswa_tpu_torch.parallel.comm import gather_shards, shard_of
from tfswa_tpu_torch.parallel.mesh import Mesh
from tfswa_tpu_torch.training import train_state as pts
from tfswa_tpu_torch.parallel.sharding import shard_state_dict, tp_split, unshard_state_dicts
from tfswa_tpu_torch.weights import state_dict_from_jax, variables_from_state_dict

import _torch_parallel_worker as W

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Tier-1 runs six test workers on the machine's cores: two intra-op
    threads keep these CPU-bound steps from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_coordinates_follow_the_jax_mesh(shape):
    """Rank r of a (d, m) mesh sits where JAX's create_mesh puts device r."""
    devices = jax.devices()
    jm = jmesh.create_mesh(shape=shape, devices=devices)
    where = {int(dev.id): tuple(int(i) for i in np.argwhere(jm.devices == dev)[0])
             for dev in devices}
    d, m = shape
    for r in range(d * m):
        mesh = Mesh(d, m, r, torch.device("cpu"), groups=False)
        assert (mesh.data.index, mesh.model.index) == where[devices[r].id]
        # the axes' ranks: those that share the other coordinate, in order
        i, k = where[devices[r].id]
        assert mesh.data.ranks == tuple(devices.index(x) for x in jm.devices[:, k])
        assert mesh.model.ranks == tuple(devices.index(x) for x in jm.devices[i])
        assert mesh.shape == dict(jm.shape)


def test_create_mesh_fits_the_world_or_raises():
    assert parallel.process_info() == (0, 1)
    assert parallel.initialize_distributed() is False
    assert parallel.initialize_distributed(num_processes=1) is False
    for shape in (None, (1, 1), (-1, 1)):
        mesh = parallel.create_mesh(shape, device="cpu")
        assert mesh.shape == {"data": 1, "model": 1} and mesh.data.group is None
    for shape in ((2, 1), (1, 2), (-1, 2)):
        with pytest.raises(ValueError):
            parallel.create_mesh(shape, device="cpu")
    from tfswa_tpu_torch.config import MeshConfig

    assert parallel.mesh_from_config(MeshConfig(), device="cpu").shape == {"data": 1, "model": 1}


@pytest.fixture(scope="module")
def jax_variables():
    """The small model's variables in the JAX layout (the tree and leaf
    names of the JAX model's init, which ``test_torch_modules.py`` holds
    ``weights.mapping`` to), from the port's seeded weights: faster than
    the JAX init."""
    model = TFSWAUNet(generator=torch.Generator().manual_seed(0), **W.SMALL)
    return variables_from_state_dict(model.state_dict(), W.SMALL["depths"])


def test_param_spec_is_the_jax_spec_of_every_leaf(jax_variables):
    leaves = jax.tree_util.tree_leaves_with_path(jax_variables)
    assert len(leaves) > 100
    split = 0
    for path, leaf in leaves:
        for tp in (True, False):
            want = tuple(jsharding.param_spec(path, leaf, tp))
            assert parallel.param_spec(path, leaf, tp) == want, jax.tree_util.keystr(path)
            split += bool(want)
    assert split == 5 * 21                      # 5 weights of 21 row blocks
    sd = state_dict_from_jax(jax_variables, W.SMALL["depths"])
    specs = parallel.variables_shardings(sd, W.SMALL["depths"])
    assert sum(bool(v) for v in specs.values()) == 5 * 21
    assert all(bool(v) == (tp_split(k) is not None) for k, v in specs.items())


@pytest.mark.parametrize("size", [2, 4])
def test_weight_shards_are_the_heads_and_go_back_whole(jax_variables, size):
    """Each rank's qkv shard is the q, k and v of its heads (JAX layout
    columns), proj / fc2 its input rows, fc1 its output columns; the shards
    put back are the whole state_dict, and the JAX tree again."""
    depths = (1, 1, 1, 1)
    sd = state_dict_from_jax(jax_variables, depths)
    p = jax_variables["params"]["enc0_block0"]["tsa"]
    C = p["proj_kernel"].shape[0]
    shards = [shard_state_dict(sd, i, size) for i in range(size)]
    for i, sh in enumerate(shards):
        n = C // size
        q, k, v = (p["qkv_kernel"][:, j * C + i * n:j * C + (i + 1) * n] for j in range(3))
        np.testing.assert_array_equal(sh["encoder_stages.0.0.tsa.attn.qkv.weight"].numpy(),
                                      np.concatenate([q, k, v], axis=1).T)
        np.testing.assert_array_equal(sh["encoder_stages.0.0.tsa.attn.proj.weight"].numpy(),
                                      p["proj_kernel"][i * n:(i + 1) * n].T)
        h = p["fc1_kernel"].shape[1] // size
        np.testing.assert_array_equal(sh["encoder_stages.0.0.tsa.mlp.0.bias"].numpy(),
                                      p["fc1_bias"][i * h:(i + 1) * h])
    whole = unshard_state_dicts(shards)
    assert all(torch.equal(whole[k], v) for k, v in sd.items())
    back = variables_from_state_dict(whole, depths)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back["params"],
                           jax_variables["params"])


def test_gather_over_one_rank_and_shard_of_are_inverse():
    t = torch.arange(24.0).reshape(6, 4)
    axis = parallel.Axis("model", 1, 0, (0,))
    assert gather_shards(t, axis, 0, 3) is t
    halves = [shard_of(t, 0, 3, i, 2) for i in range(2)]
    assert torch.equal(halves[0], t[[0, 2, 4]]) and torch.equal(halves[1], t[[1, 3, 5]])


def test_dropout_shard_is_the_slice_of_the_whole_mask():
    x = torch.randn(3, 4, 8, 8)
    whole = dropout(x, 0.3, torch.Generator().manual_seed(5))
    for i in range(2):
        part = dropout(x[:, 2 * i:2 * i + 2], 0.3, torch.Generator().manual_seed(5), (1, i, 2))
        assert torch.equal(part, whole[:, 2 * i:2 * i + 2])


def test_ring_all_reduce_link_bytes_matches_jax():
    for payload, n in ((1 << 20, 1), (1 << 20, 2), (62_000_000, 4), (12345, 8)):
        assert parallel.ring_all_reduce_link_bytes(payload, n) == \
            janalysis.ring_all_reduce_link_bytes(payload, n)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, torn down after."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield parallel.create_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def test_collective_stats_of_a_recorded_trace(world_of_one):
    from torch.profiler import ProfilerActivity, profile

    axis = world_of_one.data
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        dist.all_reduce(torch.ones(3, 4), group=axis.group)
        dist.all_reduce(torch.ones(10, dtype=torch.bfloat16), group=axis.group)
        dist.broadcast(torch.zeros(1000, dtype=torch.float64), 0, group=axis.group)
        torch.ones(5) @ torch.ones(5)
    stats = parallel.collective_stats(prof)
    assert stats.counts == {"all_reduce": 2, "broadcast": 1}
    assert stats.bytes == {"all_reduce": 48 + 20, "broadcast": 8000}
    assert (stats.total_count, stats.total_bytes) == (3, 8068)
    assert parallel.collective_stats(prof.events()).counts == stats.counts
    flops, stats, out = parallel.analyze(lambda a: a @ a, torch.ones(4, 4))
    assert flops == 2 * 4 ** 3 and stats.total_count == 0 and out.shape == (4, 4)


def test_largest_tensor_bytes_reads_the_memory_trace():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        a = torch.zeros(1000, 250)
        b = torch.zeros(10)
        del a, b
    assert parallel.largest_tensor_bytes(prof) == 1_000_000


def _dataset(cls):
    return cls(num_tracks=8, track_seconds=1.0, segment_seconds=0.25, sample_rate=4000,
               random_segments=True, seed=5)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_loaders_reassemble_the_global_batches(shards):
    """Each data rank's loader gives its contiguous rows of the unsharded
    loader's global batches, which are the JAX loader's."""
    full = DataLoader(_dataset(SyntheticDataset), batch_size=4, num_workers=0, seed=3)
    jfull = JaxLoader(_dataset(JaxSynthetic), batch_size=4, num_workers=0, seed=3)
    parts = [DataLoader(_dataset(SyntheticDataset), batch_size=4, num_workers=0, seed=3,
                        num_shards=shards, shard_index=i) for i in range(shards)]
    n = 0
    for (gm, gt), (jm, _), *rows in zip(iter(full), iter(jfull), *map(iter, parts)):
        np.testing.assert_array_equal(gm, np.asarray(jm))
        np.testing.assert_array_equal(np.concatenate([m for m, _ in rows]), gm)
        for k in gt:
            np.testing.assert_array_equal(np.concatenate([t[k] for _, t in rows]), gt[k])
        n += 1
    assert n == len(full) == 2


def test_shard_batch_and_make_global_batch_at_world_size_one():
    mesh = parallel.create_mesh((1, 1), device="cpu")
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    assert torch.equal(parallel.shard_batch(x, mesh), torch.from_numpy(x))
    assert torch.equal(parallel.make_global_batch({"x": x}, mesh)["x"], torch.from_numpy(x))
    assert parallel.batch_sharding(mesh) == (1, 0) == parallel.replicated(mesh)


def test_data_axis_needs_the_models_batchnorm_over_it():
    mesh = parallel.create_mesh((1, 1), device="cpu")
    cfg = W.small_config()
    model, _ = pts.create_train_state(cfg, device="cpu")
    proc = W.STFTProcessor(cfg.stft)
    with pytest.raises(ValueError, match="BatchNorm"):
        pts.make_sharded_train_step(model, proc, W.STEMS, mesh)
    model, _ = pts.create_train_state(cfg, device="cpu", mesh=mesh)
    assert model.bn_axis is mesh.data and model.tp_axis is None
    pts.make_sharded_train_step(model, proc, W.STEMS, mesh)
    pts.make_sharded_eval_step(model, proc, W.STEMS, mesh)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_sharded_step_at_world_size_one_is_the_plain_step(world_of_one, impl):
    """A (1, 1) mesh over a real process group: the gradients' sum over one
    rank divided by 1, and the statistics' mean over one rank, change no
    bit of the loss or the parameters after two AdamW steps."""
    cfg = W.small_config(impl)
    mix, targets = W.batch(2)
    out = []
    for mesh in (None, world_of_one):
        model, state = pts.create_train_state(cfg, device="cpu", mesh=mesh)
        proc = W.STFTProcessor(cfg.stft)
        step = pts.make_train_step(model, proc, W.STEMS) if mesh is None else \
            pts.make_sharded_train_step(model, proc, W.STEMS, mesh)
        losses = [step(state, mix, targets)[1] for _ in range(2)]
        out.append(([{k: float(v) for k, v in loss.items()} for loss in losses],
                    model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_trainer_reports_mfu_against_the_cpus_peak(tmp_path, monkeypatch):
    """train/mfu reaches the metrics: 3 x one plain forward of the rank's
    rows, over the step time, over PEAK_FLOPS["cpu"] (one device)."""
    from tfswa_tpu_torch.config import DataConfig, TrainConfig
    from tfswa_tpu_torch.training import trainer as trainer_mod
    from tfswa_tpu_torch.training.trainer import Trainer
    from tfswa_tpu_torch.utils.profiling import PEAK_FLOPS, flops_of

    # the metric log's TensorBoard import (TensorFlow, about 10 s) is not
    # what this test is about
    monkeypatch.setattr(trainer_mod, "MetricLogger", lambda log_dir: trainer_mod._NullLogger())

    cfg = dataclasses.replace(
        W.small_config("xla"),
        data=DataConfig(segment_seconds=0.25, sample_rate=W.SR, batch_size=2, num_workers=0,
                        prefetch=1),
        train=TrainConfig(max_epochs=1, steps_per_epoch=2, log_every_n_steps=1,
                          checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "logs")))
    ds = SyntheticDataset(num_tracks=4, track_seconds=1.0, segment_seconds=0.25,
                          sample_rate=W.SR)
    trainer = Trainer(cfg, ds, device="cpu", mesh=parallel.create_mesh((1, 1), device="cpu"))
    metrics = trainer.train_epoch()
    plain = trainer.model.clone(attention_impl="xla").eval()
    x = torch.zeros(1, 4, 129, int(0.25 * W.SR) // 64 + 1)
    with torch.no_grad():
        want = 3 * 2 * flops_of(plain, x)
    timer = trainer._step_timer
    assert timer.flops_per_step == want and timer.peak == PEAK_FLOPS["cpu"]
    assert metrics["mfu"] == pytest.approx(want / metrics["step_time_s"] / PEAK_FLOPS["cpu"])


def test_stft_num_frames_and_from_model_output_match_jax():
    import importlib

    # both packages' ops re-export the function stft under the module's name
    jstft = importlib.import_module("tfswa_tpu.ops.stft")
    pstft = importlib.import_module("tfswa_tpu_torch.ops.stft")

    for n, center in ((1000, True), (1000, False), (4096, True), (257, False)):
        assert pstft.num_frames(n, 256, 64, center) == jstft.num_frames(n, 256, 64, center)
    rng = np.random.default_rng(0)
    out = rng.standard_normal((2, 4, 9, 5)).astype(np.float32)
    mix = (rng.standard_normal((2, 2, 9, 5)) + 1j * rng.standard_normal((2, 2, 9, 5))) \
        .astype(np.complex64)
    got = pstft.STFTProcessor.from_model_output(torch.from_numpy(out), torch.from_numpy(mix))
    want = jstft.STFTProcessor.from_model_output(jnp.asarray(out), jnp.asarray(mix))
    assert got.shape == (2, 2, 2, 9, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_ops_and_training_export_what_jax_exports():
    import tfswa_tpu.ops as jops
    import tfswa_tpu.training as jtraining
    import tfswa_tpu_torch.ops as pops
    import tfswa_tpu_torch.training as ptraining

    assert set(jops.__all__) <= set(pops.__all__)
    assert set(jtraining.__all__) <= set(ptraining.__all__)
    from tfswa_tpu.training.losses import PerceptualLoss as JaxPerceptual

    for cls in (ptraining.PerceptualLoss, JaxPerceptual):
        with pytest.raises(NotImplementedError, match="unimplemented"):
            cls(weights=None)(torch.zeros(1), torch.zeros(1))
