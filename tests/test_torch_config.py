"""The port's Config against the JAX package's: the shipped YAMLs, the
YAML round trip, the override parser, and the refusals (an unknown key;
``model.attn_chunk_size``, which the port does not read, set off its JAX
default).  Exact
comparisons: configs hold no arithmetic."""
import dataclasses
from pathlib import Path

import pytest

from tfswa_tpu import config as jcfg
from tfswa_tpu_torch.config import Config, DataConfig, MeshConfig, ModelConfig, TrainConfig, _parse_value

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml"))


def test_every_jax_field_is_ported_or_listed_as_unported():
    """Every section and field, the mesh's too, at the JAX defaults."""
    port, jax = Config().to_dict(), jcfg.Config().to_dict()
    for section, fields in jax.items():
        for attr, value in fields.items():
            assert port[section][attr] == value, (section, attr)
    assert port == jax


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_yaml_loads_as_in_the_jax_package(path):
    assert len(CONFIGS) == 3
    port = Config.from_yaml(str(path))
    assert port.to_dict() == jcfg.Config.from_yaml(str(path)).to_dict()


def test_yaml_round_trip_is_the_identity(tmp_path):
    cfg = Config.from_yaml(str(CONFIGS[-1])).apply_overrides(
        ["model.dims=(16,32,64,128)", "data.aug_gain_db=(-3.0,3.0)", "train.seed=7"])
    cfg.to_yaml(str(tmp_path / "c.yaml"))
    assert Config.from_yaml(str(tmp_path / "c.yaml")) == cfg


@pytest.mark.parametrize("raw,current", [
    ("true", False), ("0", True), ("yes", False), ("(16,32,64,128)", (1, 2)),
    ("[0.8, 1.2]", (0.9, 1.1)), ("(vocals,drums)", ("a",)), ("7", 3), ("1e-3", 0.1),
    ("none", None), ("12", None), ("abc", None), ("bfloat16", "float32"), (" 5 ", 1)])
def test_parse_value_matches_jax(raw, current):
    got, want = _parse_value(raw, current), jcfg._parse_value(raw, current)
    assert got == want and type(got) is type(want)


def test_apply_overrides_matches_jax():
    ovs = ["model.dims=(16,32,64,128)", "model.remat=true", "train.learning_rate=0.001",
           "data.batch_size=8", "model.dtype=bfloat16", "data.stems=(vocals,other)",
           "train.steps_per_epoch=4", "train.sdr_eval_num_tracks=2", "data.mixup=yes",
           "train.use_mrstft_loss=false", "mesh.model_axis=1"]
    port = Config().apply_overrides(ovs)
    assert port.to_dict() == jcfg.Config().apply_overrides(ovs).to_dict()
    assert Config().model.remat is False


@pytest.mark.parametrize("override", ["mesh.data_axis=4", "mesh.model_axis=2"])
def test_mesh_fields_load_and_round_trip_as_in_jax(override, tmp_path):
    port = Config().apply_overrides([override])
    assert port.to_dict() == jcfg.Config().apply_overrides([override]).to_dict()
    port.to_yaml(str(tmp_path / "c.yaml"))
    assert Config.from_yaml(str(tmp_path / "c.yaml")) == port
    assert dataclasses.asdict(MeshConfig()) == dataclasses.asdict(jcfg.MeshConfig())


@pytest.mark.parametrize("value", [8, 32])
def test_attn_chunk_size_loads_at_its_default_and_raises_otherwise(value):
    assert Config.from_dict({"model": {"attn_chunk_size": 16}}) == Config()
    with pytest.raises(NotImplementedError, match="model.attn_chunk_size"):
        Config.from_dict({"model": {"attn_chunk_size": value}})
    with pytest.raises(NotImplementedError, match="model.attn_chunk_size"):
        Config().apply_overrides([f"model.attn_chunk_size={value}"])
    with pytest.raises(NotImplementedError, match="model.attn_chunk_size"):
        ModelConfig(attn_chunk_size=value)


@pytest.mark.parametrize("d", [{"train": {"bogus": 1}}, {"nosuch": {}}, {"model": {"remats": True}}])
def test_unknown_key_raises(d):
    with pytest.raises(ValueError, match="unknown config"):
        Config.from_dict(d)


@pytest.mark.parametrize("key", ["train.bogus", "to_dict.x", "nosuch.x", "train"])
def test_unknown_override_raises(key):
    with pytest.raises(ValueError, match=key):
        Config().apply_overrides([f"{key}=1"])


def test_data_and_train_fields_are_the_jax_ones():
    assert [f.name for f in dataclasses.fields(DataConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.DataConfig)]
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.TrainConfig)]


@pytest.mark.parametrize("override", ["train.use_mrstft_loss=true", "train.mrstft_weight=0.25"])
def test_mrstft_fields_round_trip_as_in_jax(override, tmp_path):
    port = Config().apply_overrides([override])
    assert port.to_dict() == jcfg.Config().apply_overrides([override]).to_dict()
    port.to_yaml(str(tmp_path / "c.yaml"))
    assert Config.from_yaml(str(tmp_path / "c.yaml")) == port
    jax_back = jcfg.Config.from_yaml(str(tmp_path / "c.yaml"))
    assert (jax_back.train.use_mrstft_loss, jax_back.train.mrstft_weight) == \
        (port.train.use_mrstft_loss, port.train.mrstft_weight)
