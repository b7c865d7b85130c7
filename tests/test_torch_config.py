"""The port's own config and registry copies against the JAX package's:
`default_config()` and the registered trainer configs are equal key for key,
and `Config` keeps its lock / attribute / deep-update semantics."""

import sys

import pytest

from cld_tpu.utils import config as jax_config
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.utils import config, registry


def _walk(a, b, path=""):
    assert type(a).__name__ == type(b).__name__, path
    if isinstance(a, dict):
        assert list(a) == list(b), path  # same keys, same order
        for k in a:
            _walk(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def test_default_config_equals_the_jax_package_key_for_key():
    ours, theirs = config.default_config(), jax_config.default_config()
    _walk(ours, theirs)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.algo.n_diffusion_steps == 100 and ours.train.training.batch_size == 128


@pytest.mark.parametrize("name", ["cld_vae_nusc", "cld_dm_nusc", "cld_ppo_nusc", "cld_smoke"])
def test_registered_trainer_configs_equal(name):
    ours = registry.get_registered_experiment_config(name)
    theirs = jax_registry.get_registered_experiment_config(name)
    _walk(ours, theirs)
    with pytest.raises(KeyError):  # locked: no new keys
        ours.algo.brand_new_key = 1


def test_registry_holds_only_the_trainer_entries():
    """The trainer entries and every row of the reference's registry (the
    zoo's and the gan / ebm / scene_dm modes'); a mode's row resolves to the
    JAX package's config; unknown names raise as before."""
    rows = {r[0] for r in jax_registry._REFERENCE_EXPERIMENTS}
    assert set(registry.EXP_CONFIG_REGISTRY) == rows | {
        "cld_dm_nusc", "cld_ppo_nusc", "cld_smoke", "cld_vae_nusc"}
    assert registry.get_registered_experiment_config("nusc_bc").train.mode == "zoo"
    ours = registry.get_registered_experiment_config("nusc_gan")
    _walk(ours, jax_registry.get_registered_experiment_config("nusc_gan"))
    assert ours.train.mode == "gan"
    with pytest.raises(KeyError, match="unknown experiment"):
        registry.get_registered_experiment_config("nusc_nope")


def test_config_semantics_and_yaml_overlay(tmp_path):
    cfg = config.Config({"a": {"b": 1}, "c": 2})
    assert cfg.a.b == 1 and isinstance(cfg.a, config.Config)
    cfg.lock()
    cfg.a.b = 5  # existing keys stay writable
    with pytest.raises(KeyError):
        cfg.a.z = 1
    with pytest.raises(AttributeError):
        cfg.missing
    cfg.unlock().update_deep({"a": {"z": 3}, "d": {"e": 4}})
    assert cfg.to_dict() == {"a": {"b": 5, "z": 3}, "c": 2, "d": {"e": 4}}
    path = tmp_path / "c.yaml"
    path.write_text("train:\n  data_path: synthetic\n  training:\n    batch_size: 4\n")
    ours, theirs = config.load_config(str(path)), jax_config.load_config(str(path))
    _walk(ours, theirs)
    assert ours.train.training.batch_size == 4 and ours.train.data_path == "synthetic"
    ours.dump_json(str(tmp_path / "c.json"))
    assert '"batch_size": 4' in (tmp_path / "c.json").read_text()


def test_json_config_without_pyyaml_and_the_cli_flags(tmp_path, monkeypatch):
    """A `.json` config is read without PyYAML (absent on some hosts), equal
    to the JAX package's reading of it; `config_from_flags` resolves the
    CLIs' `--registered-name` / `--config` as the JAX CLIs do."""
    path = tmp_path / "c.json"
    path.write_text('{"train": {"training": {"steps_per_epoch": 1}}, "algo": {"base_dim": 16}}')
    theirs = jax_config.load_config(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    ours = config.load_config(str(path))
    _walk(ours, theirs)
    assert ours.train.training.steps_per_epoch == 1 and ours.algo.base_dim == 16
    smoke = registry.config_from_flags("cld_smoke", str(path))
    assert smoke.algo.base_dim == 16 and smoke.env.rasterizer.raster_size == 64
    _walk(registry.config_from_flags("cld_smoke"), jax_registry.get_registered_experiment_config(
        "cld_smoke"))
    _walk(registry.config_from_flags(None, str(path)), theirs)
    _walk(registry.config_from_flags(), jax_config.default_config())
    with pytest.raises(KeyError):
        smoke.algo.no_such_key = 1  # locked
