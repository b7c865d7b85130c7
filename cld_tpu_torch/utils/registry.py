"""Named experiment configs (the port's own copy of the entries of
`cld_tpu/utils/registry.py` that the VAE / DM / PPO trainers use): the three
stages of record and the `cld_smoke` sizes. The dataset and model-zoo axes of
the JAX registry are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from cld_tpu_torch.utils.config import Config, default_config, load_config

EXP_CONFIG_REGISTRY: Dict[str, Callable[[], Config]] = {}


def register_experiment(name: str):
    def deco(fn: Callable[[], Config]):
        EXP_CONFIG_REGISTRY[name] = fn
        return fn

    return deco


def get_registered_experiment_config(name: str) -> Config:
    """The locked config registered under `name`."""
    if name not in EXP_CONFIG_REGISTRY:
        raise KeyError(
            f"unknown experiment {name!r}; registered: {sorted(EXP_CONFIG_REGISTRY)}"
        )
    return EXP_CONFIG_REGISTRY[name]().lock()


def config_from_flags(registered_name: Optional[str] = None,
                      config_path: Optional[str] = None) -> Config:
    """The CLIs' `--registered-name` / `--config`: the registered config with
    the file over it, the file over the defaults, or the config of record;
    locked."""
    if registered_name:
        cfg = get_registered_experiment_config(registered_name)
        return load_config(config_path, base=cfg.unlock()) if config_path else cfg
    return load_config(config_path) if config_path else default_config().lock()


@register_experiment("cld_vae_nusc")
def _cld_vae():
    cfg = default_config()
    cfg.train.mode = "vae"
    return cfg


@register_experiment("cld_dm_nusc")
def _cld_dm():
    cfg = default_config()
    cfg.train.mode = "dm"
    return cfg


@register_experiment("cld_ppo_nusc")
def _cld_ppo():
    cfg = default_config()
    cfg.train.mode = "ppo"
    return cfg


@register_experiment("cld_smoke")
def _cld_smoke():
    """Tiny everything — CI / laptop smoke runs."""
    cfg = default_config()
    cfg.algo.curr_state_feat_dim = 16
    cfg.algo.map_feature_dim = 32
    cfg.algo.cond_feat_dim = 32
    cfg.algo.base_dim = 8
    cfg.algo.vae.hidden_size = 16
    cfg.algo.n_diffusion_steps = 5
    cfg.train.training.batch_size = 4
    cfg.train.training.steps_per_epoch = 1
    cfg.env.rasterizer.raster_size = 64
    cfg.algo.buffer_max = 64
    cfg.algo.ppo_update_times = 2
    cfg.algo.ppo_epochs = 1
    cfg.algo.ppo_mini_batch = 4
    cfg.algo.scene_width = 32
    cfg.algo.scene_layers = 2
    cfg.algo.scene_cond_dim = 16
    cfg.algo.history_num_frames = 8
    return cfg
