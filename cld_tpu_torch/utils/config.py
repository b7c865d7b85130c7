"""Attribute-dict config with lock semantics and YAML loading (the port's own
copy of `cld_tpu/utils/config.py`).

`default_config()` is the experiment config of record: the same keys, names
and defaults as the JAX package's, which `tests/test_torch_config.py` holds
key for key.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class Config(dict):
    """Dict with attribute access and a lock bit guarding against typo keys."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        object.__setattr__(self, "_locked", False)
        for src in args:
            for k, v in dict(src).items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __setitem__(self, key, value):
        if object.__getattribute__(self, "_locked") and key not in self:
            raise KeyError(f"config is locked; cannot add new key {key!r}")
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any):
        self[name] = value

    def lock(self) -> "Config":
        object.__setattr__(self, "_locked", True)
        for v in self.values():
            if isinstance(v, Config):
                v.lock()
        return self

    def unlock(self) -> "Config":
        object.__setattr__(self, "_locked", False)
        for v in self.values():
            if isinstance(v, Config):
                v.unlock()
        return self

    def update_deep(self, other: Mapping) -> "Config":
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].update_deep(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def load_config(path: str, base: Config | None = None) -> Config:
    """Load YAML (or JSON) over the defaults. A `.json` file is read without
    PyYAML, which some hosts lack."""
    with open(path) as f:
        if path.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f)
    cfg = base if base is not None else default_config()
    cfg.unlock()
    cfg.update_deep(raw or {})
    return cfg.lock()


def default_config() -> Config:
    """Experiment config of record."""
    return Config(
        {
            "seed": 1,
            "train": {
                "mode": "vae",  # vae | dm | ppo | test
                "debug": False,
                "ckpt_dir": "checkpoints",
                "checkpoint_vae": None,
                "checkpoint_dm": None,
                "data_path": None,  # None or "synthetic": procedurally generated batches
                "training": {
                    "batch_size": 128,
                    "epochs": 6,
                    "num_steps": 1000,
                    "steps_per_epoch": 1000,
                },
                "validation": {
                    "batch_size": 128,
                    "every_n_steps": 1000,
                    "num_steps_per_epoch": 15,
                    "enabled": True,
                },
                "save": {"every_n_steps": 200, "best_k": 1, "enabled": True},
                "logging": {"log_every_n_steps": 5},
                "parallel": {
                    # device mesh: data parallelism over all available chips
                    "dp": -1,  # -1 = all devices
                },
            },
            "env": {
                "name": "trajdata",
                "data_generation_params": {
                    "trajdata_centric": "agent",
                    "trajdata_max_agents_distance": 50,
                    "trajdata_standardize_data": True,
                    "other_agents_num": 30,
                },
                "rasterizer": {
                    "include_hist": True,
                    "num_sem_layers": 3,
                    "raster_size": 224,
                    "pixel_size": 0.5,
                    "ego_center": [-0.5, 0.0],
                    "no_map_fill_value": -1.0,
                },
                "simulation": {
                    "num_simulation_steps": 100,
                    "n_step_action": 5,
                    "start_frame_index": None,
                },
            },
            "algo": {
                "name": "dm_vae",
                "coordinate": "agent_centric",
                "map_encoder_model_arch": "resnet18",
                "diffuser_model_arch": "TemporalMapUnet",
                "transition_in_dim": 6,
                "base_dim": 32,
                "horizon": 52,
                "n_diffusion_steps": 100,
                "dim_mults": [2, 4, 8],
                "loss_type": "l2",
                "diffuser_building_block": "concat",
                "cond_feat_dim": 256,
                "curr_state_feat_dim": 64,
                "map_feature_dim": 256,
                "history_num_frames": 30,
                "future_num_frames": 52,
                "step_time": 0.1,
                "time_dim": 128,
                "vae": {"hidden_size": 64, "latent_size": 4},
                "dynamics": {
                    "type": "Unicycle",
                    "max_steer": 0.5,
                    "max_yawvel": 6.283185307179586,
                    "acce_bound": [-10, 8],
                    "ddh_bound": [-6.283185307179586, 6.283185307179586],
                    "max_speed": 40.0,
                },
                "optim_params": {
                    "dm": {
                        "learning_rate": {"initial": 0.0001},
                        "regularization": {"L2": 0.00001},
                    },
                    "vae": {
                        "learning_rate": {"initial": 0.0001},
                        "regularization": {"L2": 0.00001},
                    },
                },
                "nusc_norm_info": {
                    "diffuser": [
                        [13.162, -0.13891, 5.0223, -0.0046415, -0.0080072, -0.0013546],
                        [13.0717, 2.2462, 3.6187, 0.2210, 2.5770, 0.0840],
                    ]
                },
                "num_samp": 1,
                "ppo_mini_batch": 128,
                "buffer_max": 3000,
                "ppo_update_times": 300,
                "update_interval": 10,
                "ppo_epochs": 10,
                "ppo_clip_eps": 0.2,
            },
        }
    )
