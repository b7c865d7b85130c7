"""Named experiment configs (the port's own copy of `cld_tpu/utils/registry.py`):
the three stages of record, the `cld_smoke` sizes, and every named
experiment of the reference on the dataset axis (per-dataset env presets):
the model zoo's rows (`train.mode` "zoo" and the factory algo in
`algo.name`) and the rows of the dedicated modes `gan` (with
`algo.gan_generator_arch` for the transformer generator), `ebm` and
`scene_dm`.
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


# -- dataset axis -------------------------------------------------------------
# Per-dataset env presets, the reference's env-config classes: the
# rasterization, timing and agent-type knobs of record (data/convert.py
# ingests any trajdata source into packed shards).
_DATASET_ENV = {
    # nuScenes via trajdata: the config of record (defaults)
    "nusc": {},
    # Lyft Level 5: same raster geometry as nusc in the reference
    "l5": {"source": "lyft_train", "sem_layers": 3},
    # ETH/UCY pedestrians: mapless, dt=0.4, 8 hist / 12 fut (benchmark setting)
    "eupeds": {
        "source": "eupeds_eth-train_loo",
        "sem_layers": 0, "incl_map": False, "pixel_size": 0.1,
        "only_types": ["pedestrian"], "step_time": 0.4,
        "history_num_frames": 8, "future_num_frames": 12, "batch_size": 400,
    },
    # ORCA simulated pedestrians: 2-layer map at 1/12 m/px
    "orca": {
        "source": "orca_maps-train",
        "sem_layers": 2, "pixel_size": 1.0 / 12.0,
        "only_types": ["pedestrian"],
    },
    "nuplan": {"source": "nuplan_mini-train", "sem_layers": 3},
    # *_ped / *_all variants: agent-type filters on the vehicle configs
    "nusc_ped": {"only_types": ["pedestrian"]},
    "nusc_all": {"only_types": ["vehicle", "pedestrian"]},
    "nuplan_ped": {"source": "nuplan_mini-train", "only_types": ["pedestrian"]},
    "nuplan_all": {"source": "nuplan_mini-train",
                   "only_types": ["vehicle", "pedestrian"]},
    "drivesim": {"source": "drivesim-train"},
}


def _dataset_config(dataset: str) -> Config:
    d = _DATASET_ENV[dataset]
    cfg = default_config()
    cfg.env.dataset = dataset
    if "source" in d:
        cfg.train.trajdata_source_train = d["source"]
    if "sem_layers" in d:
        cfg.env.rasterizer.num_sem_layers = d["sem_layers"]
    if "pixel_size" in d:
        cfg.env.rasterizer.pixel_size = d["pixel_size"]
    cfg.env.data_generation_params.trajdata_incl_map = d.get("incl_map", True)
    if "only_types" in d:
        cfg.env.data_generation_params.trajdata_only_types = d["only_types"]
    if "step_time" in d:
        cfg.algo.step_time = d["step_time"]
    if "history_num_frames" in d:
        cfg.algo.history_num_frames = d["history_num_frames"]
    if "future_num_frames" in d:
        cfg.algo.future_num_frames = d["future_num_frames"]
        cfg.algo.horizon = d["future_num_frames"]
    if "batch_size" in d:
        cfg.train.training.batch_size = d["batch_size"]
    return cfg


def _zoo_config(algo_name: str, dataset: str = "nusc") -> Config:
    """A baseline-algo entry: the dataset's preset, `train.mode` "zoo" and
    the factory algo's name."""
    cfg = _dataset_config(dataset)
    cfg.train.mode = "zoo"
    cfg.algo.name = algo_name
    return cfg


def _mode_config(mode: str, dataset: str = "nusc", **algo_overrides) -> Config:
    """An entry of a dedicated train mode: the dataset's preset, `train.mode`
    and the algo keys given."""
    cfg = _dataset_config(dataset)
    cfg.train.mode = mode
    for k, v in algo_overrides.items():
        setattr(cfg.algo, k, v)
    return cfg


# Every named experiment of the reference registry, one row per name:
# (name, dataset, kind, algo-or-None). Kind "zoo" resolves through
# `training.zoo.algo_factory`; the other kinds are train modes, a "gan" row's
# algo naming its generator.
# *_strive trains the same CVAE (its latent attack is an evaluation-time
# tool); nusc_diff_stack is the diffuser algo; l5_* rows take the trajdata
# ingestion path with the l5kit raster and timing knobs.
_REFERENCE_EXPERIMENTS = [
    # l5kit family
    ("l5_bc", "l5", "zoo", "bc"),
    ("l5_gan", "l5", "gan", None),
    ("l5_bc_gc", "l5", "zoo", "bc_gc"),
    ("l5_spatial_planner", "l5", "zoo", "spatial_planner"),
    ("l5_agent_predictor", "l5", "zoo", "agent_predictor"),
    ("l5_vae", "l5", "zoo", "vae"),
    ("l5_bc_ec", "l5", "zoo", "bc_ec"),
    ("l5_discrete_vae", "l5", "zoo", "discrete_vae"),
    ("l5_tree_vae", "l5", "zoo", "tree_vae"),
    ("l5_transformer", "l5", "zoo", "TransformerPred"),
    ("l5_transformer_gan", "l5", "gan", "transformer"),
    ("l5_ebm", "l5", "ebm", None),
    ("l5_occupancy", "l5", "zoo", "occupancy"),
    ("l5_diff", "l5", "zoo", "diff"),
    # nuScenes family
    ("nusc_bc", "nusc", "zoo", "bc"),
    ("nusc_bc_gc", "nusc", "zoo", "bc_gc"),
    ("nusc_spatial_planner", "nusc", "zoo", "spatial_planner"),
    ("nusc_vae", "nusc", "zoo", "vae"),
    ("nusc_discrete_vae", "nusc", "zoo", "discrete_vae"),
    ("nusc_tree_vae", "nusc", "zoo", "tree_vae"),
    ("nusc_diff_stack", "nusc", "zoo", "diff"),
    ("nusc_agent_predictor", "nusc", "zoo", "agent_predictor"),
    ("nusc_gan", "nusc", "gan", None),
    ("nusc_occupancy", "nusc", "zoo", "occupancy"),
    ("nusc_diff", "nusc", "zoo", "diff"),
    ("nusc_transformer", "nusc", "zoo", "TransformerPred"),
    ("nusc_bc_ec", "nusc", "zoo", "bc_ec"),
    ("nusc_transformer_gan", "nusc", "gan", "transformer"),
    ("nusc_ebm", "nusc", "ebm", None),
    # pedestrian datasets
    ("eupeds_bc", "eupeds", "zoo", "bc"),
    ("eupeds_vae", "eupeds", "zoo", "vae"),
    ("orca_bc", "orca", "zoo", "bc"),
    ("orca_diff", "orca", "zoo", "diff"),
    # trajdata_* aliases
    ("trajdata_nusc_bc", "nusc", "zoo", "bc"),
    ("trajdata_nusc_vae", "nusc", "zoo", "vae"),
    ("trajdata_nusc_spatial_planner", "nusc", "zoo", "spatial_planner"),
    ("trajdata_nusc_agent_predictor", "nusc", "zoo", "agent_predictor"),
    ("trajdata_nusc_diff", "nusc", "zoo", "diff"),
    ("trajdata_nusc_strive", "nusc", "zoo", "vae"),
    ("trajdata_l5_bc", "l5", "zoo", "bc"),
    ("trajdata_l5_vae", "l5", "zoo", "vae"),
    ("trajdata_l5_spatial_planner", "l5", "zoo", "spatial_planner"),
    ("trajdata_l5_agent_predictor", "l5", "zoo", "agent_predictor"),
    ("trajdata_l5_diff", "l5", "zoo", "diff"),
    # ped/all diffusion variants
    ("nusc_ped_diff", "nusc_ped", "zoo", "diff"),
    ("nusc_all_diff", "nusc_all", "zoo", "diff"),
    # nuPlan family
    ("trajdata_nuplan_bc", "nuplan", "zoo", "bc"),
    ("trajdata_nuplan_spatial_planner", "nuplan", "zoo", "spatial_planner"),
    ("trajdata_nuplan_agent_predictor", "nuplan", "zoo", "agent_predictor"),
    ("trajdata_nuplan_diff", "nuplan", "zoo", "diff"),
    ("trajdata_nuplan_ped_diff", "nuplan_ped", "zoo", "diff"),
    ("trajdata_nuplan_all_diff", "nuplan_all", "zoo", "diff"),
    # CTG++ scene diffusion
    ("trajdata_nusc_scene_diff", "nusc", "scene_dm", None),
    ("trajdata_nuplan_scene_diff", "nuplan", "scene_dm", None),
    ("trajdata_drivesim_diff", "drivesim", "zoo", "diff"),
]

for _name, _ds, _kind, _algo in _REFERENCE_EXPERIMENTS:
    if _kind == "zoo":
        EXP_CONFIG_REGISTRY[_name] = lambda a=_algo, d=_ds: _zoo_config(a, dataset=d)
    elif _kind == "gan":
        EXP_CONFIG_REGISTRY[_name] = lambda d=_ds, arch=_algo: _mode_config(
            "gan", dataset=d, **({"gan_generator_arch": arch} if arch else {}))
    else:
        EXP_CONFIG_REGISTRY[_name] = lambda d=_ds, m=_kind: _mode_config(m, dataset=d)
