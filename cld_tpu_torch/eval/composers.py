"""Policy composers: named policy constructions for evaluation (port of
`cld_tpu/eval/composers.py`).

Each composer is a function `(cfg, pack, sim_cfg, ckpts=None, generator=None,
device="cuda") -> PolicyFn` registered under the reference composer's name:
the model policies, the hierarchical planner stacks, the agent-aware
selections, the MPC and contingency planners and the diffusion policies.
A model with no checkpoint runs with fresh weights: torch's default
initializers under the seed of `generator` (a `torch.Generator`; one seeded
0 on `device` by default), built on the CPU and moved to `device`, so that
one seed gives the same weights on every device. A checkpoint is a file of
`save_pytree({"params": state_dict})`, the layout the port's trainers write
as `ckpt_final`, loaded with `strict=True`.

A composed policy is `(obs, rng) -> Action`. Its draws (the CVAE's prior
sample, the GAN's noise, the diffusers' initial and per-step noise) come
from `rng`, a `torch.Generator` (or None: the default generator), or are
`rng` itself: the CVAE and GAN take z [B * N, latent] (sample-minor), the
raw-action diffusers (x_init [B, T, 2], step_noises [n, B, T, 2]) and the
scene diffuser (x_init [Ns, A, T, 6], step_noises [n, Ns, A, T, 6]).

As in the JAX package, `GroundTruth` and `GroundTruthNaN` return the
ground-truth positions and yaws without controls (so the NaN injection of
`GroundTruthNaN` touches nothing), which the simulator, stepping with
controls, refuses; and the aliases call their targets.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from cld_tpu_torch.data.batch import TrafficBatch, get_current_states
from cld_tpu_torch.policies.common import Action

COMPOSER_REGISTRY: Dict[str, Callable] = {}


def register_composer(name: str):
    def deco(fn):
        COMPOSER_REGISTRY[name] = fn
        return fn

    return deco


def get_composer(name: str):
    """The composer registered under `name`."""
    if name not in COMPOSER_REGISTRY:
        raise KeyError(f"unknown composer {name!r}; registered: {sorted(COMPOSER_REGISTRY)}")
    return COMPOSER_REGISTRY[name]


def _generator(generator, device) -> torch.Generator:
    return generator if generator is not None else torch.Generator(
        device=torch.device(device)).manual_seed(0)


def _init_or_restore(build: Callable[[], torch.nn.Module], generator, device,
                     ckpt: Optional[str] = None) -> torch.nn.Module:
    """The one init path of the composers: `build()` under the generator's
    seed on the CPU, moved to `device`, then the checkpoint's `params`
    loaded with `strict=True` when one is given."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(_generator(generator, device).initial_seed())
        model = build()
    model = model.to(device)
    if ckpt:
        from cld_tpu_torch.training.checkpoints import restore_pytree

        model.load_state_dict(restore_pytree(ckpt, device=device)["params"], strict=True)
    return model


def _sample_obs(pack, sim_cfg) -> TrafficBatch:
    from cld_tpu_torch.sim.env import init_sim_state, render_observation

    return render_observation(pack, init_sim_state(pack, sim_cfg), sim_cfg)


def _draws(rng):
    """(generator, explicit draws) of a policy's `rng`: a generator (or
    None) to draw from, or the draws themselves."""
    if rng is None or isinstance(rng, torch.Generator):
        return rng, None
    return None, rng


def _traj_action(traj: torch.Tensor) -> Action:
    """[B, T, 6] -> Action."""
    return Action(positions=traj[..., :2], yaws=traj[..., 3:4], controls=traj[..., 4:6])


def select_sample(trajs: torch.Tensor, obs: TrafficBatch) -> torch.Tensor:
    """The '*plan' composers' pick among samples [B, N, T, 6]: the index [B]
    that `ego_sample_planning` scores best against constant-velocity
    neighbor predictions (collision weight 10, lane 1, progress 0;
    neighbors 4.5 x 2.0 m)."""
    from cld_tpu_torch.policies.contingency import ego_sample_planning
    from cld_tpu_torch.policies.mpc import _cv_predict_neighbors

    T = trajs.shape[2]
    pred, mask = _cv_predict_neighbors(obs, T, 0.1)
    agent_ext = torch.tensor([4.5, 2.0], device=trajs.device).expand(*mask.shape, 2)
    return ego_sample_planning(
        torch.cat([trajs[..., :2], trajs[..., 3:4]], dim=-1), pred, obs.extent[:, :2],
        agent_ext, mask, obs.drivable_map, obs.raster_from_agent,
        weights={"collision_weight": 10.0, "lane_weight": 1.0, "progress_weight": 0.0})


def _selection_policy(sampler, pack, num_samples: int):
    """N-sample draw + `select_sample` pick (the '*plan' pattern).
    `num_samples` is not read, as in the JAX package."""

    @torch.no_grad()
    def policy(obs, rng):
        trajs = sampler(obs, rng)  # [B, N, T, 6]
        idx = select_sample(trajs, obs)
        return _traj_action(trajs[torch.arange(trajs.shape[0], device=idx.device), idx])

    return policy


# ---- ground truth / replay ------------------------------------------------

@register_composer("ReplayAction")
def _replay(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """Replay the logged actions."""
    from cld_tpu_torch.policies.hardcoded import replay_policy

    return replay_policy(pack.replay_actions)


@register_composer("GroundTruth")
def _gt(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The ground-truth future (positions and yaws, no controls)."""
    from cld_tpu_torch.policies.hardcoded import gt_policy

    return gt_policy


@register_composer("GroundTruthNaN")
def _gt_nan(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The ground truth with every 7th control frame from 1 set to NaN,
    where there are controls (the ground truth has none)."""
    from cld_tpu_torch.policies.hardcoded import gt_policy

    def policy(obs, rng):
        act = gt_policy(obs, rng)
        ctl = act.controls
        if ctl is not None:
            ctl = ctl.clone()
            ctl[:, 1::7] = float("nan")
        return act._replace(controls=ctl)

    return policy


# ---- learned single-agent models -------------------------------------------

def _dims(cfg, obs) -> dict:
    return dict(raster_channels=obs.image.shape[-1], horizon=cfg.algo.horizon,
                dt=cfg.algo.step_time, cond_feat_dim=cfg.algo.cond_feat_dim,
                map_arch=cfg.algo.map_encoder_model_arch)


@register_composer("BC")
def _bc(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The behavior-cloning planner."""
    from cld_tpu_torch.models.bc import BCPlanner

    dims = _dims(cfg, _sample_obs(pack, sim_cfg))
    model = _init_or_restore(lambda: BCPlanner(**dims), generator, device,
                             (ckpts or {}).get("policy"))

    @torch.no_grad()
    def policy(obs, rng):
        return _traj_action(model(obs)["trajectories"])

    return policy


def _cvae_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp):
    from cld_tpu_torch.models.cvae import TrajectoryCVAE

    dims = _dims(cfg, _sample_obs(pack, sim_cfg))
    model = _init_or_restore(lambda: TrajectoryCVAE(**dims), generator, device,
                             (ckpts or {}).get("policy"))

    @torch.no_grad()
    def sampler(obs, rng):
        gen, z = _draws(rng)
        return model.sample(obs, num_samp, z=z, generator=gen)  # [B, N, T, 6]

    return sampler


@register_composer("TrafficSim")
def _trafficsim(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The CVAE traffic model, one sample."""
    sampler = _cvae_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=1)
    return lambda obs, rng: _traj_action(sampler(obs, rng)[:, 0])


@register_composer("TrafficSimplan")
def _trafficsim_plan(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The CVAE's samples and the planner's pick."""
    return _selection_policy(
        _cvae_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=4), pack, 4)


def _discrete_cvae(cfg, pack, sim_cfg, ckpts, generator, device):
    from cld_tpu_torch.models.discrete_cvae import DiscreteTrajectoryCVAE

    dims = _dims(cfg, _sample_obs(pack, sim_cfg))
    return _init_or_restore(lambda: DiscreteTrajectoryCVAE(**dims), generator, device,
                            (ckpts or {}).get("policy"))


@register_composer("TPP")
def _tpp(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The discrete-latent CVAE's first mode."""
    model = _discrete_cvae(cfg, pack, sim_cfg, ckpts, generator, device)

    @torch.no_grad()
    def policy(obs, rng):
        return _traj_action(model.sample_modes(obs)[:, 0])  # modes [B, K, T, 6]

    return policy


@register_composer("TPPplan")
def _tpp_plan(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The discrete CVAE's modes and the planner's pick."""
    model = _discrete_cvae(cfg, pack, sim_cfg, ckpts, generator, device)
    return _selection_policy(lambda obs, rng: model.sample_modes(obs), pack, 0)


def _gan_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp):
    from cld_tpu_torch.models.gan import TrajectoryGAN

    dims = _dims(cfg, _sample_obs(pack, sim_cfg))
    model = _init_or_restore(lambda: TrajectoryGAN(**dims), generator, device,
                             (ckpts or {}).get("policy"))

    @torch.no_grad()
    def sampler(obs, rng):
        gen, z = _draws(rng)
        if z is None:
            z = torch.randn((obs.batch_size * num_samp, model.noise_dim), generator=gen,
                            device=obs.image.device)
        return model.generate(obs, z, num_samp)[0]  # [B, N, T, 6]

    return sampler


@register_composer("GAN")
def _gan(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The GAN traffic model, one sample."""
    sampler = _gan_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=1)
    return lambda obs, rng: _traj_action(sampler(obs, rng)[:, 0])


@register_composer("GANplan")
def _gan_plan(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The GAN's samples and the planner's pick."""
    return _selection_policy(
        _gan_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=4), pack, 4)


# ---- hierarchical planner stacks -------------------------------------------

def _lattice(cfg, sim_cfg):
    from cld_tpu_torch.policies.planner import LatticePlannerConfig, lattice_planner_policy

    return lattice_planner_policy(
        LatticePlannerConfig(horizon=cfg.algo.horizon, dt=sim_cfg.dt, dyn=sim_cfg.dyn))


@register_composer("Hierarchical")
def _hier(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The lattice planner's plan through the tracking controller."""
    from cld_tpu_torch.policies.wrappers import hierarchical_policy

    return hierarchical_policy(_lattice(cfg, sim_cfg), dt=sim_cfg.dt)


@register_composer("HierarchicalSample")
def _hier_sample(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """An alias of Hierarchical."""
    return _hier(cfg, pack, sim_cfg, ckpts, generator, device)


@register_composer("HierarchicalSampleNew")
def _hier_sample_new(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """An alias of Hierarchical."""
    return _hier(cfg, pack, sim_cfg, ckpts, generator, device)


@register_composer("HierAgentAware")
def _haa(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The lattice planner (its candidate costs are agent-aware already)."""
    return _lattice(cfg, sim_cfg)


@register_composer("HierAgentAwareCVAE")
def _haa_cvae(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The CVAE's samples filtered by the agent-aware planning costs."""
    return _selection_policy(
        _cvae_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=4), pack, 4)


@register_composer("HierAgentAwareMPC")
def _haa_mpc(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The FTOCP MPC with constant-velocity agent predictions."""
    from cld_tpu_torch.policies.mpc import MPCConfig, mpc_policy

    return mpc_policy(MPCConfig(N=max(20, sim_cfg.n_step_action), dt=sim_cfg.dt))


@register_composer("GuidedHAAMPC")
def _guided_haa_mpc(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """An alias of HierAgentAwareMPC."""
    return _haa_mpc(cfg, pack, sim_cfg, ckpts, generator, device)


@register_composer("HAASplineSampling")
def _haa_spline(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The lattice planner."""
    return _lattice(cfg, sim_cfg)


@register_composer("AgentAwareEC")
def _agent_aware_ec(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """Contingency planning over trajectory trees."""
    from cld_tpu_torch.policies.contingency import ContingencyConfig, contingency_policy

    return contingency_policy(ContingencyConfig(dt=sim_cfg.dt, dyn=sim_cfg.dyn))


@register_composer("TreeContingency")
def _tree_contingency(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """An alias of AgentAwareEC."""
    return _agent_aware_ec(cfg, pack, sim_cfg, ckpts, generator, device)


# ---- diffusion / adversarial ------------------------------------------------

@register_composer("STRIVE")
def _strive(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The CVAE traffic model's sample (the latent attack itself runs
    offline, `algos.latent_attack`)."""
    sampler = _cvae_sampler(cfg, pack, sim_cfg, ckpts, generator, device, num_samp=1)
    return lambda obs, rng: _traj_action(sampler(obs, rng)[:, 0])


@register_composer("Diffuser")
def _diffuser(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The raw-action diffuser."""
    return _diffuser_policy(cfg, pack, sim_cfg, ckpts, generator, device, guided=False)


@register_composer("DSPolicy")
def _ds(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The raw-action diffuser with stationary agents held still."""
    return _diffuser_policy(cfg, pack, sim_cfg, ckpts, generator, device, guided=True)


def _diffuser_policy(cfg, pack, sim_cfg, ckpts, generator, device, guided: bool):
    """The context encoder (`ckpts["encoder"]`) and the temporal UNet
    (`ckpts["policy"]`, built under the generator's seed + 1) in a
    `RawActionDiffuser`; one sample per agent."""
    from cld_tpu_torch.algos.diffuser import RawActionDiffuser, stationary_mask_from_speed
    from cld_tpu_torch.models.context import ContextEncoder
    from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
    from cld_tpu_torch.ops.diffusion import make_schedule
    from cld_tpu_torch.ops.dynamics import UnicycleParams

    algo = cfg.algo
    obs0 = _sample_obs(pack, sim_cfg)
    ckpts = ckpts or {}
    gen = _generator(generator, device)
    enc = _init_or_restore(
        lambda: ContextEncoder(obs0.image.shape[-1], algo.curr_state_feat_dim,
                               algo.map_feature_dim, algo.cond_feat_dim,
                               algo.map_encoder_model_arch),
        gen, device, ckpts.get("encoder"))
    net_gen = torch.Generator().manual_seed(gen.initial_seed() + 1)
    net = _init_or_restore(
        lambda: TemporalMapUnet(6, 2, algo.cond_feat_dim, algo.base_dim, (2, 4, 8)),
        net_gen, device, ckpts.get("policy"))
    T = algo.horizon
    diffuser = RawActionDiffuser(net, make_schedule(algo.n_diffusion_steps, device=device),
                                 UnicycleParams.from_config(algo.dynamics), dt=algo.step_time)

    @torch.no_grad()
    def policy(obs, rng):
        gen, noise = _draws(rng)
        x_init, step_noises = noise if noise is not None else (None, None)
        stat = stationary_mask_from_speed(obs.curr_speed) if guided else None
        out = diffuser.sample(get_current_states(obs), enc(obs)["cond_feat"], T, num_samp=1,
                              stationary_mask=stat, x_init=x_init, step_noises=step_noises,
                              generator=gen)
        return _traj_action(out["trajectories"])

    return policy


@register_composer("SceneDiffuser")
def _scene_diffuser(cfg, pack, sim_cfg, ckpts=None, generator=None, device="cuda"):
    """The scene-centric diffusion policy: every agent of a scene sampled
    jointly; `Ns` scenes of the pack's world maps, `A = num_agents // Ns`
    agents each. A checkpoint restores the model's parameters."""
    from cld_tpu_torch.policies.scene_policy import scene_dm_policy
    from cld_tpu_torch.training.scene_dm import SceneDMTrainer

    Ns = int(pack.world_map.shape[0])
    A = pack.num_agents // Ns
    trainer = SceneDMTrainer(cfg, device=device)
    state = trainer.init_state(_generator(generator, device).initial_seed())
    if (ckpts or {}).get("policy"):
        from cld_tpu_torch.training.checkpoints import restore_pytree

        state.model.load_state_dict(restore_pytree(ckpts["policy"], device=device)["params"],
                                    strict=True)
    return scene_dm_policy(trainer, state, Ns, A, horizon=cfg.algo.future_num_frames)
