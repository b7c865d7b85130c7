"""The guided pipeline: encode, guided (or unguided) 100-step latent DDPM
sampling, decode; open loop with a reward (`guided_collect`) and as the
closed loop's policy (`make_dm_policy`).

Counterpart of `bench.py:335-376` (`bench_open_loop`'s `guided_collect`):
the ResNet-18 context encoder gives `cond_feat`; `sample_traj` runs the
temporal UNet with, at every denoise step but the last, one Adam step of
agent_collision + map_collision guidance (weight 10 each, lr 0.3, the
cumulative change clipped to the posterior sigma) taken through the frozen
LSTM decoder and the unicycle; the final latents are decoded and scored by
`compute_reward`. Scenes are 4 agents in adjacent lanes with longitudinal
stagger, the world-pose layout of `bench.py:325-330`.

`make_dm_policy` is the counterpart of `bench.py:551-598` (the policy of
`bench_closed_loop`) and of `rollout.py:make_dm_policy`: the same call per
replan, with the world poses and scene indices of the simulator's
observation. Both go through `sample_plans`, whose `SamplingOptions` pick the
sampler (DDPM or DDIM), the number of samples per agent (the best one by
total guidance loss is kept) and the guidance schedule; the defaults are the
config of record.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from cld_tpu_torch.algos.dm import sample_traj, sample_traj_ddim
from cld_tpu_torch.algos.reward import compute_reward
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.guidance.losses import (
    AgentCollisionLoss,
    GuidanceContext,
    MapCollisionLoss,
    prepack_drivable,
)
from cld_tpu_torch.guidance.perturbation import (
    GuidanceSpec,
    choose_best_sample,
    choose_closest_to_gt,
    is_scene_level_spec,
    make_perturbation_guidance,
    per_sample_guidance_loss,
)
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.models.vae import (
    LSTMDecoder,
    convert_action_to_state_and_action,
    decode_actions,
)
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops.diffusion import DiffusionSchedule, make_schedule
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS, UnicycleParams
from cld_tpu_torch.ops.geometry import transform_points, world_from_agent_matrix
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.policies.common import Action, action_from_trajectory


@dataclasses.dataclass(frozen=True)
class SamplingOptions:
    """How `sample_plans` samples and guides (the names and defaults of the
    JAX package's `rollout.py` flags; the defaults are the config of record).

    `num_samp` samples per agent; with more than one and guidance specs, the
    sample with the lowest total guidance loss is kept (one shared index per
    scene when a scene-coupled rule is active). `sampler` "ddpm" runs all the
    schedule's steps, "ddim" `ddim_steps` of them with noise scale
    `ddim_eta`. Guidance takes `guidance_steps` Adam steps of size
    `guidance_lr` (None: the posterior sigma) per guided denoise step, the
    cumulative change clipped to `perturb_th` (None: the posterior sigma; a
    number decays sigmoidally from ~4 to it over the denoise steps).
    `guidance_stride`, `guidance_clean` and `guidance_output` are
    `sample_traj`'s switches (DDPM only). `guide_as_filter_only` takes no
    guidance step: the specs only pick among the samples. `guide_with_gt`
    keeps, of several samples, the one closest to the batch's ground-truth
    future (`choose_closest_to_gt`) in place of the guidance-loss filtration.
    `decode_impl` is `models.vae.decode_actions`'s `impl`: the kernel-backed
    decoder core ("auto", "kernel") or the decoder's own layer stack
    ("module")."""

    num_samp: int = 1
    sampler: str = "ddpm"
    ddim_steps: int = 50
    ddim_eta: float = 0.0
    guidance_lr: Optional[float] = 0.3
    guidance_steps: int = 1
    perturb_th: Optional[float] = None
    guidance_stride: int = 1
    guidance_clean: bool = False
    guidance_output: bool = False
    guide_as_filter_only: bool = False
    guide_with_gt: bool = False
    decode_impl: str = "auto"


RECORD_SAMPLING = SamplingOptions()


@dataclasses.dataclass
class GuidedModels:
    """The frozen networks and constants of the pipeline."""

    context: ContextEncoder
    decoder: LSTMDecoder
    unet: TemporalMapUnet
    schedule: DiffusionSchedule
    dyn: UnicycleParams = RECORD_DYNAMICS
    horizon: int = 52
    latent_size: int = 4


def build_models(
    seed: int = 0,
    device="cuda",
    raster_channels: int = 34,
    cond_feat_dim: int = 256,
    map_feature_dim: int = 256,
    curr_state_feat_dim: int = 64,
    hidden_size: int = 64,
    latent_size: int = 4,
    base_dim: int = 32,
    dim_mults=(2, 4, 8),
    horizon: int = 52,
    n_diffusion_steps: int = 100,
) -> GuidedModels:
    """Networks at the config of record's widths with seeded random weights
    (torch's default initializers under `torch.manual_seed(seed)`), frozen
    and in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        context = ContextEncoder(raster_channels, curr_state_feat_dim,
                                 map_feature_dim, cond_feat_dim)
        decoder = LSTMDecoder(latent_size, hidden_size, cond_feat_dim)
        unet = TemporalMapUnet(latent_size, latent_size, cond_feat_dim, base_dim, dim_mults)
    for m in (context, decoder, unet):
        m.to(device).eval().requires_grad_(False)
    return GuidedModels(context, decoder, unet, make_schedule(n_diffusion_steps, device=device),
                        horizon=horizon, latent_size=latent_size)


def build_models_from_config(cfg, device="cuda", seed: int = 0) -> GuidedModels:
    """`build_models` with every width from an experiment config (as the
    trainers build theirs): `cond_feat_dim`, `map_feature_dim`,
    `curr_state_feat_dim`, `base_dim`, `dim_mults`, `vae.hidden_size`,
    `vae.latent_size`, `horizon`, `n_diffusion_steps`, the raster channels
    (`history_num_frames` + 1 + the semantic map layers) and the unicycle's
    bounds (`algo.dynamics`). The ResNet takes any raster size."""
    from cld_tpu_torch.training.vae import raster_channels

    algo = cfg.algo
    models = build_models(
        seed=seed, device=device, raster_channels=raster_channels(cfg),
        cond_feat_dim=algo.cond_feat_dim, map_feature_dim=algo.map_feature_dim,
        curr_state_feat_dim=algo.curr_state_feat_dim, hidden_size=algo.vae.hidden_size,
        latent_size=algo.vae.latent_size, base_dim=algo.base_dim,
        dim_mults=tuple(algo.dim_mults), horizon=algo.horizon,
        n_diffusion_steps=algo.n_diffusion_steps,
    )
    return dataclasses.replace(models, dyn=UnicycleParams.from_config(algo.dynamics))


def load_checkpoints(models: GuidedModels, vae_ckpt: Optional[str] = None,
                     dm_ckpt: Optional[str] = None) -> GuidedModels:
    """Load trained weights into the models, each module ``strict=True``:
    from `vae_ckpt` the context encoder and the LSTM decoder, from `dm_ckpt`
    the temporal UNet. Each file is the port's own (a VAE or DM stage's
    ``ckpt_final`` of ``python -m cld_tpu_torch.train``, or the output of
    ``python -m cld_tpu_torch.utils.torch_import``) or a reference Lightning
    ``.ckpt`` with ``vae.`` / ``dm.model.`` keys; one such file may serve as
    both."""
    from cld_tpu_torch.utils import torch_import as ti

    if vae_ckpt:
        sd = ti.read_checkpoint(vae_ckpt, "vae")
        ti.load_context_encoder(models.context, sd, prefix="")
        ti.load_lstm_decoder(models.decoder, sd, prefix="")
    if dm_ckpt:
        ti.load_temporal_unet(models.unet, ti.read_checkpoint(dm_ckpt, "dm"), prefix="")
    return models


def flagship_guidance_specs(
    scene_block: Optional[int],
    gather_impl: str = "bits",
    min_dist_impl: str = "separable",
    min_fwd_impl: str = "auto",
    pairwise_impl: str = "auto",
    excluded_agents: Optional[Sequence[int]] = None,
):
    """The flagship editing rules (`bench.py:263-296`): agent collision and
    map collision, weight 10 each. `gather_impl`, `min_dist_impl` and
    `min_fwd_impl` are `MapCollisionLoss`'s options, `pairwise_impl` and
    `excluded_agents` `AgentCollisionLoss`'s."""
    return [
        GuidanceSpec(AgentCollisionLoss(
            num_disks=5, buffer_dist=0.2, scene_block=scene_block, pairwise_impl=pairwise_impl,
            excluded_agents=tuple(excluded_agents) if excluded_agents else None), 10.0),
        GuidanceSpec(MapCollisionLoss(num_points_lw=(10, 10), gather_impl=gather_impl,
                                      min_dist_impl=min_dist_impl,
                                      min_fwd_impl=min_fwd_impl), 10.0),
    ]


def scene_world_poses(batch_size: int, agents_per_scene: int, device):
    """Scenes of `agents_per_scene` agents in adjacent lanes with
    longitudinal stagger: (world_from_agent [B, 3, 3], scene_index [B])."""
    lane = (np.arange(batch_size) % agents_per_scene).astype(np.float32)
    pos_w = torch.as_tensor(
        np.stack([lane * 8.0, (lane % 2) * 3.5 - 1.75], axis=-1), device=device
    )
    yaw_w = torch.zeros((batch_size,), device=device)
    scene_index = torch.arange(batch_size, device=device) // agents_per_scene
    return world_from_agent_matrix(pos_w, yaw_w), scene_index


def sample_plans(
    models: GuidedModels,
    batch: TrafficBatch,
    specs: Optional[Sequence[GuidanceSpec]] = None,
    world_from_agent: Optional[torch.Tensor] = None,
    scene_index: Optional[torch.Tensor] = None,
    x_init: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    options: SamplingOptions = RECORD_SAMPLING,
    context_fields: Optional[Dict] = None,
) -> Dict[str, torch.Tensor]:
    """Encode the batch, sample `options.num_samp` latents per agent (guided
    by `specs` when given, with the caller's world poses [B, 3, 3] and scene
    indices [B], and `context_fields`, more `GuidanceContext` fields such as
    `observation_context_fields` gives) and decode: the sampler's outputs
    (pred_traj [B*N, T, D], cond_feat, and for DDPM x1 and log_prob_final) plus the decoded
    trajectories `traj` [B, N, T, 6] and `best` [B, T, 6], the sample kept
    per agent (`best_index` [B]): with N > 1 and `options.guide_with_gt` the
    one closest to the batch's ground-truth future, else with N > 1 and specs
    the one with the lowest total guidance loss, else sample 0."""
    if options.sampler not in ("ddpm", "ddim"):
        raise ValueError(f"unknown sampler {options.sampler!r} (expected ddpm|ddim)")
    normalizer = TrajNormalizer()
    N = options.num_samp
    with torch.no_grad():
        aux = models.context(batch)
    cond_feat, curr = aux["cond_feat"], aux["curr_states"]
    B = cond_feat.shape[0]
    cond_rep = cond_feat.repeat_interleave(N, dim=0) if N > 1 else cond_feat
    curr_rep = curr.repeat_interleave(N, dim=0) if N > 1 else curr

    def decode_fn(z):
        acts = decode_actions(models.decoder, z, cond_rep, impl=options.decode_impl)
        traj = convert_action_to_state_and_action(
            acts, curr_rep, models.dyn, normalizer, descaled_output=True
        )
        return traj.reshape(B, N, *traj.shape[1:])

    gfn = ctx = None
    if specs:
        ctx = prepack_drivable(GuidanceContext(
            drivable_map=batch.drivable_map,
            raster_from_agent=batch.raster_from_agent,
            extent=batch.extent,
            curr_speed=batch.curr_speed,
            world_from_agent=world_from_agent,
            scene_index=scene_index,
            **(context_fields or {}),
        ))
        if not options.guide_as_filter_only:
            gfn = make_perturbation_guidance(
                ctx, specs, decode_fn, lr=options.guidance_lr, grad_steps=options.guidance_steps,
                perturb_th=options.perturb_th,
                sigma_schedule=torch.exp(0.5 * models.schedule.posterior_log_variance_clipped),
                n_timesteps=models.schedule.n_timesteps,
            )
    common = dict(num_samp=N, guidance_fn=gfn, x_init=x_init, step_noises=step_noises,
                  generator=generator)
    if options.sampler == "ddim":
        out = sample_traj_ddim(
            models.unet, models.schedule, cond_feat, models.horizon, models.latent_size,
            num_steps=options.ddim_steps, eta=options.ddim_eta, **common,
        )
    else:
        out = sample_traj(
            models.unet, models.schedule, cond_feat, models.horizon, models.latent_size,
            guidance_stride=options.guidance_stride, guidance_clean=options.guidance_clean,
            guidance_output=options.guidance_output, **common,
        )
    with torch.no_grad():
        traj = decode_fn(out["pred_traj"])
        if N > 1 and options.guide_with_gt and batch.target_positions is not None:
            best, idx = choose_closest_to_gt(traj, traj[..., :2], batch.target_positions,
                                             batch.target_availabilities)
        elif N > 1 and specs:
            losses = per_sample_guidance_loss(traj, ctx, specs)  # [B, N]
            best, idx = choose_best_sample(
                traj, losses, scene_index=scene_index,
                scene_level=any(is_scene_level_spec(s) for s in specs),
            )
        else:
            best, idx = traj[:, 0], torch.zeros((B,), dtype=torch.long, device=traj.device)
    out.update(traj=traj, best=best, best_index=idx)
    return out


def guided_collect(
    models: GuidedModels,
    batch: TrafficBatch,
    guided: bool = True,
    agents_per_scene: int = 4,
    x_init: Optional[torch.Tensor] = None,
    step_noises: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    specs: Optional[Sequence[GuidanceSpec]] = None,
    options: SamplingOptions = RECORD_SAMPLING,
) -> Dict[str, torch.Tensor]:
    """One pipeline call. Guidance defaults to the flagship rules over scenes
    of `agents_per_scene` agents; `specs` gives others (for example
    `flagship_guidance_specs(4, min_dist_impl="rigid_kernel")`). Returns the
    mean reward and the per-(agent, sample) reward (flat [B * N]), the sampler's
    outputs (final latents, and for DDPM x1 and log_prob_final), the decoded
    trajectories [B, N, T, 6], the sample kept per agent (`best` [B, T, 6],
    `best_index` [B]), cond_feat, and `launches`: how many times each CUDA
    kernel launched during the call."""
    before = native.launch_counts()
    wfa = scene_index = None
    if guided:
        if specs is None:
            specs = flagship_guidance_specs(agents_per_scene)
        wfa, scene_index = scene_world_poses(batch.batch_size, agents_per_scene,
                                             batch.image.device)
    out = sample_plans(models, batch, specs if guided else None, wfa, scene_index,
                       x_init=x_init, step_noises=step_noises, generator=generator,
                       options=options)
    traj = out["traj"]
    with torch.no_grad():
        reward = compute_reward(traj, batch, TrajNormalizer().scale(traj))
    after = native.launch_counts()
    res = {k: out[k] for k in ("pred_traj", "x1", "log_prob_final", "cond_feat", "best",
                               "best_index") if k in out}
    res.update(reward=reward.mean(), reward_per_agent=reward, traj=traj,
               launches={k: after[k] - before[k] for k in after})
    return res


def observation_context_fields(obs: TrafficBatch) -> Dict:
    """The guidance context's fields that a closed-loop observation carries:
    the closest lane points, agent_from_world, the sim frame as `global_t`
    and the world-frame history (x, y, v, yaw) [B, Th, 4] as
    `agent_hist_world` (None where the observation lacks them)."""
    hist_world = None
    if obs.history_speeds is not None and obs.world_from_agent is not None:
        wfa = obs.world_from_agent
        hp_w = transform_points(obs.history_positions, wfa)
        dyaw = torch.atan2(wfa[:, 1, 0], wfa[:, 0, 0])
        hist_world = torch.cat([hp_w, obs.history_speeds[..., None],
                                obs.history_yaws + dyaw[:, None, None]], dim=-1)
    return dict(lane_points=obs.lane_points, lane_avail=obs.lane_avail,
                agent_from_world=obs.agent_from_world, global_t=obs.sim_step,
                agent_hist_world=hist_world)


def make_dm_policy(
    models: GuidedModels,
    agents_per_scene: int,
    guided: bool = True,
    specs: Optional[Sequence[GuidanceSpec]] = None,
    options: SamplingOptions = RECORD_SAMPLING,
) -> Callable[[TrafficBatch, object], Action]:
    """The diffusion policy of the closed loop: obs -> (guided) latent
    sampling -> the kept sample's decoded plan as an `Action` (its `controls`
    are the [Na, T, 2] (acc, yawvel) the simulator steps with). Guidance
    defaults to the flagship rules over scenes of `agents_per_scene` agents,
    with the observation's world poses and scene indices and the rest of its
    context (`observation_context_fields`). `options` picks the sampler, the
    samples per agent and the guidance schedule.

    Per replan the policy's `rng` is explicit noise, a dict with `x_init`
    [Na * N, T, D] and `step_noises` [n_steps, Na * N, T, D] (either may be
    missing), or a `torch.Generator` (or None) to draw them from. The models
    live on the device `build_models` put them on ("cuda" by default)."""
    if guided and specs is None:
        specs = flagship_guidance_specs(agents_per_scene)

    def policy(obs: TrafficBatch, rng=None) -> Action:
        noise = rng if isinstance(rng, dict) else {}
        out = sample_plans(
            models, obs, specs if guided else None, obs.world_from_agent, obs.scene_index,
            x_init=noise.get("x_init"), step_noises=noise.get("step_noises"),
            generator=None if isinstance(rng, dict) else rng, options=options,
            context_fields=observation_context_fields(obs) if guided else None,
        )
        return action_from_trajectory(out["best"])

    return policy
