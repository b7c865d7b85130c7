"""Closed-loop simulation CLI of the port.

    python -m cld_tpu_torch.rollout --vae-ckpt runs/vae/ckpt_final \
        --dm-ckpt runs/dm/ckpt_final --num-scenes 4 --agents-per-scene 8 \
        --guidance flagship --cle-report
    python -m cld_tpu_torch.rollout --vae-ckpt reference.ckpt --dm-ckpt reference.ckpt
    python -m cld_tpu_torch.rollout --device cpu --registered-name cld_smoke \
        --num-scenes 1 --agents-per-scene 2 --num-sim-steps 10
    python -m cld_tpu_torch.rollout --sampler ddim --ddim-steps 20 --num-action-samples 4 \
        --guidance flagship
    python -m cld_tpu_torch.rollout --guidance 'speed_limit:15,agent_collision' \
        --editing-source config,heuristic --heuristics stop_sign,social_group
    python -m cld_tpu_torch.rollout --scene-data data/synthetic_shards --policy dm \
        --agents-policy gt_replay --guidance flagship --num-action-samples 2 --guide-with-gt
    python -m cld_tpu_torch.rollout --scene-data data/synthetic_shards --policy mpc
    python -m cld_tpu_torch.rollout --guidance flagship --ebm-ckpt runs/ebm/ckpt_final
    python -m cld_tpu_torch.rollout --composer BC --composer-ckpt runs/zoo_bc/ckpt_final \
        --registered-name nusc_bc
    python -m cld_tpu_torch.rollout --policy lattice --device cpu --render

Counterpart of the JAX package's `rollout.py`, with its flag names and
defaults (one scene of 4 agents, no guidance rule). The world is the
synthetic straight road (`sim.scene.synthetic_scene_pack`) or, with
`--scene-data`, converted scenes from packed shards
(`sim.scene.scene_pack_from_shards`, from `--scene-start-index`). The
policy is `--policy`: `dm`, the latent diffusion policy, or one of the
model-free `lattice`, `gt_replay`, `mpc` and `contingency`;
`--agents-policy` gives the agents other than each scene's first (the ego)
another one. `--composer` names a policy composer of `eval.composers` (the
24 of the reference's registry: BC, TrafficSim, Diffuser, SceneDiffuser,
...), which overrides `--policy` and is also what `--agents-policy` builds,
as in the JAX CLI: its weights are fresh from `--seed`, or the
`--composer-ckpt` file (a trainer's `ckpt_final`, loaded strictly). The `dm` policy's networks are at the widths of the experiment
config (`--config`, `--registered-name`; the config of record by default),
with seeded random weights or trained ones: `--vae-ckpt` / `--dm-ckpt` take
a VAE / DM stage's `ckpt_final` of `python -m cld_tpu_torch.train`, the
output of `python -m cld_tpu_torch.utils.torch_import`, or a reference
Lightning `.ckpt` (one file may serve both flags); `--weights` an .npz
written from `utils.weights.export_vae_checkpoint` +
`export_dm_checkpoint`. The DDPM or DDIM sampler runs with
`--num-action-samples` samples per agent (kept: the one closest to the
observation's ground-truth future with `--guide-with-gt`, else the one with
the lowest guidance loss) under the guidance rules of the editing sources
(`build_guidance_specs`): `--guidance` takes the JAX CLI's grammar
(shorthand, inline JSON, `@file`; empty, the default, or `none`: no rule,
an unguided policy) and `flagship` (agent collision + map collision, weight
10 each); `--editing-source` adds rules built from the scene
(`--heuristics`, `--attack-pair`) or read from `--ui-edits-file`. The
`--guidance-*`, `--perturb-th` and `--guide-*` flags set the schedule,
`--decode-impl` picks the decoder's kernel-backed core or its module.

As the JAX CLI does, it runs `sim.env.simulate` twice: a warm-up episode
from a generator seeded `--seed` (its time is `compile_and_first_run_s`),
then the timed episode from `--seed` + 1, whose `wall_clock_s`,
`agent_steps_per_sec`, metrics and log are reported. The kernel launch
counts (`ops.native`) are zeroed before the timed episode, so that after
`main` they hold that episode and the reports. It prints as JSON
`summarize_metrics`, the occupancy-grid metrics, with `--cle-report` the
closed-loop evaluator's summary, with `--ebm-ckpt` (a `--mode ebm` stage's
`ckpt_final`) the learned realism metric of the log (`ebm_score_mean`,
`ebm_score_min`), the throughput, each rule's satisfaction
on the executed trajectories and the episode's kernel launches, and writes
the world-frame trajectory log to `<output>/trajectories.npz`; with
`--render`, each scene's rollout plot `<output>/scene_XXX.png` and its
animation `scene_XXX.gif` (a frame every `--save-every-n-frames` frames,
`--render-size` inches; needs matplotlib and Pillow, which are imported only
then). Runs on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import torch

from cld_tpu_torch import pipeline
from cld_tpu_torch.eval.composers import COMPOSER_REGISTRY, get_composer
from cld_tpu_torch.guidance.losses import GuidanceContext
from cld_tpu_torch.guidance.parsing import parse_guidance_arg, specs_from_configs
from cld_tpu_torch.models.vae import DECODE_IMPLS
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops.dynamics import UnicycleParams
from cld_tpu_torch.ops.geometry import world_from_agent_matrix
from cld_tpu_torch.policies.wrappers import masked_policy
from cld_tpu_torch.sim.env import SimConfig, init_sim_state, simulate
from cld_tpu_torch.sim.metrics import summarize_metrics
from cld_tpu_torch.sim.scene import scene_pack_from_shards, synthetic_scene_pack
from cld_tpu_torch.utils.registry import config_from_flags
from cld_tpu_torch.utils.weights import load_state_dicts

POLICIES = ("dm", "lattice", "gt_replay", "mpc", "contingency")


def build_guidance_specs(args, pack, sim_cfg, num_agents):
    """Guidance rules from the editing sources (`--editing-source`, a comma
    list):

    * config     - the `--guidance` rules, always included: `flagship`,
                   empty or `none` (no rule), shorthand, inline JSON or @file
    * heuristic  - `--heuristics`: a comma list of names, or @file.json of
                   {name, weight, params} configs in the reference's format;
                   and `--attack-pair`
    * ui         - `--ui-edits-file`: a guidance-config JSON written by an
                   interactive editor, read afresh on every run
    * none       - only the `--guidance` rules
    """
    known_sources = {"config", "heuristic", "ui", "none"}
    sources = [s for s in args.editing_source.split(",") if s]
    unknown = set(sources) - known_sources
    if unknown:
        raise SystemExit(f"unknown --editing-source {sorted(unknown)}; expected a comma list "
                         f"of {sorted(known_sources)}")
    if args.guidance == "flagship":
        specs = pipeline.flagship_guidance_specs(args.agents_per_scene)
    elif args.guidance == "none":
        specs = []
    else:
        specs = specs_from_configs(parse_guidance_arg(args.guidance), num_agents)
    if "heuristic" in sources:
        from cld_tpu_torch.guidance.heuristics import (
            compute_heuristic_guidance,
            heuristic_collision_attack,
            heuristics_from_configs,
        )

        state0 = init_sim_state(pack, sim_cfg)
        if args.heuristics.startswith("@"):
            with open(args.heuristics[1:]) as f:
                specs.extend(heuristics_from_configs(json.load(f), pack, state0, dt=sim_cfg.dt))
        else:
            names = [n for n in args.heuristics.split(",") if n]
            specs.extend(compute_heuristic_guidance(names, pack, state0, dt=sim_cfg.dt))
        if args.attack_pair:
            a, v = (int(s) for s in args.attack_pair.split(","))
            specs.append(heuristic_collision_attack(a, v))
    if "ui" in sources:
        if not args.ui_edits_file:
            raise SystemExit("--editing-source ui requires --ui-edits-file")
        specs.extend(specs_from_configs(parse_guidance_arg("@" + args.ui_edits_file),
                                        num_agents))
    return specs


def raster_from_world_per_agent(pack):
    """[Na, 3, 3] world -> world-map pixel transforms, each from its own
    scene's map origin."""
    org = pack.map_origin[pack.scene_index.long()]  # [Na, 2]
    res = float(pack.map_resolution)
    zeros, ones = torch.zeros_like(org[:, 0]), torch.ones_like(org[:, 0])
    return torch.stack([
        torch.stack([ones / res, zeros, -org[:, 0] / res], dim=-1),
        torch.stack([zeros, ones / res, -org[:, 1] / res], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=1)


def occupancy_report(pack, traj):
    """Occupancy-grid metrics over the executed rollout (`env_metrics.py:977+`),
    one grid per scene: each scene's positions are splatted against its own
    map and origin, then each reduction is averaged over the scenes."""
    from cld_tpu_torch.sim.occupancy import occupancy_init, occupancy_metrics, occupancy_update

    Hw = pack.world_map.shape[1]
    si = pack.scene_index
    per_scene = []
    for s in range(pack.world_map.shape[0]):
        in_scene = si == s
        if not bool(in_scene.any()):
            continue
        occ = occupancy_init(
            origin=(float(pack.map_origin[s, 0]), float(pack.map_origin[s, 1])),
            size=(Hw // 2, Hw // 2), step=2 * pack.map_resolution, sigma=1.0,
            device=traj.device,
        )
        occ = occupancy_update(occ, traj[:, in_scene, :2].reshape(-1, 2))
        per_scene.append(occupancy_metrics(occ, pack.world_map[s, :, :, 0], pack.map_origin[s],
                                           pack.map_resolution))
    return {k: float(np.mean([d[k] for d in per_scene])) for k in per_scene[0]}


def guidance_satisfaction_report(pack, traj, sim_cfg, specs):
    """Each rule's satisfaction on the executed world-frame trajectories
    (`guidance.metrics.guidance_metrics`), averaged over its agents: 0 is
    fully satisfied."""
    from cld_tpu_torch.guidance.metrics import executed_traj_from_states, guidance_metrics

    executed = executed_traj_from_states(traj, dt=sim_cfg.dt)
    Na = pack.num_agents
    si = pack.scene_index.long()
    dev = traj.device
    # the executed trajectories are world-frame: the context's "agent" frame
    # is the world, so the world lane points serve as they are
    exec_ctx = GuidanceContext(
        drivable_map=pack.world_map[si, :, :, 0],
        raster_from_agent=raster_from_world_per_agent(pack),
        extent=pack.extent,
        curr_speed=pack.init_states[:, 2],
        world_from_agent=world_from_agent_matrix(torch.zeros((Na, 2), device=dev),
                                                 torch.zeros((Na,), device=dev)),
        scene_index=pack.scene_index,
        lane_points=pack.lane_points[si] if pack.lane_points is not None else None,
        lane_avail=pack.lane_avail[si] if pack.lane_avail is not None else None,
    )
    gm = guidance_metrics(specs, executed, exec_ctx)
    return {k: float(np.nanmean(v)) for k, v in gm.items()}


def ebm_report(run, traj, path) -> dict:
    """The learned realism metric of the executed rollout: the EBM of `path`
    (a `--mode ebm` stage's `ckpt_final`, at the widths of the run's config)
    scores the log at every 10th frame over the config's horizon
    (`sim.learned_metrics`); mean and min over anchors and agents."""
    from cld_tpu_torch.sim.learned_metrics import ebm_rollout_metric
    from cld_tpu_torch.training.checkpoints import restore_pytree
    from cld_tpu_torch.training.ebm import EBMTrainer

    trainer = EBMTrainer(run.cfg, device=run.device)
    state = trainer.init_state(0)
    state.model.load_state_dict(restore_pytree(path, device=run.device)["params"], strict=True)
    with torch.no_grad():
        em = ebm_rollout_metric(run.pack, traj, trainer.score_fn(state), run.sim_cfg,
                                horizon=run.cfg.algo.horizon)
    return {"ebm_score_mean": float(em["ebm_score_mean"]),
            "ebm_score_min": float(em["ebm_score_min"])}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="cld_tpu_torch closed-loop rollout")
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config (YAML or JSON) over the defaults or over "
                             "--registered-name")
    parser.add_argument("--registered-name", type=str, default=None,
                        help="named experiment config (cld_tpu_torch.utils.registry); must match "
                             "the config the checkpoints were trained with")
    parser.add_argument("--vae-ckpt", type=str, default=None,
                        help="VAE weights: a VAE stage's ckpt_final, a torch_import output, or "
                             "a reference Lightning .ckpt (vae. keys)")
    parser.add_argument("--dm-ckpt", type=str, default=None,
                        help="denoiser weights: a DM stage's ckpt_final, a torch_import output, "
                             "or a reference Lightning .ckpt (dm.model. keys)")
    parser.add_argument("--scene-data", type=str, default=None,
                        help="packed-shard directory of converted scenes "
                             "(cld_tpu_torch.data.convert): the world is built from them "
                             "instead of the synthetic road")
    parser.add_argument("--scene-start-index", type=int, default=0,
                        help="first sample of --scene-data to take")
    parser.add_argument("--num-scenes", type=int, default=1)
    parser.add_argument("--agents-per-scene", type=int, default=4)
    parser.add_argument("--num-sim-steps", type=int, default=100)
    parser.add_argument("--n-step-action", type=int, default=5)
    parser.add_argument("--raster-size", type=int, default=None,
                        help="default: the config's env.rasterizer.raster_size")
    parser.add_argument("--hist-frames", type=int, default=None,
                        help="default: the config's algo.history_num_frames")
    parser.add_argument("--diffusion-steps", type=int, default=None,
                        help="default: the config's algo.n_diffusion_steps")
    parser.add_argument("--precision", type=str, default=None,
                        help="network compute dtype of the dm policy's models, the "
                             "SceneDiffuser composer's denoiser and the --ebm-ckpt metric "
                             "(default: the config's train.training.precision): auto (bf16 on "
                             "the card, fp32 on the CPU), bf16 or fp32. The other composers' "
                             "networks compute in fp32")
    parser.add_argument("--decode-impl", choices=DECODE_IMPLS, default="auto",
                        help="decoder inside guidance and decode: kernel (auto) is the "
                             "kernel-backed LSTM core, module the decoder's own layer stack")
    parser.add_argument("--policy", choices=POLICIES, default="dm",
                        help="dm: guided latent diffusion; lattice: kinematic lattice planner; "
                             "gt_replay: replay the dataset's actions; mpc: FTOCP penalty "
                             "solver; contingency: tree contingency planner")
    parser.add_argument("--agents-policy", choices=POLICIES, default=None,
                        help="policy of the agents other than each scene's first (the ego)")
    parser.add_argument("--composer", choices=sorted(COMPOSER_REGISTRY), default=None,
                        help="named policy composer (cld_tpu_torch.eval.composers); overrides "
                             "--policy and --agents-policy. Weights: --composer-ckpt, else "
                             "fresh from --seed")
    parser.add_argument("--composer-ckpt", type=str, default=None,
                        help="the composer's policy weights: a trainer's ckpt_final "
                             "({'params': state_dict}, loaded strictly)")
    parser.add_argument("--guidance", type=str, default="",
                        help="rules, e.g. 'speed_limit:15,agent_collision', inline JSON "
                             "configs, or @file.json; flagship: agent_collision + "
                             "map_collision, weight 10 each; empty (the default) or none: "
                             "no rule")
    parser.add_argument("--editing-source", type=str, default="config",
                        help="comma list of config|heuristic|ui|none. heuristic: rules built "
                             "from the scene's state (--heuristics); ui: guidance configs read "
                             "from --ui-edits-file (fresh each run)")
    parser.add_argument("--heuristics", type=str,
                        default="target_speed,agent_collision,map_collision",
                        help="comma list for --editing-source heuristic, or @file.json of "
                             "reference-format {name, weight, params} heuristic configs")
    parser.add_argument("--ui-edits-file", type=str, default=None,
                        help="guidance-config JSON for --editing-source ui; re-read on every "
                             "run (forces one scene)")
    parser.add_argument("--attack-pair", type=str, default=None,
                        help="'attacker,victim' agent indices for an adversarial "
                             "collision-attack rule (with --editing-source heuristic)")
    parser.add_argument("--guide-as-filter-only", action="store_true",
                        help="no per-step perturbation; the rules only select among "
                             "--num-action-samples plans")
    parser.add_argument("--guide-with-gt", action="store_true",
                        help="with --num-action-samples > 1: keep the sample closest to the "
                             "observation's ground-truth future instead of the one with the "
                             "lowest guidance loss")
    parser.add_argument("--sampler", choices=("ddpm", "ddim"), default="ddpm")
    parser.add_argument("--ddim-steps", type=int, default=50)
    parser.add_argument("--ddim-eta", type=float, default=0.0)
    parser.add_argument("--num-action-samples", type=int, default=1)
    parser.add_argument("--guidance-lr", type=float, default=0.3)
    parser.add_argument("--guidance-steps", type=int, default=1)
    parser.add_argument("--guidance-stride", type=int, default=1,
                        help="apply guidance every k-th denoise step")
    parser.add_argument("--perturb-th", type=float, default=None,
                        help="clip bound on the cumulative perturbation; default: the "
                             "posterior sigma at step t; a value decays sigmoidally from ~4 "
                             "to it over the denoise steps")
    parser.add_argument("--guide-clean", action="store_true",
                        help="perturb the clean x0 reconstruction instead of the posterior mean")
    parser.add_argument("--guide-output", action="store_true",
                        help="also perturb the final t=0 output step")
    parser.add_argument("--cle-report", action="store_true",
                        help="add the closed-loop evaluator's summary (range validators and "
                             "driven-miles composites, cld_tpu_torch.eval.cle) to the report")
    parser.add_argument("--ebm-ckpt", type=str, default=None,
                        help="trained PermuteEBM checkpoint (the ckpt_final of "
                             "python -m cld_tpu_torch.train --mode ebm); adds the learned "
                             "closed-loop realism metric, ebm_score_mean / ebm_score_min, "
                             "to the report")
    parser.add_argument("--render", action="store_true",
                        help="save each scene's rollout plot (scene_XXX.png) and animation "
                             "(scene_XXX.gif) under --output; needs matplotlib and Pillow")
    parser.add_argument("--save-every-n-frames", type=int, default=5,
                        help="the animation's frame stride")
    parser.add_argument("--render-size", type=float, default=8.0,
                        help="render figure size in inches")
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz of converted JAX-package weights (default: random from --seed)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", type=str, default="rollout_out")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if "ui" in args.editing_source.split(","):
        args.num_scenes = 1  # UI edits target one scene
    return args


def experiment_config(args):
    """The config of `--registered-name` / `--config` (the config of record
    by default), with `--hist-frames`, `--diffusion-steps` and `--precision`
    over it."""
    cfg = config_from_flags(args.registered_name, args.config).unlock()
    if args.precision is not None:
        cfg.train.training.precision = args.precision
    if args.hist_frames is not None:
        cfg.algo.history_num_frames = args.hist_frames
    if args.diffusion_steps is not None:
        cfg.algo.n_diffusion_steps = args.diffusion_steps
    return cfg.lock()


def build_policy(name, args, cfg, sim_cfg, pack, models, specs, options):
    """The named policy: `dm` (the latent diffusion policy over `models`,
    guided by `specs`) or a model-free one."""
    if name == "lattice":
        from cld_tpu_torch.policies.planner import LatticePlannerConfig, lattice_planner_policy

        return lattice_planner_policy(LatticePlannerConfig(
            horizon=cfg.algo.horizon, dt=sim_cfg.dt, dyn=sim_cfg.dyn))
    if name == "gt_replay":
        from cld_tpu_torch.policies.hardcoded import replay_policy

        return replay_policy(pack.replay_actions)
    if name == "mpc":
        from cld_tpu_torch.policies.mpc import MPCConfig, mpc_policy

        return mpc_policy(MPCConfig(N=max(20, args.n_step_action), dt=sim_cfg.dt))
    if name == "contingency":
        from cld_tpu_torch.policies.contingency import ContingencyConfig, contingency_policy

        return contingency_policy(ContingencyConfig(dt=sim_cfg.dt, dyn=sim_cfg.dyn))
    return pipeline.make_dm_policy(models, args.agents_per_scene, guided=bool(specs),
                                   specs=specs, options=options)


def build(args) -> SimpleNamespace:
    """Everything a run needs, as the CLI builds it: the config, the
    simulator's config, the scene pack, the models (trained weights loaded;
    None when no policy is `dm`), the guidance specs and the policy."""
    dev = torch.device(args.device)
    cfg = experiment_config(args)
    sim_cfg = SimConfig(
        num_simulation_steps=args.num_sim_steps, n_step_action=args.n_step_action,
        hist_frames=cfg.algo.history_num_frames,
        raster_size=args.raster_size or cfg.env.rasterizer.raster_size,
        pixel_size=cfg.env.rasterizer.pixel_size,
        dyn=UnicycleParams.from_config(cfg.algo.dynamics),
    )
    if args.scene_data:
        pack = scene_pack_from_shards(
            args.scene_data, num_scenes=args.num_scenes, agents_per_scene=args.agents_per_scene,
            sim_steps=args.num_sim_steps, start_index=args.scene_start_index, device=dev,
        )
    else:
        pack = synthetic_scene_pack(
            seed=args.seed, num_scenes=args.num_scenes, agents_per_scene=args.agents_per_scene,
            sim_steps=args.num_sim_steps, device=dev,
        )
    models = None
    if not args.composer and "dm" in (args.policy, args.agents_policy):
        if pack.world_map.shape[-1] != cfg.env.rasterizer.num_sem_layers:
            raise ValueError(f"the scenes have {pack.world_map.shape[-1]} map layers, the "
                             f"config {cfg.env.rasterizer.num_sem_layers}")
        models = pipeline.build_models_from_config(cfg, device=dev, seed=args.seed)
        pipeline.load_checkpoints(models, args.vae_ckpt, args.dm_ckpt)
        if args.weights:
            with np.load(args.weights) as sd:
                load_state_dicts(models.context, models.decoder, models.unet, dict(sd))
    options = pipeline.SamplingOptions(
        num_samp=args.num_action_samples, sampler=args.sampler, ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta, guidance_lr=args.guidance_lr, guidance_steps=args.guidance_steps,
        perturb_th=args.perturb_th, guidance_stride=args.guidance_stride,
        guidance_clean=args.guide_clean, guidance_output=args.guide_output,
        guide_as_filter_only=args.guide_as_filter_only, guide_with_gt=args.guide_with_gt,
        decode_impl=args.decode_impl,
    )
    specs = build_guidance_specs(args, pack, sim_cfg, pack.num_agents)
    if args.composer:
        # a composer is what every policy name builds, as in the JAX CLI
        make = lambda name: get_composer(args.composer)(
            cfg, pack, sim_cfg, ckpts={"policy": args.composer_ckpt},
            generator=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    else:
        make = lambda name: build_policy(name, args, cfg, sim_cfg, pack, models, specs, options)
    policy = make(args.policy)
    if args.agents_policy and args.agents_policy != args.policy:
        # ego = first agent of each scene
        ego_mask = torch.zeros(pack.num_agents, dtype=torch.bool, device=dev)
        ego_mask[:: args.agents_per_scene] = True
        policy = masked_policy(ego_mask, policy, make(args.agents_policy))
    return SimpleNamespace(cfg=cfg, sim_cfg=sim_cfg, pack=pack, models=models, specs=specs,
                           options=options, policy=policy, device=dev)


def main(argv=None) -> dict:
    args = parse_args(argv)
    run = build(args)
    dev, cfg, pack, specs = run.device, run.sim_cfg, run.pack, run.specs
    rules = [type(s.loss).__name__ for s in specs]
    print(f"rollout: {pack.num_agents} agents, {cfg.num_replans} replans x "
          f"{cfg.n_step_action} steps, policy={args.policy}, agents_policy={args.agents_policy}, "
          f"composer={args.composer}, rules={rules or 'none'}", flush=True)

    def episode(seed):
        """One episode from a generator seeded `seed`: (state, log, seconds)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, traj = simulate(pack, run.policy, cfg, generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return state, traj, time.perf_counter() - t0

    first_s = episode(args.seed)[2]  # the warm-up: builds, caches and first calls
    before = native.launch_counts()
    state, traj, wall = episode(args.seed + 1)
    after = native.launch_counts()

    report = summarize_metrics(pack, state, cfg)
    report.update(occupancy_report(pack, traj))
    if args.cle_report:
        from cld_tpu_torch.eval.cle import cle_report

        report["cle"] = cle_report(pack, traj, cfg)
    if args.ebm_ckpt:
        report.update(ebm_report(run, traj, args.ebm_ckpt))
    report.update(
        wall_clock_s=wall,
        agent_steps_per_sec=pack.num_agents * cfg.num_simulation_steps / wall,
        compile_and_first_run_s=first_s,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        policy=args.policy,
        agents_policy=args.agents_policy,
        composer=args.composer,
        guidance=args.guidance,
        rules=rules,
        launches={k: after[k] - before[k] for k in after},
    )
    if specs:
        report["guidance_satisfaction"] = guidance_satisfaction_report(pack, traj, cfg, specs)
    print(json.dumps(report, indent=2))
    os.makedirs(args.output, exist_ok=True)
    np.savez(
        os.path.join(args.output, "trajectories.npz"),
        trajectories=traj.cpu().numpy(),
        controlled_mask=pack.controlled_mask.cpu().numpy(),
        scene_index=pack.scene_index.cpu().numpy(),
    )
    print(f"saved trajectories -> {args.output}/trajectories.npz")
    if args.render:
        from cld_tpu_torch.viz.render import render_scene_rollout, save_rollout_gif

        for s in range(args.num_scenes):
            render_scene_rollout(pack, traj, scene=s,
                                 out_path=os.path.join(args.output, f"scene_{s:03d}.png"),
                                 figsize=args.render_size)
            save_rollout_gif(pack, traj, os.path.join(args.output, f"scene_{s:03d}.gif"),
                             scene=s, stride=args.save_every_n_frames, figsize=args.render_size)
        print(f"saved renders -> {args.output}/scene_*.png/gif")
    return report


if __name__ == "__main__":
    main()
