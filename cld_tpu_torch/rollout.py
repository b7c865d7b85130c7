"""Closed-loop guided simulation CLI of the port.

    python -m cld_tpu_torch.rollout --num-scenes 4 --agents-per-scene 8 \\
        --guidance flagship --output rollout_out
    python -m cld_tpu_torch.rollout --device cpu --num-scenes 1 \\
        --agents-per-scene 2 --num-sim-steps 10 --raster-size 64 --diffusion-steps 10
    python -m cld_tpu_torch.rollout --sampler ddim --ddim-steps 20 --num-action-samples 4
    python -m cld_tpu_torch.rollout --guidance 'speed_limit:15,agent_collision' \
        --editing-source config,heuristic --heuristics stop_sign,social_group

Counterpart of the JAX package's `rollout.py` on what the port has so far:
synthetic straight-road scenes (`sim.scene.synthetic_scene_pack`), the
networks at the config of record's widths with seeded random weights or
weights converted from the JAX package (`--weights`, an .npz written from
`utils.weights.export_vae_checkpoint` + `export_dm_checkpoint`), the DDPM or
DDIM sampler with `--num-action-samples` samples per agent (the one with the
lowest guidance loss is executed), and the guidance rules of the editing
sources (`build_guidance_specs`): `--guidance` takes `flagship` (agent
collision + map collision, weight 10 each, the default), `none`, or the JAX
CLI's grammar (shorthand, inline JSON, `@file`); `--editing-source` adds
rules built from the scene (`--heuristics`, `--attack-pair`) or read from
`--ui-edits-file`. The schedule is what the `--guidance-*`, `--perturb-th` and
`--guide-*` flags set (names and defaults of the JAX package's `rollout.py`).
It runs `sim.env.simulate`, prints `summarize_metrics`, the throughput, each
rule's satisfaction on the executed trajectories and the episode's kernel
launches as JSON, and writes the
world-frame trajectory log to `<output>/trajectories.npz`. Runs on the CUDA
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from cld_tpu_torch import pipeline
from cld_tpu_torch.guidance.losses import GuidanceContext
from cld_tpu_torch.guidance.parsing import parse_guidance_arg, specs_from_configs
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops.geometry import world_from_agent_matrix
from cld_tpu_torch.sim.env import SimConfig, init_sim_state, simulate
from cld_tpu_torch.sim.metrics import summarize_metrics
from cld_tpu_torch.sim.scene import synthetic_scene_pack
from cld_tpu_torch.utils.weights import load_state_dicts


def build_guidance_specs(args, pack, sim_cfg, num_agents):
    """Guidance rules from the editing sources (`--editing-source`, a comma
    list):

    * config     - the `--guidance` rules, always included: `flagship`,
                   `none`, shorthand, inline JSON or @file
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


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="cld_tpu_torch closed-loop rollout")
    parser.add_argument("--num-scenes", type=int, default=4)
    parser.add_argument("--agents-per-scene", type=int, default=8)
    parser.add_argument("--num-sim-steps", type=int, default=100)
    parser.add_argument("--n-step-action", type=int, default=5)
    parser.add_argument("--raster-size", type=int, default=224)
    parser.add_argument("--hist-frames", type=int, default=30)
    parser.add_argument("--diffusion-steps", type=int, default=100)
    parser.add_argument("--guidance", type=str, default="flagship",
                        help="flagship: agent_collision + map_collision, weight 10 each; none; "
                             "or rules, e.g. 'speed_limit:15,agent_collision', inline JSON "
                             "configs, or @file.json")
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
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz of converted JAX-package weights (default: random from --seed)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", type=str, default="rollout_out")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if "ui" in args.editing_source.split(","):
        args.num_scenes = 1  # UI edits target one scene
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = torch.device(args.device)
    cfg = SimConfig(
        num_simulation_steps=args.num_sim_steps, n_step_action=args.n_step_action,
        hist_frames=args.hist_frames, raster_size=args.raster_size,
    )
    pack = synthetic_scene_pack(
        seed=args.seed, num_scenes=args.num_scenes, agents_per_scene=args.agents_per_scene,
        sim_steps=args.num_sim_steps, device=dev,
    )
    models = pipeline.build_models(
        seed=args.seed, device=dev, raster_channels=args.hist_frames + 1 + pack.world_map.shape[-1],
        n_diffusion_steps=args.diffusion_steps,
    )
    if args.weights:
        with np.load(args.weights) as sd:
            load_state_dicts(models.context, models.decoder, models.unet, dict(sd))
    options = pipeline.SamplingOptions(
        num_samp=args.num_action_samples, sampler=args.sampler, ddim_steps=args.ddim_steps,
        ddim_eta=args.ddim_eta, guidance_lr=args.guidance_lr, guidance_steps=args.guidance_steps,
        perturb_th=args.perturb_th, guidance_stride=args.guidance_stride,
        guidance_clean=args.guide_clean, guidance_output=args.guide_output,
        guide_as_filter_only=args.guide_as_filter_only,
    )
    specs = build_guidance_specs(args, pack, cfg, pack.num_agents)
    rules = [type(s.loss).__name__ for s in specs]
    print(f"rollout: {pack.num_agents} agents, {cfg.num_replans} replans x "
          f"{cfg.n_step_action} steps, rules={rules or 'none'}", flush=True)
    policy = pipeline.make_dm_policy(models, args.agents_per_scene, guided=bool(specs),
                                     specs=specs, options=options)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    before = native.launch_counts()
    t0 = time.perf_counter()
    state, traj = simulate(pack, policy, cfg, generator=gen)
    sync()
    wall = time.perf_counter() - t0
    after = native.launch_counts()

    report = summarize_metrics(pack, state, cfg)
    report.update(
        wall_s=wall,
        agent_steps_per_s=pack.num_agents * cfg.num_simulation_steps / wall,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
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
    return report


if __name__ == "__main__":
    main()
