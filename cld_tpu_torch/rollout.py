"""Closed-loop guided simulation CLI of the port.

    python -m cld_tpu_torch.rollout --num-scenes 4 --agents-per-scene 8 \\
        --guidance flagship --output rollout_out
    python -m cld_tpu_torch.rollout --device cpu --num-scenes 1 \\
        --agents-per-scene 2 --num-sim-steps 10 --raster-size 64 --diffusion-steps 10
    python -m cld_tpu_torch.rollout --sampler ddim --ddim-steps 20 --num-action-samples 4

Counterpart of the JAX package's `rollout.py` on what the port has so far:
synthetic straight-road scenes (`sim.scene.synthetic_scene_pack`), the
networks at the config of record's widths with seeded random weights or
weights converted from the JAX package (`--weights`, an .npz written from
`utils.weights.export_vae_checkpoint` + `export_dm_checkpoint`), the DDPM or
DDIM sampler with `--num-action-samples` samples per agent (the one with the
lowest guidance loss is executed), and the flagship guidance (agent collision
+ map collision) or none, on the schedule the `--guidance-*`, `--perturb-th` and `--guide-*` flags set
(names and defaults of the JAX package's `rollout.py`). It runs `sim.env.simulate`, prints
`summarize_metrics` and the throughput as JSON, and writes the world-frame
trajectory log to `<output>/trajectories.npz`. Runs on the CUDA card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from cld_tpu_torch import pipeline
from cld_tpu_torch.sim.env import SimConfig, simulate
from cld_tpu_torch.sim.metrics import summarize_metrics
from cld_tpu_torch.sim.scene import synthetic_scene_pack
from cld_tpu_torch.utils.weights import load_state_dicts


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="cld_tpu_torch closed-loop rollout")
    parser.add_argument("--num-scenes", type=int, default=4)
    parser.add_argument("--agents-per-scene", type=int, default=8)
    parser.add_argument("--num-sim-steps", type=int, default=100)
    parser.add_argument("--n-step-action", type=int, default=5)
    parser.add_argument("--raster-size", type=int, default=224)
    parser.add_argument("--hist-frames", type=int, default=30)
    parser.add_argument("--diffusion-steps", type=int, default=100)
    parser.add_argument("--guidance", choices=("flagship", "none"), default="flagship",
                        help="flagship: agent_collision + map_collision, weight 10 each")
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
    )
    policy = pipeline.make_dm_policy(models, args.agents_per_scene,
                                     guided=args.guidance == "flagship", options=options)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    state, traj = simulate(pack, policy, cfg, generator=gen)
    sync()
    wall = time.perf_counter() - t0

    report = summarize_metrics(pack, state, cfg)
    report.update(
        wall_s=wall,
        agent_steps_per_s=pack.num_agents * cfg.num_simulation_steps / wall,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        guidance=args.guidance,
    )
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
