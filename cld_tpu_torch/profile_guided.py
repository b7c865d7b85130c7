"""Where the guided pipeline's time goes on one GPU.

    python -m cld_tpu_torch.profile_guided [--precision auto|bf16|fp32]

At the full width of the config of record (B=128, raster 224, 100 DDPM
steps, seeded random weights), with TF32 off, at `--precision` ("auto", the
default, is bf16 on the card), this measures:

* the whole guided and unguided calls (host clock around a synchronised
  call), best of 3;
* per-stage host times of one denoise step: the UNet forward, one guidance
  step (decode forward + losses + backward + Adam), and the encode and the
  final decode + reward of a call, each averaged over repeats;
* one guided call under `torch.profiler`: the device time summed over all
  kernels, its share of the wall time (the rest is the device idling while
  the host issues work), the number of kernel launches, and the kernels
  that take the most device time.

* one replan of the guided closed loop (4 scenes x 8 agents: render, the
  guided call at B=32, 5 frames of stepping) under `torch.profiler`, the same
  way;
* the three map-gather kernels' device time per launch at the paths' shapes,
  from replays of a CUDA graph that holds 100 launches: back-to-back
  launches from Python are bound by the host's launch path (~25 us each),
  which the graph takes out.

Prints a summary and writes chiprun_out/profile_guided.json. Needs a CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from cld_tpu_torch import pipeline
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.guidance.losses import GuidanceContext, prepack_drivable
from cld_tpu_torch.guidance.perturbation import make_perturbation_guidance
from cld_tpu_torch.algos.reward import compute_reward
from cld_tpu_torch.ops import gather_kernels as gk
from cld_tpu_torch.sim import env
from cld_tpu_torch.sim.scene import synthetic_scene_pack

B, RASTER, A = 128, 224, 4


def _host_s(fn, repeats: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeats


def _profile(fn) -> dict:
    """Run fn once under torch.profiler: wall time, summed device time of
    all kernels, launches, and the kernels that take the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time for e in kernels)
    rows = {}
    for e in kernels:
        r = rows.setdefault(e.name, [0, 0.0])
        r[0] += 1
        r[1] += e.device_time
    top = sorted(rows.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "wall_s": wall,
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:120], "count": c, "device_ms": us * 1e-3}
                        for n, (c, us) in top],
    }


def _graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    """Device ms per call of fn, from replays of a CUDA graph of `launches`
    calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def _gather_device_ms(dev) -> dict:
    g = torch.Generator().manual_seed(0)

    def pix(M, Q, W, H):
        return torch.stack([torch.randint(0, W, (M, Q), generator=g),
                            torch.randint(0, H, (M, Q), generator=g)],
                           dim=-1).to(torch.int32).to(dev).contiguous()

    wins = torch.randint(-128, 128, (64, 256, 256, 3), generator=g, dtype=torch.int8).to(dev)
    pw = pix(64, 112 * 224, 256, 256)
    drv = (torch.rand((32, 224, 224), generator=g) < 0.6).to(torch.int8).to(dev)
    pd = pix(32, 5200, 224, 224)
    drv128 = (torch.rand((128, 224, 224), generator=g) < 0.6).to(dev)
    packed = gk.pack_drivable_bits(drv128)
    pb = pix(128, 5200, 224, 224)
    return {
        "value_gather [64 x 25088 queries, 256x256x3 windows]":
            _graph_ms(lambda: gk.value_gather(pw, wins)),
        "drivable_gather [32 x 5200 queries, 224x224 int8 maps]":
            _graph_ms(lambda: gk.drivable_gather(pd, drv)),
        "bit_gather [128 x 5200 queries, 224x28 packed maps]":
            _graph_ms(lambda: gk.drivable_bit_gather(pb, packed)),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="where the guided pipeline's time goes")
    parser.add_argument("--precision", type=str, default="auto",
                        help="network compute dtype: auto (bf16 on the card), bf16 or fp32")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_guided: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    models = pipeline.build_models(seed=0, device=dev, precision=args.precision)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    gen = torch.Generator(device=dev)
    call = lambda guided, seed: pipeline.guided_collect(
        models, batch, guided=guided, agents_per_scene=A, generator=gen.manual_seed(seed))
    call(True, 0)  # warm-up: kernel build, cuDNN plans, allocator
    call(False, 0)
    rep = {"card": card, "torch": torch.__version__, "compute_dtype": str(models.compute_dtype)}
    rep["guided_call_s"] = min(_host_s(lambda: call(True, 1), 1) for _ in range(3))
    rep["unguided_call_s"] = min(_host_s(lambda: call(False, 1), 1) for _ in range(3))

    # per-stage host times (each ends in a synchronise)
    with torch.no_grad():
        aux = models.context(batch)
    cond, curr = aux["cond_feat"], aux["curr_states"]
    x = torch.randn((B, 52, 4), device=dev, generator=gen.manual_seed(2))
    t = torch.full((B,), 50, dtype=torch.long, device=dev)
    normalizer = pipeline.TrajNormalizer()

    def decode_fn(z):
        acts = pipeline.decode_actions(models.decoder, z, cond)
        return pipeline.convert_action_to_state_and_action(
            acts, curr, models.dyn, normalizer, descaled_output=True)[:, None]

    wfa, si = pipeline.scene_world_poses(B, A, dev)
    ctx = prepack_drivable(GuidanceContext(batch.drivable_map, batch.raster_from_agent,
                                           batch.extent, batch.curr_speed, wfa, si))
    gfn = make_perturbation_guidance(
        ctx, pipeline.flagship_guidance_specs(A), decode_fn, lr=0.3, perturb_th=None,
        sigma_schedule=torch.exp(0.5 * models.schedule.posterior_log_variance_clipped))

    def final():
        with torch.no_grad():
            traj = decode_fn(x)
            return compute_reward(traj, batch, normalizer.scale(traj))

    with torch.no_grad():
        rep["stage_s"] = {
            "encode": _host_s(lambda: models.context(batch), 10),
            "unet_forward": _host_s(lambda: models.unet(x, cond, t), 50),
            "guidance_step": _host_s(lambda: gfn(x, 50), 20),
            "decode_and_reward": _host_s(final, 20),
        }

    rep["profiled_guided_call"] = _profile(lambda: call(True, 3))

    # one replan of the guided closed loop (render + policy + 5 frames)
    pack = synthetic_scene_pack(seed=0, num_scenes=4, agents_per_scene=8, sim_steps=100,
                                device=dev)
    cfg = env.SimConfig(num_simulation_steps=5, n_step_action=5, raster_size=RASTER)
    policy = pipeline.make_dm_policy(models, 8)
    replan = lambda seed: env.simulate(pack, policy, cfg, generator=gen.manual_seed(seed))
    replan(4)  # warm-up at B=32
    rep["closed_loop_replan_s"] = min(_host_s(lambda: replan(5), 1) for _ in range(3))
    rep["profiled_closed_loop_replan"] = _profile(lambda: replan(6))
    rep["gather_device_ms"] = _gather_device_ms(dev)

    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_guided.json").write_text(json.dumps(rep, indent=1))
    print(json.dumps({k: v for k, v in rep.items() if not k.startswith("profiled_")}, indent=1))
    for what in ("profiled_guided_call", "profiled_closed_loop_replan"):
        p = rep[what]
        print(f"{what}: wall {p['wall_s']:.3f} s, device busy {p['device_busy_s']:.3f} s "
              f"({100 * p['device_busy_share']:.1f}%), {p['kernel_launches']} kernel launches")
        for k in p["top_kernels"]:
            print(f"  {k['device_ms']:9.2f} ms  {k['count']:6d}x  {k['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
