"""Where the guided pipeline's time goes on one GPU.

    python -m cld_tpu_torch.profile_guided

At the full width of the config of record (B=128, raster 224, 100 DDPM
steps, seeded random weights), with TF32 off, this measures:

* the whole guided and unguided calls (host clock around a synchronised
  call), best of 3;
* per-stage host times of one denoise step: the UNet forward, one guidance
  step (decode forward + losses + backward + Adam), and the encode and the
  final decode + reward of a call, each averaged over repeats;
* one guided call under `torch.profiler`: the device time summed over all
  kernels, its share of the wall time (the rest is the device idling while
  the host issues work), the number of kernel launches, and the kernels
  that take the most device time.

Prints a summary and writes chiprun_out/profile_guided.json. Needs a CUDA
card; fails without one.
"""

from __future__ import annotations

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

B, RASTER, A = 128, 224, 4


def _host_s(fn, repeats: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / repeats


def main() -> int:
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
    models = pipeline.build_models(seed=0, device=dev)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    gen = torch.Generator(device=dev)
    call = lambda guided, seed: pipeline.guided_collect(
        models, batch, guided=guided, agents_per_scene=A, generator=gen.manual_seed(seed))
    call(True, 0)  # warm-up: kernel build, cuDNN plans, allocator
    call(False, 0)
    rep = {"card": card, "torch": torch.__version__}
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

    # one guided call under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call(True, 3)
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
    rep["profiled_guided_call"] = {
        "wall_s": wall,
        "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:120], "count": c, "device_ms": us * 1e-3}
                        for n, (c, us) in top],
    }

    out = Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_guided.json").write_text(json.dumps(rep, indent=1))
    print(json.dumps({k: v for k, v in rep.items() if k != "profiled_guided_call"}, indent=1))
    p = rep["profiled_guided_call"]
    print(f"profiled guided call: wall {p['wall_s']:.3f} s, device busy {p['device_busy_s']:.3f} s "
          f"({100 * p['device_busy_share']:.1f}%), {p['kernel_launches']} kernel launches")
    for k in p["top_kernels"]:
        print(f"  {k['device_ms']:9.2f} ms  {k['count']:6d}x  {k['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
