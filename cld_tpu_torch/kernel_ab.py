"""Device time of the drivable gather, the off-road count and the card's
launch floor, for comparing two versions of the port's kernels on one card.

    python cld_tpu_torch/kernel_ab.py [--root DIR] [--label NAME]

Imports `cld_tpu_torch` from DIR (default: the checkout that holds this
file), so that one command can time an older checkout's kernels beside this
one's, in turns: old, new, new, old. Run it as a file, not with `-m`, which
would import this checkout's package first.

At the paths' shapes, from replays of a CUDA graph of 100 launches, the
median of 7 windows of 100 replays each, after 0.2 s that bring the card's
clocks up (back to back from Python a launch reads ~25 us); each time is the
median over 8 placements (clones of the inputs, each with its own graph),
since where the buffers lie moves these kernels by up to ~0.3 us, and the
range over the placements is kept beside it:
- `drivable_gather`: 32 int8 maps of 224 x 224, 5,200 queries each, with
  uniformly random queries (`chip_smoke.py:gather_pix`, as `chip_smoke.py`
  holds the kernel) and with the `"px"` replan's own queries: the bbox
  points that `MapCollisionLoss` hands the gather in one guidance step on
  the decoded trajectories of `chip_smoke.py:offroad_observation`, with its
  int8 map; beside one `torch.take` on a precomputed flat index for both;
- `offroad_count`: the reward's B = 128, G = 1, P = 52 on the 224 x 224
  maps of `synthetic_batch(seed=0)`, random pixels; also P = 128 and 129,
  one point either side of a single pass (4 points a lane of a warp; the
  first design's 128 threads), so that the difference is the cost of one
  more dependent pass (load, then gather);
- the launch floor: `torch.cuda._sleep(0)`, one thread that exits at once,
  timed the same way (a yardstick of one graph kernel node; no path calls it).
Each kernel is first held against its plain version (exactly); its output is
hashed (sha256) so that two versions can be compared bit for bit, and the
`"px"` queries are hashed too (equal query hashes: the two versions gathered
the same points). Prints one JSON line with the card and appends it to
chiprun_out/kernel_ab.jsonl. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def sha256(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def smoke_module():
    """`chip_smoke.py` of the checkout that holds this file, loaded as a
    module (its imports of `cld_tpu_torch` resolve to the package under
    test, which is first on the path)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def px_replan_queries(cs, dev):
    """(pix [32, 5200, 2] int32, map [32, 224, 224] int8): what the `"px"`
    replan's `MapCollisionLoss` hands `drivable_gather` in one guidance step,
    on the decoded trajectories of `offroad_observation` at
    `chip_smoke.py:run_px_replan`'s seed, with random weights from seed 0."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import guidance_gradient
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    models = pipeline.build_models(seed=0, device=dev)
    pack = synthetic_scene_pack(seed=0, num_scenes=cs.CL_SCENES, agents_per_scene=cs.CL_AGENTS,
                                world_map_size=cs.WORLD_MAP, sim_steps=cs.CL_STEPS, device=dev)
    g = torch.Generator().manual_seed(9)
    obs = cs.offroad_observation(pack, g)
    aux = models.context(obs)
    ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
        obs.drivable_map, obs.raster_from_agent, obs.extent, obs.curr_speed,
        obs.world_from_agent, obs.scene_index)))

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None]

    z = torch.randn((cs.CL_B, cs.T, cs.L), generator=g).to(dev)
    seen, gather = [], gl.drivable_gather

    def record(pix, drivable):
        seen.append((pix.clone(), drivable.clone()))
        return gather(pix, drivable)

    gl.drivable_gather = record
    try:
        guidance_gradient(z, ctx, pipeline.flagship_guidance_specs(cs.CL_AGENTS, "px"), decode_fn)
    finally:
        gl.drivable_gather = gather
    if len(seen) != 1:
        raise RuntimeError(f"one guidance step gathered {len(seen)} times, expected 1")
    return seen[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=str, default=str(HERE.parent))
    parser.add_argument("--label", type=str, default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)  # this file's directory is not a package root
    sys.path.insert(0, str(root))
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops import reward_kernels as rk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cs = smoke_module()
    dev = torch.device("cuda", 0)
    res = {"label": args.label or root.name, "root": str(root), "card": cs.card_line()}

    def time_placed(key, fn, *inputs):
        """fn(*inputs) on 8 clones of the inputs, each with its own graph
        (and so its own output buffers): the graph times of these
        microsecond kernels depend on where their buffers lie by up to
        ~0.3 us, so the median over placements is kept, with the range."""
        times, keep = [], []
        for _ in range(8):
            args = [t.clone() for t in inputs]
            keep.append(args)  # alive, so that the next clone lies elsewhere
            times.append(cs.graph_ms(lambda: fn(*args), replays=100, windows=7))
        res[f"{key}_ms"] = statistics.median(times)
        res[f"{key}_ms_range"] = [min(times), max(times)]

    B, Q, R = cs.CL_B, cs.Q, cs.RASTER
    g = torch.Generator().manual_seed(6)
    drv = (torch.rand((B, R, R), generator=g) < 0.6).to(torch.int8).to(dev)
    fixtures = {"random": (cs.gather_pix(g, B, Q, R, R, dev), drv),
                "px": px_replan_queries(cs, dev)}
    torch.cuda._sleep(400_000_000)  # ~0.2 s of one busy thread: the clocks leave idle
    for name, (pix, m) in fixtures.items():
        Bn, Qn = pix.shape[:2]
        Hm, W = m.shape[1:]
        got = gk.drivable_gather(pix, m)
        if not torch.equal(got, gk.drivable_gather_ref(pix, m)):
            raise RuntimeError(f"drivable_gather ({name}) disagrees with its plain version")
        flat = ((torch.arange(Bn, device=dev)[:, None] * Hm + pix[..., 1].long().clamp(0, Hm - 1))
                * W + pix[..., 0].long().clamp(0, W - 1))
        res[f"drivable_gather_{name}_shape"] = [Bn, Qn, Hm, W]
        time_placed(f"drivable_gather_{name}", gk.drivable_gather, pix, m)
        time_placed(f"torch_take_{name}", torch.take, m, flat)
        res[f"drivable_gather_{name}_sha256"] = sha256(got)
        res[f"drivable_gather_{name}_pix_sha256"] = sha256(pix, m)

    batch = synthetic_batch(seed=0, batch_size=cs.B, raster_size=R, device=dev)
    m = batch.drivable_map.contiguous()
    g = torch.Generator().manual_seed(16)
    for P in (cs.T, 128, 129):
        pix = torch.stack([torch.randint(0, R, (cs.B, P), generator=g),
                           torch.randint(0, R, (cs.B, P), generator=g)], -1)
        pix = pix.to(torch.int32).to(dev).contiguous()
        got = rk.offroad_count(pix, m)
        if not torch.equal(got, rk.offroad_count_ref(pix, m)):
            raise RuntimeError(f"offroad_count (P={P}) disagrees with its plain version")
        tag = "" if P == cs.T else f"_p{P}"
        time_placed(f"offroad_count{tag}", rk.offroad_count, pix, m)
        res[f"offroad_count{tag}_sha256"] = sha256(got)
    time_placed("launch_floor", lambda: torch.cuda._sleep(0))  # 8 graphs, no input

    line = json.dumps(res)
    print(line, flush=True)
    out = HERE.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
