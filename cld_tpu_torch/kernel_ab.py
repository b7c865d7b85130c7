"""Device time of the map-warp gather and the rigid map-distance kernels,
for comparing two versions of the port's kernels on one card.

    python cld_tpu_torch/kernel_ab.py [--root DIR] [--label NAME]

Imports `cld_tpu_torch` from DIR (default: the checkout that holds this
file), so that one command can time an older checkout's kernels beside this
one's, in turns: old, new, new, old. Run it as a file, not with `-m`, which
would import this checkout's package first.

At the paths' shapes, from replays of a CUDA graph of 100 launches (back to
back from Python a launch reads ~25 us):
- `value_gather`: 64 windows of 256 x 256 x 3 int8, 25,088 queries each
  (the closed loop's banded warp at 4 x 8 agents), with uniformly random
  queries (as `chip_smoke.py` holds them) and with rotated raster bands (as
  the warp makes them), beside one `torch.take` on a precomputed flat index;
- `rigid_min` and `rigid_min_fused`: B = 128 and 32 agents (the open loop's
  batch and the first 32 of it, as the closed loop's), Q = 52 steps, P =
  100 points, on the lattice cache of `prepack_map_bbox` (`ctx.bbox_d2`:
  the 10 x 10 bbox grid scaled by each agent's extent, full of tied
  distances) of `synthetic_batch(seed=0)`, and the open loop's mask mix of
  `chip_smoke.py:check_rigid`: the batch's own drivable bits under random
  pixels, 10% of them replaced by random bits, an all-off-road and an
  all-on-road step forced in;
- `rigid_bwd`: B = 128 and 32 agents, Q = 52 steps, P = 100 points, the
  rows from `rigid_min_ref` over random point clouds and on-road masks.
Each kernel is first held against its plain version (exact for the gather
and the rigid min, `dist` bit for bit and `idx` equal; rtol 1e-4 / atol 1e-5
for the backward); the rigid min's `dist` and `idx` and the backward's
gradient are also hashed, so that two versions can be compared bit for bit.
Prints one JSON line with the card and appends it to
chiprun_out/kernel_ab.jsonl. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def graph_ms(fn, launches: int = 100, replays: int = 20) -> float:
    import torch

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


def band_pix(g, M, BH, W, WIN):
    """Window-local queries of M rotated raster bands of BH x W pixels, each
    centred in its window, as the banded warp makes them."""
    import torch

    theta = torch.rand((M, 1, 1), generator=g) * 2 * math.pi
    r, c = torch.meshgrid(torch.arange(BH) - BH / 2 + 0.5, torch.arange(W) - W / 2 + 0.5,
                          indexing="ij")
    lx = torch.cos(theta) * c - torch.sin(theta) * r + WIN / 2
    ly = torch.sin(theta) * c + torch.cos(theta) * r + WIN / 2
    pix = torch.stack([lx, ly], -1).round().clamp(0, WIN - 1).to(torch.int32)
    return pix.reshape(M, BH * W, 2)


def rigid_min_inputs(dev, Bn: int, T: int, P: int):
    """(d2 [Bn, P, P], on [Bn, T, P] bool) as `chip_smoke.py:check_rigid`
    builds the open loop's: the lattice cache of the synthetic batch and its
    drivable bits under random pixels with 10% random bits mixed in."""
    import torch

    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import gather_kernels as gk

    batch = synthetic_batch(seed=0, batch_size=Bn, raster_size=224, device=dev)
    ctx = gl.prepack_map_bbox(gl.GuidanceContext(
        batch.drivable_map, batch.raster_from_agent, batch.extent, batch.curr_speed,
        torch.eye(3, device=dev).expand(Bn, 3, 3), torch.zeros((Bn,), dtype=torch.long,
                                                                device=dev)))
    g = torch.Generator().manual_seed(14)
    Hm, W = batch.drivable_map.shape[-2:]
    pix = torch.stack([torch.randint(0, W, (Bn, T * P), generator=g),
                       torch.randint(0, Hm, (Bn, T * P), generator=g)], -1)
    pix = pix.to(torch.int32).to(dev).contiguous()
    on_map = gk.drivable_bit_gather_ref(pix, gk.pack_drivable_bits(batch.drivable_map)) > 0
    flip = (torch.rand((Bn, T * P), generator=g) < 0.1).to(dev)
    rand = (torch.rand((Bn, T * P), generator=g) < 0.5).to(dev)
    on = torch.where(flip, rand, on_map).reshape(Bn, T, P).clone()
    on[0, 0] = False
    on[1, 1] = True
    return ctx.bbox_d2.contiguous(), on.contiguous()


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
    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops import rigid_kernels as rk

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator().manual_seed(0)
    res = {"label": args.label or root.name, "root": str(root), "card": card}

    M, BH, W, WIN, C = 64, 112, 224, 256, 3
    wins = torch.randint(-128, 128, (M, WIN, WIN, C), generator=g, dtype=torch.int8).to(dev)
    pixes = {"random": torch.stack([torch.randint(0, WIN, (M, BH * W), generator=g),
                                    torch.randint(0, WIN, (M, BH * W), generator=g)],
                                   -1).to(torch.int32),
             "bands": band_pix(g, M, BH, W, WIN)}
    for name, pix in pixes.items():
        pix = pix.to(dev).contiguous()
        if not torch.equal(gk.value_gather(pix, wins), gk.value_gather_ref(pix, wins)):
            raise RuntimeError(f"value_gather ({name}) disagrees with its plain version")
        flat = ((torch.arange(M, device=dev)[:, None] * WIN + pix[..., 1].long()) * WIN
                + pix[..., 0].long())[..., None] * C + torch.arange(C, device=dev)
        res[f"value_gather_{name}_ms"] = graph_ms(lambda: gk.value_gather(pix, wins))
        res[f"torch_take_{name}_ms"] = graph_ms(lambda: torch.take(wins, flat))

    T, P = 52, 100
    d2, on = rigid_min_inputs(dev, 128, T, P)
    for Bn in (128, 32):
        a = (d2[:Bn].contiguous(), on[:Bn].contiguous())
        want = rk.rigid_min_ref(*a)
        for kname in ("rigid_min", "rigid_min_fused"):
            got = getattr(rk, kname)(*a)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise RuntimeError(f"{kname} (B={Bn}) disagrees with its plain version")
            res[f"{kname}_b{Bn}_ms"] = graph_ms(lambda: getattr(rk, kname)(*a))
            res[f"{kname}_b{Bn}_sha256"] = hashlib.sha256(
                got[0].cpu().numpy().tobytes() + got[1].cpu().numpy().tobytes()).hexdigest()
    for Bn in (128, 32):
        local = torch.randn((Bn, P, 2), generator=g) * 2.0
        d2 = ((local[:, :, None] - local[:, None]) ** 2).sum(-1)
        on = torch.rand((Bn, T, P), generator=g) > 0.4
        dist, idx = rk.rigid_min_ref(d2, on)
        pts = torch.randn((Bn, T, P, 2), generator=g) * 5.0
        gout = torch.where(on, 0.0, torch.randn((Bn, T, P), generator=g))
        a = [t.to(dev).contiguous() for t in (pts, idx, dist, gout)]
        got, want = rk.rigid_bwd(*a), rk.rigid_bwd_ref(*a)
        if not bool(((got - want).abs() <= 1e-4 * want.abs() + 1e-5).all()):
            raise RuntimeError(f"rigid_bwd (B={Bn}) disagrees with its plain version")
        res[f"rigid_bwd_b{Bn}_ms"] = graph_ms(lambda: rk.rigid_bwd(*a))
        res[f"rigid_bwd_b{Bn}_sha256"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()

    line = json.dumps(res)
    print(line, flush=True)
    out = HERE.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
