"""Device time of the disk-collision kernel and of the card's launch floor,
for comparing two versions of the port's kernels on one card.

    python cld_tpu_torch/kernel_ab.py [--root DIR] [--label NAME]

Imports `cld_tpu_torch` from DIR (default: the checkout that holds this
file), so that one command can time an older checkout's kernels beside this
one's, in turns: old, new, new, old. Run it as a file, not with `-m`, which
would import this checkout's package first.

At the timed shape (T = 52 steps, B = 128 agents, D = 5 disks, the inputs of
`chip_smoke.py:disk_fixture`: scenes of 4 agents on top of each other), under
two masks: the same-scene one (each agent's 3 scene-mates, what the PPO
disk penalty passes) and every off-diagonal pair. From replays of a CUDA
graph of 100 launches, the median of 7 windows of 100 replays each, after
0.2 s that bring the card's clocks up (back to back from Python a launch
reads ~25 us); each time is the median over 8 placements (clones of the
inputs, each with its own graph), since where the buffers lie moves a
microsecond kernel by up to ~0.4 us, and the range over the placements is
kept beside it. Also the runtime-D loop (`unrolled=False`) at both masks,
and the launch floor: `torch.cuda._sleep(0)`, one thread that exits at once,
timed the same way (a yardstick of one graph kernel node; no path calls it).

Each output is first held against the plain version (rtol 1e-5, atol 1e-6)
and hashed (sha256), so that two versions can be compared bit for bit.
Prints one JSON line with the card and appends it to
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
    from cld_tpu_torch.ops import reward_kernels as rk

    cs = smoke_module()
    dev = torch.device("cuda", 0)
    res = {"label": args.label or root.name, "root": str(root), "card": cs.card_line()}

    def time_placed(key, fn, *inputs):
        """fn(*inputs) on clones of the inputs, each with its own graph (and
        so its own output buffers): the median over placements is kept, with
        the range."""
        times, keep = [], []
        for _ in range(8):
            cl = [t.clone() for t in inputs]
            keep.append(cl)  # alive, so that the next clone lies elsewhere
            times.append(cs.graph_ms(lambda: fn(*cl), replays=100, windows=7))
        res[f"{key}_ms"] = statistics.median(times)
        res[f"{key}_ms_range"] = [min(times), max(times)]

    def held(name, fn, args_):
        got = fn(*args_)
        want = rk.disk_collision_penalty_ref(*args_)
        torch.cuda.synchronize()
        if not bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all()):
            raise RuntimeError(f"disk_collision ({name}) disagrees with its plain version")
        if not torch.equal(got, fn(*args_)):
            raise RuntimeError(f"disk_collision ({name}) differs between two launches")
        return got

    T, B = cs.T, cs.B
    g = torch.Generator().manual_seed(16)
    off_diag = ~torch.eye(B, dtype=torch.bool, device=dev)
    fixtures = {"scene": cs.disk_fixture(g, T, B, 5, cs.scene_pair_mask(B, 4, dev), dev),
                "all_pairs": cs.disk_fixture(g, T, B, 5, off_diag, dev)}
    torch.cuda._sleep(400_000_000)  # ~0.2 s of one busy thread: the clocks leave idle
    for name, fx in fixtures.items():
        res[f"disk_collision_{name}_pairs"] = int(fx[2].sum())
        res[f"disk_collision_{name}_sha256"] = sha256(held(name, rk.disk_collision_penalty, fx))
        time_placed(f"disk_collision_{name}", rk.disk_collision_penalty, *fx)
        loop = lambda *a: rk.disk_collision_penalty(*a, unrolled=False)
        res[f"disk_collision_{name}_loop_sha256"] = sha256(held(f"{name}, loop", loop, fx))
        time_placed(f"disk_collision_{name}_loop", loop, *fx)
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
