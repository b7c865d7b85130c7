"""Device time and output hashes of the port's kernels, for comparing two
versions of them on one card: the LSTM decoder sweeps at H = 64, 128 and
320 in f32 and bf16, the bulk-copy probe beside `2 * x`, the rigid
map-distance kernels, and the card's launch floor.

    python cld_tpu_torch/kernel_ab.py [--root DIR] [--label NAME] [--only wide_bwd|wide_fwd]

Imports `cld_tpu_torch` from DIR (default: the checkout that holds this
file), so that one command can time an older checkout's kernels beside this
one's, in turns: old, new, new, old. Run it as a file, not with `-m`, which
would import this checkout's package first.

At the decoder's shape (T = 52, the inputs of `chip_smoke.py:lstm_inputs`
from one seed) and B = 32, 128 and 512 (the closed loop, the open loop,
four open-loop calls' worth): the forward `lstm2_fwd` and the reverse sweep
`lstm2_bwd` (its gates kernel and chain, one launch for the caller), in
bf16 (on the reverse sweep's inputs from the plain bf16 forward) and in
f32, at H = 64 (`lstm.cu`, `lstm_bf16.cu`) and at H = 128 and 320
(`lstm_wide.cu`). Each call includes its weight pack. Then the bulk-copy
probe at [52, 128, 128] bf16 (its batch-slice case) beside `2 * x`, and
`rigid_min`, `rigid_min_fused` and `rigid_bwd` at the guided path's B =
128, Q = 52, P = 100 on a lattice cache. Each time comes from replays of
a CUDA graph of 20 calls, the median of 5 windows of 10 replays (kernels
above 1 ms: 5 calls, 3 windows of 4), after 0.2 s that bring the card's
clocks up, and is the median over 4 placements (clones of the inputs, each
with its own graph), with the range over the placements beside it. Also
the launch floor: `torch.cuda._sleep(0)`, one thread that exits at once,
timed the same way (a yardstick of one graph kernel node; no path calls
it).

Each forward output is first held against its plain version (bf16 within
2^-7 of max |plain|, `chip_smoke.py:BF16_REL_TOL`; f32 within 1e-5,
`LSTM_REL_TOL`, at H = 128 and 320) and against a second launch
(bit-equal), so are the H = 64 bf16 reverse sweep and the wide reverse
sweeps; the probe must equal 2 x and the rigid forward kernels the plain
version, bit for bit. Every output is hashed (sha256), so that two versions
can be compared bit for bit: a kernel that did not change keeps its hashes.

The wide reverse sweeps also get their split: each kernel's device ms per
call from `torch.profiler` over replays of a CUDA graph
(`chip_smoke.py:graph_kernel_ms`), summed into the gates kernel(s), the
chain and the rest (the weight packs). Where the checkout's `_bwd_launch`
takes `rows`, the chain is also split at H = 128, B = 64 with 8 and with 16
rows a cluster forced (one wave at either: a step's cost at 16 rows
relative to 8, `lstm_kernels.CHAIN_ROW_COST`). `--only wide_bwd` runs the
wide reverse sweeps, their splits and the launch floor alone.

`--only wide_fwd` times the bf16 wide forward alone (H = 128 and 320, B =
32, 128 and 512, each held and hashed), with its split into the kernel and
the weight pack (`fwd_split`, from `graph_kernel_ms`), and where the
checkout's `_fwd_launch` takes `rows`, the kernel with 8 and 16 rows a
cluster forced at one (H, B) per instantiation (`ROWS_AT`: one wave at
either, a step's cost at 16 rows relative to 8,
`lstm_kernels.WIDE_BF16_ROW_COST`); and it hashes, without
timing them, every other LSTM kernel's outputs at those shapes (the f32
wide forward, both wide reverse sweeps, and the H = 64 kernels in f32 and
bf16), so that a run beside another checkout shows them unchanged.

Prints one JSON line with the card and appends it to
chiprun_out/kernel_ab.jsonl. Fails without a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BATCHES = (32, 128, 512)
WIDE_H = (128, 320)
RIGID_P = 100
# (H, B) at which the bf16 wide forward runs one wave at 8 rows a cluster and at
# 16, one H for each of its instantiations' k-tiles (8, 12, 16, 20): the H100
# holds 15 clusters of 8 CTAs at H = 128 and 192, 14 of 16 at 256, 7 of 16 at 320
ROWS_AT = ((128, 64), (192, 64), (256, 56), (320, 56))


def sha256(*tensors) -> str:
    """Hash of the tensors' bytes (any dtype, bf16 included)."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
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
    parser.add_argument("--only", choices=("all", "wide_bwd", "wide_fwd"), default="all")
    args = parser.parse_args(argv)
    every = args.only == "all"
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)  # this file's directory is not a package root
    sys.path.insert(0, str(root))
    from cld_tpu_torch.ops import lstm_kernels as lk

    cs = smoke_module()
    dev = torch.device("cuda", 0)
    res = {"label": args.label or root.name, "root": str(root), "card": cs.card_line()}

    def time_placed(key, fn, *inputs):
        """fn(*inputs) on clones of the inputs, each with its own graph (and
        so its own output buffers): the median over placements is kept, with
        the range. A kernel above 1 ms gets a shorter graph and fewer
        replays."""
        times, keep = [], []
        heavy = cs.cuda_ms(lambda: fn(*inputs), 2, warmup=1) > 1.0
        shape = dict(launches=5, replays=4, windows=3) if heavy else dict(launches=20,
                                                                          replays=10, windows=5)
        for _ in range(4):
            cl = [t.clone() for t in inputs]
            keep.append(cl)  # alive, so that the next clone lies elsewhere
            times.append(cs.graph_ms(lambda: fn(*cl), **shape))
            torch.cuda.empty_cache()
        res[f"{key}_ms"] = statistics.median(times)
        res[f"{key}_ms_range"] = [min(times), max(times)]

    def held(name, got, again, want, tol=cs.BF16_REL_TOL):
        torch.cuda.synchronize()
        rel = max(cs.rel_err(a.float(), b.float())[1] for a, b in zip(got, want))
        if rel > tol:
            raise RuntimeError(f"{name}: {rel:.3e} of max |plain| from its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches differ")
        res[f"{name}_rel_err"] = rel

    torch.cuda._sleep(400_000_000)  # ~0.2 s of one busy thread: the clocks leave idle
    if args.only == "wide_fwd":
        wide_fwd_only(res, lk, cs, dev, time_placed, held)
        time_placed("launch_floor", lambda: torch.cuda._sleep(0))
        return report(res)
    for Bn in BATCHES if every else ():
        g = torch.Generator().manual_seed(17)
        a32, d32 = cs.lstm_inputs(g, Bn, cs.T, cs.H, dev)
        ref32 = lk.lstm2_core_ref(*a32)
        b32 = (d32, *a32, ref32[1], ref32[2], ref32[0], ref32[3])
        a16 = tuple(x.to(torch.bfloat16) for x in a32)
        ref16 = lk.lstm2_core_ref(*a16)
        b16 = (d32.to(torch.bfloat16), *a16, ref16[1], ref16[2], ref16[0], ref16[3])

        fwd = lk.lstm2_fwd(*a16)
        held(f"lstm2_fwd_bf16_B{Bn}", fwd, lk.lstm2_fwd(*a16), ref16)
        res[f"lstm2_fwd_bf16_B{Bn}_sha256"] = sha256(*fwd)
        bwd = lk.lstm2_bwd(*b16)
        held(f"lstm2_bwd_bf16_B{Bn}", bwd, lk.lstm2_bwd(*b16), lk.lstm2_bwd_ref(*b16))
        res[f"lstm2_bwd_bf16_B{Bn}_sha256"] = sha256(*bwd)
        res[f"lstm2_fwd_B{Bn}_sha256"] = sha256(*lk.lstm2_fwd(*a32))
        res[f"lstm2_bwd_B{Bn}_sha256"] = sha256(*lk.lstm2_bwd(*b32))

        time_placed(f"lstm2_fwd_bf16_B{Bn}", lk.lstm2_fwd, *a16)
        time_placed(f"lstm2_bwd_bf16_B{Bn}", lk.lstm2_bwd, *b16)
        time_placed(f"lstm2_fwd_B{Bn}", lk.lstm2_fwd, *a32)
        time_placed(f"lstm2_bwd_B{Bn}", lk.lstm2_bwd, *b32)
    for Hn in WIDE_H:  # the wide sweeps (csrc/lstm_wide.cu)
        for Bn in BATCHES:
            g = torch.Generator().manual_seed(19)
            a32, d32 = cs.lstm_inputs(g, Bn, cs.T, Hn, dev)
            a16 = tuple(x.to(torch.bfloat16) for x in a32)
            for sfx, a, d, tol in (("", a32, d32, cs.LSTM_REL_TOL),
                                   ("_bf16", a16, d32.to(torch.bfloat16), cs.BF16_REL_TOL)):
                key = f"H{Hn}_B{Bn}{sfx}"
                ref = lk.lstm2_core_ref(*a)
                if every:
                    fwd = lk.lstm2_fwd(*a)
                    held(f"lstm2_fwd_{key}", fwd, lk.lstm2_fwd(*a), ref, tol)
                    res[f"lstm2_fwd_{key}_sha256"] = sha256(*fwd)
                    time_placed(f"lstm2_fwd_{key}", lk.lstm2_fwd, *a)
                b = (d, *a, ref[1], ref[2], ref[0], ref[3])
                bwd = lk.lstm2_bwd(*b)
                held(f"lstm2_bwd_{key}", bwd, lk.lstm2_bwd(*b), lk.lstm2_bwd_ref(*b), tol)
                res[f"lstm2_bwd_{key}_sha256"] = sha256(*bwd)
                time_placed(f"lstm2_bwd_{key}", lk.lstm2_bwd, *b)
                res[f"lstm2_bwd_{key}_split"] = cs.sweep_split(
                    cs.graph_kernel_ms(lambda: lk.lstm2_bwd(*b)))
            del a32, a16, ref, b
            torch.cuda.empty_cache()
    if "rows" in inspect.signature(lk._bwd_launch).parameters:
        for dt in (torch.float32, torch.bfloat16):  # the chain at each R, one wave at either
            g = torch.Generator().manual_seed(19)
            a, d = cs.lstm_inputs(g, 64, cs.T, 128, dev)
            a, d = tuple(x.to(dt) for x in a), d.to(dt)
            ref = lk.lstm2_core_ref(*a)
            b = dict(zip(("dy", "xg1", "h0", "Wh1", "W2", "b2", "h1s", "c1s", "ys", "c2s"),
                         (d, *a, ref[1], ref[2], ref[0], ref[3])))
            sfx = "" if dt == torch.float32 else "_bf16"
            res[f"chain_rows_H128_B64{sfx}"] = {
                str(R): cs.sweep_split(cs.graph_kernel_ms(
                    lambda: lk._bwd_launch(64, cs.T, 128, dt, rows=R, **b)))["chain"]
                for R in lk.WIDE_ROWS}

    if not every:
        time_placed("launch_floor", lambda: torch.cuda._sleep(0))
        return report(res)

    from cld_tpu_torch import dma_probe as dp

    x = dp.probe_input(128, True, dev)
    # an older checkout's probe takes the TPU probe's batch slice as well
    takes_bb = "bb" in inspect.signature(dp.bulk_double).parameters
    double = (lambda t: dp.bulk_double(t, dp.BB)) if takes_bb else dp.bulk_double
    out = double(x)
    if not torch.equal(out, 2 * x):
        raise RuntimeError("dma_probe: not 2 x bit for bit")
    res["dma_probe_sha256"] = sha256(out)
    time_placed("dma_probe", double, x)
    time_placed("two_x", lambda t: 2 * t, x)

    from cld_tpu_torch.ops import rigid_kernels as rk

    g = torch.Generator().manual_seed(7)
    d2 = cs.lattice_d2(g, cs.B, RIGID_P, dev)
    on = (torch.rand((cs.B, cs.T, RIGID_P), generator=g) < 0.6).to(dev)
    want = rk.rigid_min_ref(d2, on)
    pts = (torch.randn((cs.B, cs.T, RIGID_P, 2), generator=g) * 5.0).to(dev)
    gout = torch.randn((cs.B, cs.T, RIGID_P), generator=g).to(dev)
    for name in ("rigid_min", "rigid_min_fused"):
        got = getattr(rk, name)(d2, on)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, want)):
            raise RuntimeError(f"{name}: differs from its plain version")
        res[f"{name}_sha256"] = sha256(*got)
        time_placed(name, getattr(rk, name), d2, on)
    res["rigid_bwd_sha256"] = sha256(rk.rigid_bwd(pts, want[1], want[0], gout))
    time_placed("rigid_bwd", rk.rigid_bwd, pts, want[1], want[0], gout)
    time_placed("launch_floor", lambda: torch.cuda._sleep(0))  # 4 graphs, no input
    return report(res)


def fwd_split(by_kernel: dict) -> dict:
    """A forward's device ms by part, from `graph_kernel_ms`: the sweep's
    kernel and the rest (the weight pack's gather)."""
    out = {"kernel": 0.0, "other": 0.0}
    for name, ms in by_kernel.items():
        out["kernel" if "lstm2_" in name else "other"] += ms
    return out if by_kernel else {}


def wide_fwd_only(res, lk, cs, dev, time_placed, held):
    """`--only wide_fwd`: the bf16 wide forward timed, held, hashed and
    split at each (H, B); every other LSTM kernel's outputs hashed."""
    import torch

    for Hn in WIDE_H:
        for Bn in BATCHES:
            g = torch.Generator().manual_seed(19)
            a32, d32 = cs.lstm_inputs(g, Bn, cs.T, Hn, dev)
            a16 = tuple(x.to(torch.bfloat16) for x in a32)
            key = f"H{Hn}_B{Bn}_bf16"
            ref = lk.lstm2_core_ref(*a16)
            fwd = lk.lstm2_fwd(*a16)
            held(f"lstm2_fwd_{key}", fwd, lk.lstm2_fwd(*a16), ref)
            res[f"lstm2_fwd_{key}_sha256"] = sha256(*fwd)
            time_placed(f"lstm2_fwd_{key}", lk.lstm2_fwd, *a16)
            res[f"lstm2_fwd_{key}_split"] = fwd_split(
                cs.graph_kernel_ms(lambda: lk.lstm2_fwd(*a16)))
            # the other wide kernels at this shape: hashed only
            b16 = (d32.to(torch.bfloat16), *a16, ref[1], ref[2], ref[0], ref[3])
            res[f"lstm2_bwd_{key}_sha256"] = sha256(*lk.lstm2_bwd(*b16))
            ref32 = lk.lstm2_core_ref(*a32)
            res[f"lstm2_fwd_H{Hn}_B{Bn}_sha256"] = sha256(*lk.lstm2_fwd(*a32))
            b32 = (d32, *a32, ref32[1], ref32[2], ref32[0], ref32[3])
            res[f"lstm2_bwd_H{Hn}_B{Bn}_sha256"] = sha256(*lk.lstm2_bwd(*b32))
            del a32, a16, ref, ref32, b16, b32, fwd
            torch.cuda.empty_cache()
    for Bn in BATCHES:  # the H <= 64 kernels (csrc/lstm.cu, csrc/lstm_bf16.cu): hashed only
        g = torch.Generator().manual_seed(17)
        a32, d32 = cs.lstm_inputs(g, Bn, cs.T, cs.H, dev)
        for sfx, a, d in (("", a32, d32), ("_bf16", tuple(x.to(torch.bfloat16) for x in a32),
                                           d32.to(torch.bfloat16))):
            ref = lk.lstm2_core_ref(*a)
            res[f"lstm2_fwd{sfx}_B{Bn}_sha256"] = sha256(*lk.lstm2_fwd(*a))
            b = (d, *a, ref[1], ref[2], ref[0], ref[3])
            res[f"lstm2_bwd{sfx}_B{Bn}_sha256"] = sha256(*lk.lstm2_bwd(*b))
    if "rows" in inspect.signature(lk._fwd_launch).parameters:
        for Hn, Bn in ROWS_AT:  # the bf16 forward at each R, one wave at either
            g = torch.Generator().manual_seed(19)
            a, _ = cs.lstm_inputs(g, Bn, cs.T, Hn, dev)
            a = dict(zip(("xg1", "h0", "Wh1", "W2", "b2"), (x.to(torch.bfloat16) for x in a)))
            res[f"fwd_rows_H{Hn}_B{Bn}_bf16"] = {
                str(R): fwd_split(cs.graph_kernel_ms(
                    lambda: lk._fwd_launch(Bn, cs.T, Hn, torch.bfloat16, rows=R, **a)))["kernel"]
                for R in lk.WIDE_ROWS}


def report(res: dict) -> int:
    line = json.dumps(res)
    print(line, flush=True)
    out = HERE.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
