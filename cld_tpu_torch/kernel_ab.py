"""Device time of the bf16 LSTM decoder kernels, beside the f32 ones and the
card's launch floor, for comparing two versions of the port's kernels on
one card.

    python cld_tpu_torch/kernel_ab.py [--root DIR] [--label NAME]

Imports `cld_tpu_torch` from DIR (default: the checkout that holds this
file), so that one command can time an older checkout's kernels beside this
one's, in turns: old, new, new, old. Run it as a file, not with `-m`, which
would import this checkout's package first.

At the decoder's shape (T = 52, H = 64, the inputs of
`chip_smoke.py:lstm_inputs` from one seed) and B = 32, 128 and 512 (the
closed loop, the open loop, four open-loop calls' worth): the forward
`lstm2_fwd` and the reverse sweep `lstm2_bwd` (its gates kernel and chain,
one launch for the caller), in bf16 (on the reverse sweep's inputs from
the plain bf16 forward) and in f32. Each call includes its weight pack.
From replays of a CUDA graph of 20 calls, the median of 5 windows of 10
replays each, after 0.2 s that bring the card's clocks up; each time is
the median over 4 placements (clones of the inputs, each with its own
graph), with the range over the placements beside it. Also the launch
floor: `torch.cuda._sleep(0)`, one thread that exits at once, timed the
same way (a yardstick of one graph kernel node; no path calls it).

Each bf16 output is first held against its plain version (within 2^-7 of
max |plain| for every output, `chip_smoke.py:BF16_REL_TOL`) and against a
second launch (bit-equal); every output, bf16 and f32, is hashed (sha256),
so that two versions can be compared bit for bit (the f32 kernels' hashes
must not move between versions). Prints one JSON line with the card and
appends it to chiprun_out/kernel_ab.jsonl. Fails without a CUDA card.
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
BATCHES = (32, 128, 512)


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
    args = parser.parse_args(argv)
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
        the range."""
        times, keep = [], []
        for _ in range(4):
            cl = [t.clone() for t in inputs]
            keep.append(cl)  # alive, so that the next clone lies elsewhere
            times.append(cs.graph_ms(lambda: fn(*cl), launches=20, replays=10, windows=5))
            torch.cuda.empty_cache()
        res[f"{key}_ms"] = statistics.median(times)
        res[f"{key}_ms_range"] = [min(times), max(times)]

    def held(name, got, again, want):
        torch.cuda.synchronize()
        rel = max(cs.rel_err(a.float(), b.float())[1] for a, b in zip(got, want))
        if rel > cs.BF16_REL_TOL:
            raise RuntimeError(f"{name}: {rel:.3e} of max |plain| from its plain version")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name}: two launches differ")
        res[f"{name}_rel_err"] = rel

    torch.cuda._sleep(400_000_000)  # ~0.2 s of one busy thread: the clocks leave idle
    for Bn in BATCHES:
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
    time_placed("launch_floor", lambda: torch.cuda._sleep(0))  # 4 graphs, no input

    line = json.dumps(res)
    print(line, flush=True)
    out = HERE.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "kernel_ab.jsonl", "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
