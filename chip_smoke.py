#!/usr/bin/env python
"""Chip smoke test of the PyTorch + CUDA port (`cld_tpu_torch`) on one GPU.

    python chip_smoke.py

1. Fails unless CUDA is available; prints the card's name and power limit.
2. Builds the port's CUDA kernels from `cld_tpu_torch/csrc/` (nvcc, sm_90a).
3. Holds each kernel against its plain PyTorch version on the card, at the
   shapes of the guided pipeline (B=128 agents, T=52, H=64; 5200 map
   queries per agent on a 224x224 map), with TF32 off: the LSTM forward
   outputs, the LSTM reverse sweep's gate cotangents, the VJP of
   `Lstm2Core` in all five arguments against autograd through the plain
   forward, and the bit gather (exactly). The two LSTM kernels are also held
   at B/T/H 32/52/64 (the closed loop), 512/52/64 (two rows per CTA),
   130/52/64 (a ragged last CTA) and 5/7/16 (small H), two launches of each
   must agree bit for bit, and their registers and spills per thread are
   reported. Times each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (cuDNN's LSTM forward, and its
   backward beside the port's whole `Lstm2Core` VJP; one `torch.take` for
   the two map gathers of step 6); the LSTM kernels also from a CUDA graph
   at B = 32, 128 and 512. Computes each kernel's bound from its bytes and
   operations (a gather's bound counts, of its source, only the bytes under
   this run's queries).
4. Runs `pipeline.guided_collect` at the full width of the config of record
   (ResNet-18 over 224x224x34, cond 256, UNet dim 32 x (2, 4, 8), LSTM H=64,
   100 DDPM steps, agent + map collision guidance) with seeded random
   weights, guided then unguided: launch counts are zeroed just before the
   guided run and read just after; outputs must be finite; prints NFE/s.
5. Runs the slice at a small size (B=8, raster 64, 10 steps) on the card and
   on the CPU (plain versions) with the same weights and noise, and holds
   the results against each other.
6. Holds the two map-gather kernels of the closed loop against their plain
   versions, exactly, at the closed loop's shapes: `value_gather` (64
   windows of 256x256x3 int8, 25,088 queries each; also with Q % 4 != 0,
   C = 1, 4 and 5, one window, and pix 8 bytes off a 16-byte boundary, with
   its registers and spills, and its time from a CUDA graph beside one
   `torch.take`) and `drivable_gather` (32 maps of 224x224, 5,200 queries
   each; int8 and float32 maps; also at `DRIVABLE_GATHER_EDGES`, B 1/32/33
   and Q 1/3/4/5/5,199/5,200/5,201, with coordinates outside the map, and
   through a pix view 8 bytes off a 16-byte boundary, so on its 16-byte and
   its scalar path, two launches bit for bit; its registers and spills and
   its time from a CUDA graph beside one `torch.take`); and the banded
   `warp_scene_maps` against the exact one for the 32-agent pack.
7. Runs the guided closed loop `sim.env.simulate` at full width: 4 scenes x
   8 agents, raster 224x224x34, world maps 512x512x3, 100 frames, a replan
   every 5 frames, each replan one guided 100-step DDPM call. Launch counts
   are zeroed just before the episode and read just after, and must be
   exact (`value_gather` = replans, `lstm2_fwd` = 100 x replans,
   `lstm2_bwd` = `bit_gather` = 99 x replans); the trajectory log must be
   finite; prints `summarize_metrics`, agent-steps/s and the host time per
   replan split into render / policy / step.
8. Runs one replan with `MapCollisionLoss(gather_impl="px")`: its guidance
   gradient and its plan must equal the "bits" ones exactly, with 99
   `drivable_gather` launches and no `bit_gather` launch.
9. Runs a small closed loop (2 x 3 agents, raster 64, 10 DDPM steps, 10
   frames) on the card and on the CPU with the same weights and noise.
10. Holds the three rigid map-distance kernels against their plain versions
   on the card at the open loop's shape (B=128 agents, Q=52 steps, P=100 bbox
   points; the distance cache from `prepack_map_bbox` on the synthetic batch,
   the on-road mask from the batch's own map with random bits mixed in and
   an all-off-road and an all-on-road step forced) and at two ragged shapes:
   `rigid_min` and `rigid_min_fused` give `dist` and `idx` equal to the
   plain version's bit for bit, and so to each other, there and at 14 edge
   shapes on lattice caches (P = 1, 31, 32, 33, 65, 224; Q = 1, 3, 5, 7, 9,
   17, 53, 65; B = 1, 133); `rigid_bwd` agrees within rtol 1e-4 / atol 1e-5
   and repeats itself bit for bit, there and at P = 1, P = 33 and with every
   column routed to one row (P = 100 and 224). Times each, from a CUDA graph
   at B = 128 and 32 beside its bound at both, with the forward kernels'
   registers and spills and `rigid_bwd`'s at P = 1, 33, 100 and 224.
11. Runs `pipeline.guided_collect` at full width with
   `MapCollisionLoss(min_dist_impl="rigid_kernel")` (99 `rigid_min`, 99
   `rigid_bwd`, no `rigid_min_fused`) and with `min_dist_impl="rigid",
   min_fwd_impl="fused"` (99 `rigid_min_fused`, none of the other two);
   launch counts zeroed before each and exact; prints NFE/s. One guidance
   gradient at B=128 under "rigid_kernel", "rigid" + "fused" and
   "separable": the first two agree within rtol 1e-4, the loss values of
   all three within 1e-5 relative.
12. Runs one closed-loop replan (4 x 8 agents) and the small slice of 5 with
   "rigid_kernel" specs: exact launch counts, a finite plan, card vs CPU.
13. Holds the two reward kernels against their plain versions on the card:
   `offroad_count` exactly, at the reward's shape (B=128 maps of 224x224, 52
   points each), with 5 groups of points per map, at two odd small shapes
   and at every combination of `OFFROAD_EDGES` (P 1/31/32/33/52/64/65/
   127/128/129/200, G 1/3/5, B 1/128/129, coordinates outside the map), two
   launches bit for bit, with its registers and spills; `disk_collision`
   within rtol 1e-5 / atol 1e-6 at T=52, B=128, D=5 (scenes of 4,
   same-scene off-diagonal pairs, and every off-diagonal pair), at T/B/D
   8/6/4, 3/5/1 and 6/7/9 (more disks than the kernel unrolls, so its
   runtime-D loop), at B=1 (an agent paired with itself), B=33 (one past a
   warp of mask columns), with an empty mask (exactly 0) and at D=9 under
   the same-scene mask, and the runtime-D loop at D=5 too; two launches
   bit-identical. Times each from Python and from a CUDA graph (both
   masks), the runtime-D loop beside the unrolled one.
14. Trains at full width on a synthetic batch (B=128, raster 224x224x34, the
   config of record with `steps_per_epoch` 1 so that the warm-up rate leaves
   0 after the first step): 2 warm-up and 5 timed `VAETrainer.train_step`s
   and one `eval_step` (one `lstm2_fwd` launch), then the same of
   `DMTrainer.train_step` on the trained VAE; losses finite, parameters
   moved; prints steps/s.
15. Runs the PPO stage at full width: a buffer of 3,000, 3 `collect_step`s
   (exactly 3 `lstm2_fwd` and 3 `offroad_count` launches), one update phase
   at mini-batch 128 cut to 30 iterations, one `test_step` (one more
   `lstm2_fwd`); prints collect steps/s and update iterations/s. Then, as a
   path of its own (`ppo_disk_penalty`: the trainer's entry points never call
   this op), the `disk_collision` penalty of the last collection's
   trajectories (scenes of 4 agents parked 3 m apart, so that they overlap;
   held against its plain version and against `AgentCollisionLoss`'s flat
   path): exactly 1 launch.
16. Holds one VAE step's and one DM step's gradients and one `collect_step`'s
   trajectories and rewards on the card against the CPU at a small size (the
   `cld_smoke` widths, B=8), same weights and explicit noise.
17. Runs the guidance rule library through the rollout CLI
   (`rollout.main`) at the closed loop's width (4 scenes x 8 agents, raster
   224, 100 DDPM steps), cut to 20 frames (4 replans), with `--editing-source
   config,heuristic`: `RULE_CONFIGS` and `RULE_HEURISTICS` instantiate all 15
   rule classes. The CLI runs a warm-up episode and times a second one,
   whose launches it reports; the counts, zeroed before the call and read
   after it, are exact: per replan of each episode 100 `lstm2_fwd`, 99
   `lstm2_bwd`, 99 `bit_gather`, 1 `value_gather`, and 1 `bit_gather` for
   the satisfaction report's map rule; the trajectory
   log and the guidance-satisfaction report must be finite. Then one guided
   replan's guidance gradient under the same rules at 2 x 4 agents on the
   card and on the CPU: a finite loss within 1e-5 relative, the gradient
   within 1e-4 relative (plus 1e-5 of its largest entry).
18. Runs the checkpoint path at the full width of the config of record:
   trains the VAE and then the DM stage through `train.main`, 2 steps each
   (a JSON config sets one-step epochs, so that the rate leaves 0), writing
   `ckpt_final` files under chiprun_out/; rolls them out through
   `rollout.main` with `--registered-name cld_dm_nusc`, `--vae-ckpt`,
   `--dm-ckpt` and `--cle-report` (4 scenes x 8 agents, raster 224, 100
   DDPM steps, 20 frames: 4 replans; launch counts zeroed before and exact
   after, as the rules path's with the flagship rules); `summarize_metrics`,
   the occupancy metrics and the CLE summary must be finite, and the first
   replan's plan of the CLI's models must equal, bit for bit, the plan of
   models loaded straight from the trainers' state dicts with the same
   generator. Then the same weights as a Lightning-style `.ckpt`
   (`{"state_dict": {"vae.*", "dm.model.*"}}`) through the same CLI: the
   same first plan and the same trajectory log, bit for bit. Times the eval
   layer on the rollout's log (the occupancy report and the CLE summary,
   host seconds per call). Then `--mode test` on the checkpoints, 2 validation batches of 128: exactly 2
   `lstm2_fwd` launches, finite failure rates and realism deviation. Prints
   the phase's seconds and the rollout's agent-steps/s beside the card.
19. Runs the data path at full width: writes 2 x 32 synthetic samples at
   raster 224 with the port's converter into a temporary directory (deleted
   at the end); the loader's first batch of 128 on the card must equal the
   host's bit for bit; times the loader per batch of 128 (host gather, copy
   to the card) beside a VAE step on its batch; trains the VAE and then the
   DM stage 2 steps each through `train.main` from the shards (finite
   losses, no kernel launch); runs the rollout CLI on `--scene-data` (4
   scenes x 8 agents, 20 frames) with `--policy dm --agents-policy
   gt_replay`, the flagship rules, `--num-action-samples 2 --guide-with-gt`
   and `--cle-report`: launches exact as the rules path's, a finite log and
   report with `compile_and_first_run_s`; runs `occupancy_report` twice on
   its log on the card (grids within rtol 1e-5 / atol 1e-7, every cell clear
   of the 0.1 threshold, equal metrics); runs `--policy gt_replay`,
   `lattice`, `mpc` and `contingency` at the same width (no LSTM or bit
   gather launch, one `value_gather` a replan of each episode; seconds per
   replan); then
   card against CPU: the replay with every agent uncontrolled follows the
   pack's `gt_states` within 1e-5 m; one MPC and one contingency replan on
   `planner_observation`, each held where it is continuous
   (`check_planners_card_vs_cpu`: the MPC's controls after 20 iterations,
   and its final costs after the record's 100).
20. Times the launch floor: `torch.cuda._sleep(0)` (one thread that exits
   at once) from a CUDA graph, as every kernel's graph time is taken.
21. Prints the card line, one `{"kernels": [...]}` line (`launches_by_path`
   there holds each main-path run's own count, of 4, 7, 8, 11, 12, 14, 15,
   17, 18 (its rollout and its `--mode test`) and 19 (its training, its
   guided rollout and each model-free policy),
   each zeroed before its run and checked exactly; `launches` is their sum;
   `graph_ms` is each kernel's time from a CUDA graph at the main path's
   shape, B=128 for the LSTM kernels, beside `launch_floor_ms`), and last
   `{"ok": true, "device": {...}}`. Any failed check exits non-zero first.

A longer report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate and the f32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

B, T, H, L, COND = 128, 52, 64, 4, 256
AGENTS_PER_SCENE = 4
N_STEPS = 100
RASTER = 224
Q = T * 100  # map-loss query points per agent: horizon x 10x10 bbox grid

# closed loop of record (`bench.py`: CL_SCENES, CL_AGENTS, CL_STEPS; replan / 5)
CL_SCENES, CL_AGENTS, CL_STEPS, CL_N_STEP = 4, 8, 100, 5
CL_B = CL_SCENES * CL_AGENTS
WORLD_MAP = 512

LSTM_REL_TOL = 1e-5  # max |kernel - plain| / max |plain|: f32, other summation order
# B/T/H at which both LSTM kernels are held: the open and closed loops, two rows
# per CTA, a ragged last CTA, a small H
LSTM_SHAPES = ((B, T, H), (CL_B, T, H), (512, T, H), (130, T, H), (5, 7, 16))
SLICE_RTOL = 1e-4  # small-slice card vs CPU: f32 networks on two backends
# the MPC's final FTOCP cost per agent after 100 Adam iterations, card vs CPU:
# 2.4x the largest float32-vs-float64 spread on the CPU (4.2e-2)
MPC_COST_RTOL = 0.1


class CheckFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def counts(**launched) -> dict:
    """Expected launch counts: the named kernels, every other kernel 0."""
    from cld_tpu_torch.ops import native

    return {**{k: 0 for k in native.KERNELS}, **launched}


def cli_launches(episode: dict, **extra) -> dict:
    """The process-wide launch counts of one `rollout.main` call: its
    warm-up and its timed episode (`episode` each, the count the CLI reports
    for the timed one), plus `extra` (the reports' launches)."""
    return {k: 2 * v + extra.get(k, 0) for k, v in episode.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int = 100, replays: int = 20, windows: int = 1) -> float:
    """Device ms per call of fn, from replays of a CUDA graph of `launches`
    calls (the median over `windows` timed runs of `replays` replays each):
    back-to-back launches from Python read the host's launch path
    (~0.02-0.03 ms) for any kernel shorter than that, the graph takes it out."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (launches * replays))
    return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_bound(pix, rows: int, row_elems: int, elem_bytes: int, out_bytes: int,
                 col_shift: int = 0):
    """Bound of a gather over pix [M, Q, 2] (col, row) into M sources of
    [rows, row_elems] elements: the queries read once, each output written
    once, and of the sources only the distinct elements that this run's
    queries land on (a gather needs no other byte of its source). Returns
    (bound_ms, bound_by, source bytes needed)."""
    import torch

    M, Qn = pix.shape[:2]
    col = pix[..., 0].long().clamp(0, (row_elems << col_shift) - 1) >> col_shift
    row = pix[..., 1].long().clamp(0, rows - 1)
    src = torch.arange(M, device=pix.device)[:, None]
    needed = int(torch.unique((src * rows + row) * row_elems + col).numel()) * elem_bytes
    return (*bound(8 * M * Qn + needed + out_bytes * M * Qn, 0.0), needed)


def rel_err(got, want) -> tuple:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / max(scale, 1e-30)


def gather_pix(g, M, Qn, W, Hm, dev):
    """Random in-range (col, row) queries with the four corners forced in."""
    import torch

    pix = torch.stack([torch.randint(0, W, (M, Qn), generator=g),
                       torch.randint(0, Hm, (M, Qn), generator=g)], dim=-1)
    pix[:, :4] = torch.tensor([[0, 0], [W - 1, 0], [0, Hm - 1], [W - 1, Hm - 1]])
    return pix.to(torch.int32).to(dev).contiguous()


def lstm_inputs(g, Bn, Tn, Hn, dev):
    """Random core inputs at one shape, the weights at the init scale
    1/sqrt(H): ((xg1, h0, Wh1, W2, b2), dy)."""
    import torch

    k = Hn ** -0.5
    u = lambda *shape: (torch.rand(shape, generator=g) * 2 - 1) * k
    xs = (torch.randn((Bn, Tn, 4 * Hn), generator=g), torch.randn((Bn, Hn), generator=g) * 0.5,
          u(Hn, 4 * Hn), u(2 * Hn, 4 * Hn), u(4 * Hn))
    return tuple(x.to(dev).contiguous() for x in xs), torch.randn((Bn, Tn, Hn), generator=g).to(dev)


def hold_lstm(args, dy):
    """Both LSTM kernels against their plain versions on one input, and each
    against a second launch of itself. Returns (the reverse sweep's inputs,
    {fwd_abs, fwd_rel, bwd_abs, bwd_rel})."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    Bn, Tn, Hn = dy.shape
    got, again = lk.lstm2_fwd(*args), lk.lstm2_fwd(*args)
    want = lk.lstm2_core_ref(*args)
    y, h1s, c1s, c2s = want
    bargs = (dy, *args, h1s, c1s, y, c2s)
    dg_k, dg_k2 = lk.lstm2_bwd(*bargs), lk.lstm2_bwd(*bargs)
    dg_p = lk.lstm2_bwd_ref(*bargs)
    torch.cuda.synchronize()
    fe = [rel_err(a, b) for a, b in zip(got, want)]
    be = [rel_err(a, b) for a, b in zip(dg_k, dg_p)]
    e = dict(fwd_abs=max(x[0] for x in fe), fwd_rel=max(x[1] for x in fe),
             bwd_abs=max(x[0] for x in be), bwd_rel=max(x[1] for x in be))
    shape = f"B/T/H {Bn}/{Tn}/{Hn}"
    log(f"lstm2_fwd {shape}: max abs err {e['fwd_abs']:.3e}, max rel err {e['fwd_rel']:.3e}; "
        f"lstm2_bwd: max abs err {e['bwd_abs']:.3e}, max rel err {e['bwd_rel']:.3e} "
        f"(tolerance {LSTM_REL_TOL:.0e} of max |plain|)")
    check(e["fwd_rel"] <= LSTM_REL_TOL, f"lstm2_fwd disagrees with its plain version at {shape}")
    check(e["bwd_rel"] <= LSTM_REL_TOL, f"lstm2_bwd disagrees with its plain version at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"two lstm2_fwd launches differ at {shape}")
    check(all(torch.equal(a, b) for a, b in zip(dg_k, dg_k2)),
          f"two lstm2_bwd launches differ at {shape}")
    return bargs, e


def check_lstm(models, dev, report):
    """LSTM forward, reverse sweep and VJP against the plain versions."""
    import torch

    from cld_tpu_torch.ops import lstm_kernels as lk

    g = torch.Generator().manual_seed(1)
    p = lk.extract_decoder_params(models.decoder)
    z = torch.randn((B, T, L), generator=g).to(dev)
    cond = torch.randn((B, COND), generator=g).to(dev)
    xg1 = (z @ p.Wx1 + p.b1).contiguous()
    h0 = (cond @ p.Wc + p.bc).contiguous()
    args = (xg1, h0, p.Wh1, p.W2, p.b2)
    dy = torch.randn((B, T, H), generator=g).to(dev)
    bargs, e128 = hold_lstm(args, dy)  # the decoder's own weights at the open loop's shape
    held = {(B, T, H): (args, bargs)}
    errs = {f"{B}/{T}/{H}": e128}
    for shape in LSTM_SHAPES[1:]:
        a, d = lstm_inputs(g, *shape, dev)
        ba, errs["/".join(map(str, shape))] = hold_lstm(a, d)
        held[shape] = (a, ba)
    y = bargs[8]  # the plain forward's y

    def grads(fn):
        ts = [a.detach().clone().requires_grad_(True) for a in args]
        (fn(*ts) * dy).sum().backward()
        return [t.grad for t in ts]

    gk = grads(lk.lstm2_core)
    gp = grads(lambda *a: lk.lstm2_core_ref(*a)[0])
    torch.cuda.synchronize()
    names = ("xg1", "h0", "Wh1", "W2", "b2")
    for name, a, b in zip(names, gk, gp):
        e_abs, e_rel = rel_err(a, b)
        log(f"Lstm2Core VJP d{name}: max abs err {e_abs:.3e}, rel {e_rel:.3e} "
            f"(tolerance {LSTM_REL_TOL:.0e})")
        check(e_rel <= LSTM_REL_TOL, f"Lstm2Core VJP d{name} disagrees: {e_rel:.3e}")

    # the compiler's verdict on each instantiation at H = 64
    attrs = {}
    for which, kname in enumerate(("lstm2_fwd_kernel", "lstm2_bwd_gates_kernel",
                                   "lstm2_bwd_kernel")):
        for R in ((1,) if which == 1 else lk.ROWS_PER_CTA):
            a = lk.kernel_attributes(which, H, R)
            attrs[f"{kname}<{H},{R}>" if which != 1 else f"{kname}<{H}>"] = a
            log(f"{kname} H={H} R={R}: {a['registers']} registers, {a['local_bytes']} bytes of "
                f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}"
                f", max {a['max_threads']} threads per block")

    # timings: kernel, plain version, and cuDNN's LSTM from the same latents
    fwd_ms = cuda_ms(lambda: lk.lstm2_fwd(*args), 50)
    fwd_plain_ms = cuda_ms(lambda: lk.lstm2_core_ref(*args), 5)
    bwd_ms = cuda_ms(lambda: lk.lstm2_bwd(*bargs), 50)
    bwd_plain_ms = cuda_ms(lambda: lk.lstm2_bwd_ref(*bargs), 5)
    fwd_graph, bwd_graph = {}, {}
    for Bn in (CL_B, B, 512):
        a, ba = held[(Bn, T, H)]
        fwd_graph[Bn] = graph_ms(lambda: lk.lstm2_fwd(*a), launches=20)
        bwd_graph[Bn] = graph_ms(lambda: lk.lstm2_bwd(*ba), launches=20)
    log("from a CUDA graph (weight pack included), ms at B=" + ", ".join(
        f"{Bn}: lstm2_fwd {fwd_graph[Bn]:.4f}, lstm2_bwd {bwd_graph[Bn]:.4f}" for Bn in fwd_graph))

    cudnn = torch.nn.LSTM(L, H, num_layers=2, batch_first=True).to(dev)
    with torch.no_grad():
        lstm = models.decoder.lstm
        for n in range(2):
            for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(cudnn, f"{k}_l{n}").copy_(getattr(lstm, f"{k}_l{n}"))
        hc = (h0[None].expand(2, B, H).contiguous(), torch.zeros((2, B, H), device=dev))
        lib_y = cudnn(z, hc)[0]
        e_lib = float((lib_y - y).abs().max())
        log(f"cuDNN nn.LSTM from z vs the plain core: max abs diff {e_lib:.3e}")
        fwd_lib_ms = cuda_ms(lambda: cudnn(z, hc), 50)
        fwd_lib_graph = graph_ms(lambda: cudnn(z, hc), launches=20)

    # backward yardsticks: cuDNN's (train mode; input, h0 and weights) and the
    # port's whole Lstm2Core VJP (kernel + batched matmuls), each as forward +
    # backward minus the same forward
    zr = z.clone().requires_grad_(True)
    h0r = hc[0].clone().requires_grad_(True)
    lib_in = (zr, h0r, *cudnn.parameters())
    lib_fwd = lambda: cudnn(zr, (h0r, hc[1]))[0]
    lib_train_fwd_ms = cuda_ms(lib_fwd, 50)
    bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_fwd(), lib_in, dy), 50) - lib_train_fwd_ms
    core_in = [a.detach().clone().requires_grad_(True) for a in args]
    core_fwd = lambda: lk.lstm2_core(*core_in)
    core_fwd_ms = cuda_ms(core_fwd, 50)
    vjp_ms = cuda_ms(lambda: torch.autograd.grad(core_fwd(), core_in, dy), 50) - core_fwd_ms
    log(f"lstm2_fwd {fwd_ms:.4f} ms from Python ({fwd_graph[B]:.4f} from a graph) vs cuDNN "
        f"nn.LSTM forward {fwd_lib_ms:.4f} ({fwd_lib_graph:.4f}); lstm2_bwd {bwd_ms:.4f} ms, "
        f"Lstm2Core VJP {vjp_ms:.4f} vs cuDNN backward {bwd_lib_ms:.4f} (B={B})")

    f32 = 4
    w_bytes = f32 * (H * 4 * H + 2 * H * 4 * H + 4 * H)
    fwd_b, fwd_by = bound(f32 * (B * T * 4 * H + B * H + 4 * B * T * H) + w_bytes,
                          2.0 * B * T * (H * 4 * H + 2 * H * 4 * H))
    bwd_b, bwd_by = bound(
        f32 * (B * T * H + B * T * 4 * H + B * H + 4 * B * T * H + 2 * B * T * 4 * H) + w_bytes,
        2.0 * B * T * (H * 4 * H + 2 * H * 4 * H + 4 * H * 2 * H + 4 * H * H))
    report["lstm2_fwd"] = dict(max_abs_err=e128["fwd_abs"], max_rel_err=e128["fwd_rel"],
                               ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_b, bound_by=fwd_by,
                               library_ms=fwd_lib_ms, library_graph_ms=fwd_lib_graph,
                               graph_ms={str(k): v for k, v in fwd_graph.items()},
                               held={k: dict(abs=e["fwd_abs"], rel=e["fwd_rel"])
                                     for k, e in errs.items()},
                               attributes={k: v for k, v in attrs.items() if "fwd" in k})
    report["lstm2_bwd"] = dict(max_abs_err=e128["bwd_abs"], max_rel_err=e128["bwd_rel"],
                               ms=bwd_ms, plain_ms=bwd_plain_ms, bound_ms=bwd_b, bound_by=bwd_by,
                               library_ms=bwd_lib_ms, library_train_fwd_ms=lib_train_fwd_ms,
                               lstm2core_vjp_ms=vjp_ms,
                               graph_ms={str(k): v for k, v in bwd_graph.items()},
                               held={k: dict(abs=e["bwd_abs"], rel=e["bwd_rel"])
                                     for k, e in errs.items()},
                               attributes={k: v for k, v in attrs.items() if "bwd" in k})


def check_gather(batch, dev, report):
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk

    packed = gk.pack_drivable_bits(batch.drivable_map)
    Hm, W8 = packed.shape[1:]
    W = batch.drivable_map.shape[-1]
    g = torch.Generator().manual_seed(2)
    pix = gather_pix(g, B, Q, W, Hm, dev)
    got = gk.drivable_bit_gather(pix, packed)
    want = gk.drivable_bit_gather_ref(pix, packed)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    n_on = int(want.sum())
    log(f"bit_gather: max abs err {err} (tolerance 0, exact); {n_on} of {B * Q} on-road")
    check(err == 0.0, "bit_gather disagrees with its plain version")
    check(0 < n_on < B * Q, "bit_gather fixture is degenerate")
    ms = cuda_ms(lambda: gk.drivable_bit_gather(pix, packed), 200)
    plain_ms = cuda_ms(lambda: gk.drivable_bit_gather_ref(pix, packed), 50)
    b_ms, b_by, needed = gather_bound(pix, Hm, W8, 1, 4, col_shift=3)
    g_ms = graph_ms(lambda: gk.drivable_bit_gather(pix, packed))
    log(f"bit_gather bound counts {needed} of {B * Hm * W8} map bytes (those under a query); "
        f"{ms:.4f} ms from Python, {g_ms:.5f} from a graph")
    report["bit_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None, source_bytes_needed=needed,
                                graph_ms=g_ms)


def run_main_path(models, batch, report):
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native

    g = torch.Generator(device=batch.image.device)
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline.guided_collect(models, batch, guided=True,
                                  agents_per_scene=AGENTS_PER_SCENE,
                                  generator=g.manual_seed(10))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = native.launch_counts()
    log(f"guided pipeline (first call, {first_s:.2f} s): launches {launches}, "
        f"reward {float(out['reward']):.4f}")
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=N_STEPS - 1, bit_gather=N_STEPS - 1,
                  offroad_count=1)  # the reward's off-road count, once per call
    check(launches == want, f"kernel launches {launches}, expected {want}")
    for k in ("pred_traj", "traj", "reward_per_agent", "cond_feat"):
        check(bool(torch.isfinite(out[k]).all()), f"guided output {k} is not finite")
    check(tuple(out["traj"].shape) == (B, 1, T, 6), f"traj shape {tuple(out['traj'].shape)}")
    report["launches"] = launches

    def timed(guided, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = pipeline.guided_collect(models, batch, guided=guided,
                                    agents_per_scene=AGENTS_PER_SCENE,
                                    generator=g.manual_seed(seed))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, o

    guided_s, _ = timed(True, 11)
    unguided_s, uo = timed(False, 12)
    check(uo["launches"] == counts(lstm2_fwd=1, offroad_count=1),
          f"unguided launches {uo['launches']}")
    for k in ("pred_traj", "traj", "reward_per_agent"):
        check(bool(torch.isfinite(uo[k]).all()), f"unguided output {k} is not finite")
    nfe = B * N_STEPS
    report["pipeline"] = dict(first_guided_s=first_s, guided_s=guided_s,
                              guided_nfe_per_s=nfe / guided_s, unguided_s=unguided_s,
                              unguided_nfe_per_s=nfe / unguided_s)
    log(f"guided {nfe / guided_s:.1f} NFE/s ({guided_s:.3f} s/call), unguided "
        f"{nfe / unguided_s:.1f} NFE/s ({unguided_s:.3f} s/call) at B={B}, "
        f"{N_STEPS} steps, on {report['card']}")


def road_edge_shift(g, Bn):
    """[Bn, 1, 1, 6] sideways shifts of 5.5 to 8.5 m to either side: added to
    trajectories that run along the synthetic road (7 m wide to each side of
    its centre line), they put the bbox grids across its edge."""
    import torch

    side = torch.zeros((Bn, 1, 1, 6))
    side[:, 0, 0, 1] = (torch.rand((Bn,), generator=g) * 3.0 + 5.5) * (
        torch.randint(0, 2, (Bn,), generator=g) * 2 - 1)
    return side


def check_small_slice(dev, report, min_dist_impl="separable"):
    """The slice at a small size on the card (kernels) and on the CPU (plain
    versions), same weights and noise, with the map loss under
    `min_dist_impl`. Each comparison holds
    |card - cpu| <= 1e-4 |cpu| + floor * max |cpu|. The floor is 1e-6 for
    trajectories and unguided latents. It is 1e-4 for the guided latents:
    one Adam step from m = v = 0 moves a component by ~lr * sign(g), so a
    gradient component near zero can take the other sign and move by up to
    2 sigma. It is 1e-4 for the guidance gradient too, whose near-zero
    components carry the rounding of f32 sums over the bbox grid; it is taken
    on the decoded trajectories shifted to the road's edge
    (`road_edge_shift`)."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import guidance_gradient

    Bs, steps = 8, 10
    g = torch.Generator().manual_seed(3)
    x_init = torch.randn((Bs, T, L), generator=g)
    noises = torch.randn((steps, Bs, T, L), generator=g)
    z = torch.randn((Bs, T, L), generator=g)
    side = road_edge_shift(g, Bs)  # the gradient is taken where the map loss has work
    res = {}
    for where in ("cpu", dev):
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=steps)
        b = synthetic_batch(seed=4, batch_size=Bs, raster_size=64, device=where)
        specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, min_dist_impl=min_dist_impl)
        outs = {gd: pipeline.guided_collect(m, b, guided=gd, agents_per_scene=AGENTS_PER_SCENE,
                                            x_init=x_init.to(where), step_noises=noises.to(where),
                                            specs=specs)
                for gd in (False, True)}
        aux = m.context(b)
        wfa, si = pipeline.scene_world_poses(Bs, AGENTS_PER_SCENE, where)
        ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
            b.drivable_map, b.raster_from_agent, b.extent, b.curr_speed, wfa, si)))

        def decode_fn(v):
            acts = pipeline.decode_actions(m.decoder, v, aux["cond_feat"])
            return pipeline.convert_action_to_state_and_action(
                acts, aux["curr_states"], m.dyn, pipeline.TrajNormalizer(),
                descaled_output=True)[:, None] + side.to(where)

        grad = guidance_gradient(z.to(where), ctx, specs, decode_fn)
        res[str(where)] = (outs, grad.cpu(), outs[True]["launches"])
    (c_outs, c_grad, _), (g_outs, g_grad, g_launch) = res["cpu"], res[str(dev)]
    want = counts(lstm2_fwd=steps, lstm2_bwd=steps - 1, bit_gather=steps - 1, offroad_count=1)
    if min_dist_impl == "rigid_kernel":
        want.update(rigid_min=steps - 1, rigid_bwd=steps - 1)
    check(g_launch == want, f"small slice ({min_dist_impl}) launches {g_launch}, expected {want}")
    tag0 = f"small slice ({min_dist_impl})"

    def close(name, a, b, floor):
        a, b = a.detach().cpu(), b.detach().cpu()
        err = float((a - b).abs().max())
        tol = SLICE_RTOL * b.abs() + floor * float(b.abs().max())
        ok = bool(((a - b).abs() <= tol).all())
        log(f"{tag0} {name}: card vs CPU max abs diff {err:.3e} "
            f"(rtol {SLICE_RTOL:.0e}, floor {floor:.0e} of max {float(b.abs().max()):.3g})")
        check(ok, f"{tag0} {name} disagrees between card and CPU")
        return err

    summary = {}
    for gd in (False, True):
        tag = "guided" if gd else "unguided"
        summary[f"{tag}_traj"] = close(f"{tag} traj", g_outs[gd]["traj"], c_outs[gd]["traj"], 1e-6)
        summary[f"{tag}_latents"] = close(f"{tag} latents", g_outs[gd]["pred_traj"],
                                          c_outs[gd]["pred_traj"], 1e-4 if gd else 1e-6)
    check(float(c_grad.abs().max()) > 0.0, "small slice guidance gradient is zero")
    summary["guidance_grad"] = close("guidance gradient", g_grad, c_grad, 1e-4)
    report["small_slice" if min_dist_impl == "separable" else f"small_slice_{min_dist_impl}"] = \
        summary


def check_map_gathers(dev, report):
    """`value_gather` and `drivable_gather` against their plain versions at
    the closed loop's shapes, exactly; `value_gather` also at ragged shapes,
    with its registers and spills and its time from a CUDA graph beside one
    `torch.take`."""
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops.raster import _pick_band

    g = torch.Generator().manual_seed(6)
    BH, WIN = _pick_band(RASTER, 1.0)
    M, Qb, C = CL_B * (RASTER // BH), BH * RASTER, 3
    wins = torch.randint(-128, 128, (M, WIN, WIN, C), generator=g, dtype=torch.int8).to(dev)
    pix = gather_pix(g, M, Qb, WIN, WIN, dev)
    got = gk.value_gather(pix, wins)
    want = gk.value_gather_ref(pix, wins)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"value_gather [M={M}, Q={Qb}, {WIN}x{WIN}x{C}]: max abs err {err} (tolerance 0, exact); "
        f"values in [{float(want.min()):.0f}, {float(want.max()):.0f}]")
    check(err == 0.0, "value_gather disagrees with its plain version")
    check(float(want.min()) == -128.0 and float(want.max()) == 127.0,
          "value_gather fixture misses the byte range's ends")
    # ragged shapes: Q % 4 != 0 and pix 8 bytes off a 16-byte boundary (the
    # kernel's scalar path), C = 1, 4 and 5 (its runtime-C loop), one window
    held = {}
    for name, (Mn, Qn, Hn, Wn, Cn, shift) in {
            "q_ragged_c1": (5, 1027, 40, 48, 1, 0), "c4": (3, 4096, 64, 64, 4, 0),
            "m1_q_ragged_c4": (1, Qb - 1, WIN, WIN, 4, 0), "m1_c3": (1, 1029, 33, 17, 3, 0),
            "c5": (2, 300, 20, 30, 5, 0), "pix_off16": (4, 2048, 64, 64, 3, 1)}.items():
        w = torch.randint(-128, 128, (Mn, Hn, Wn, Cn), generator=g, dtype=torch.int8).to(dev)
        p = gather_pix(g, Mn, Qn, Wn, Hn, dev)
        if shift:
            p = torch.cat([torch.zeros(2, dtype=torch.int32, device=dev), p.reshape(-1)])[2:]
            p = p.view(Mn, Qn, 2)
            check(p.data_ptr() % 16 == 8, "value_gather fixture: pix not 8 bytes off")
        a, b = gk.value_gather(p, w), gk.value_gather_ref(p, w)
        torch.cuda.synchronize()
        held[name] = float((a - b).abs().max())
        log(f"value_gather [{name}: M={Mn}, Q={Qn}, {Hn}x{Wn}x{Cn}]: max abs err {held[name]} "
            "(exact)")
        check(held[name] == 0.0, f"value_gather ({name}) disagrees with its plain version")
    attrs = {name: gk.value_gather_attributes(Cn, v)
             for name, Cn, v in (("C=3,vector", 3, True), ("C=3,scalar", 3, False),
                                 ("any other C", 1, False))}
    for k, a in attrs.items():
        log(f"value_gather_kernel {k}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    ms = cuda_ms(lambda: gk.value_gather(pix, wins), 100)
    plain_ms = cuda_ms(lambda: gk.value_gather_ref(pix, wins), 20)
    b_ms, b_by, needed = gather_bound(pix, WIN, WIN, C, 4 * C)
    # the same bound with the windows read in whole 32-byte sectors, as the
    # memory system moves them
    byte = (((torch.arange(M, device=dev)[:, None] * WIN + pix[..., 1].long()) * WIN
             + pix[..., 0].long()) * C)[..., None] + torch.arange(C, device=dev)
    sectors = int(torch.unique(byte // 32).numel())
    sector_ms = bound(8 * M * Qb + 32 * sectors + 4 * C * M * Qb, 0.0)[0]
    log(f"value_gather bound counts {needed} of {M * WIN * WIN * C} window bytes "
        f"(those under a query); in 32-byte sectors {32 * sectors} bytes, bound {sector_ms:.5f}")
    # yardstick: one torch.take on a flat index made outside the timed region
    flat = ((torch.arange(M, device=dev)[:, None] * WIN + pix[..., 1].long()) * WIN
            + pix[..., 0].long())[..., None] * C + torch.arange(C, device=dev)
    check(torch.equal(torch.take(wins, flat).float(), want), "torch.take misses value_gather")
    # `ms` and `library_ms` both from Python, the graph times beside them
    lib_ms = cuda_ms(lambda: torch.take(wins, flat), 100)
    lib_graph = graph_ms(lambda: torch.take(wins, flat))
    k_graph = graph_ms(lambda: gk.value_gather(pix, wins))
    log(f"value_gather {ms:.4f} ms from Python, {k_graph:.5f} from a graph; torch.take "
        f"{lib_ms:.4f} from Python, {lib_graph:.5f} from a graph; bound {b_ms:.5f} ({b_by})")
    report["value_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms, source_bytes_needed=needed,
                                  source_sector_bytes=32 * sectors, sector_bound_ms=sector_ms,
                                  graph_ms=k_graph, library_graph_ms=lib_graph, held=held,
                                  attributes=attrs)

    drv = (torch.rand((CL_B, RASTER, RASTER), generator=g) < 0.6)
    pix = gather_pix(g, CL_B, Q, RASTER, RASTER, dev)
    worst = 0.0
    for name, m in (("int8", (drv.to(torch.int8) * 3 - 1).to(dev)),
                    ("float32", torch.where(drv, torch.rand(drv.shape, generator=g) + 0.1,
                                            torch.zeros(())).to(dev))):
        got, want = gk.drivable_gather(pix, m), gk.drivable_gather_ref(pix, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_on = int((want > 0).sum())
        log(f"drivable_gather {name} [B={CL_B}, Q={Q}, {RASTER}x{RASTER}]: max abs err {err} "
            f"(tolerance 0, exact); {n_on} of {CL_B * Q} on-road")
        check(err == 0.0, f"drivable_gather ({name}) disagrees with its plain version")
        check(0 < n_on < CL_B * Q, "drivable_gather fixture is degenerate")
        worst = max(worst, err)
    held, attrs = check_drivable_gather_edges(g, dev), {}
    for dt, dtype in (("int8", torch.int8), ("float32", torch.float32)):
        for path in ("vector", "scalar"):
            a = attrs[f"{dt},{path}"] = gk.drivable_gather_attributes(dtype, path == "vector")
            spills = " (spills: reported, not failed)" if a["local_bytes"] else ""
            log(f"drivable_gather_kernel {dt} {path}: {a['registers']} registers, "
                f"{a['local_bytes']} bytes of local memory per thread{spills}")
    m8 = drv.to(torch.int8).to(dev)
    ms = cuda_ms(lambda: gk.drivable_gather(pix, m8), 200)
    plain_ms = cuda_ms(lambda: gk.drivable_gather_ref(pix, m8), 50)
    b_ms, b_by, needed = gather_bound(pix, RASTER, RASTER, 1, 4)
    log(f"drivable_gather bound counts {needed} of {CL_B * RASTER * RASTER} map bytes "
        "(those under a query)")
    flat = ((torch.arange(CL_B, device=dev)[:, None] * RASTER + pix[..., 1].long()) * RASTER
            + pix[..., 0].long())
    check(torch.equal(torch.take(m8, flat).float(), gk.drivable_gather_ref(pix, m8)),
          "torch.take misses drivable_gather")
    lib_ms = cuda_ms(lambda: torch.take(m8, flat), 200)
    lib_graph = graph_ms(lambda: torch.take(m8, flat))
    k_graph = graph_ms(lambda: gk.drivable_gather(pix, m8))
    log(f"drivable_gather {ms:.4f} ms from Python, {k_graph:.5f} from a graph; torch.take "
        f"{lib_ms:.4f} from Python, {lib_graph:.5f} from a graph; bound {b_ms:.6f} ({b_by})")
    report["drivable_gather"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms, source_bytes_needed=needed,
                                     graph_ms=k_graph, library_graph_ms=lib_graph, held=held,
                                     attributes=attrs)


# (B, Q) at which `drivable_gather` is held: one query, ragged groups of 3, 4
# and 5, the "px" replan's Q = 5,200 and its neighbours, B one past the
# replan's 32
DRIVABLE_GATHER_EDGES = ((1, 1), (1, 3), (1, 4), (1, 5), (32, 5199), (32, 5200), (32, 5201),
                         (33, 5), (33, 5200), (33, 5201))


def check_drivable_gather_edges(g, dev) -> dict:
    """`drivable_gather` on int8 and float32 maps at `DRIVABLE_GATHER_EDGES`,
    with coordinates up to 8 pixels outside the map (clamped), and at the
    replan's shape through a pix view 8 bytes off a 16-byte boundary: equal
    to its plain version (tolerance 0) and to a second launch bit for bit.
    Both the 16-byte and the scalar path are reached for both map types."""
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk

    R, held, paths = RASTER, {}, set()
    maps = (torch.rand((33, R, R), generator=g) < 0.6)
    maps = {"int8": (maps.to(torch.int8) * 3 - 1).to(dev),
            "float32": torch.where(maps, torch.rand(maps.shape, generator=g) + 0.1,
                                   torch.zeros(())).to(dev)}
    for Bn, Qn, off16 in [(*e, False) for e in DRIVABLE_GATHER_EDGES] + [(CL_B, Q, True)]:
        pix = torch.stack([torch.randint(-8, R + 8, (Bn, Qn), generator=g),
                           torch.randint(-8, R + 8, (Bn, Qn), generator=g)], -1).to(torch.int32)
        pix = pix.to(dev).contiguous()
        if off16:  # the same queries in storage 8 bytes off a 16-byte boundary
            pix = torch.cat([torch.zeros(2, dtype=torch.int32, device=dev),
                             pix.reshape(-1)])[2:].view(Bn, Qn, 2)
            check(pix.data_ptr() % 16 == 8, "drivable_gather fixture: pix not 8 bytes off")
        for dt, m in maps.items():
            m = m[:Bn].contiguous()
            got, again = gk.drivable_gather(pix, m), gk.drivable_gather(pix, m)
            want = gk.drivable_gather_ref(pix, m)
            vec = gk.drivable_gather_vector(pix, got)
            torch.cuda.synchronize()
            key = f"{dt},B={Bn},Q={Qn}{',pix_off16' if off16 else ''}"
            held[key] = float((got - want).abs().max())
            paths.add((dt, vec))
            log(f"drivable_gather [{key}, {'vector' if vec else 'scalar'} path]: max abs err "
                f"{held[key]} (tolerance 0, exact)")
            check(held[key] == 0.0, f"drivable_gather ({key}) disagrees with its plain version")
            check(torch.equal(got, again), f"drivable_gather ({key}) differs between two launches")
    check(len(paths) == 4, f"drivable_gather edges reach only {sorted(paths)}")
    return held


def check_warp(pack, dev, report):
    """Banded vs exact `warp_scene_maps` on the card for the 32-agent pack,
    at the spawn poses and at the same positions under random yaws. The
    pack's drivable and lane layers are {0, 1}: identical. Its middle layer
    is 0.5, which the 8-bit windows store as 128/255: within 1/510."""
    import torch

    from cld_tpu_torch.ops.geometry import world_from_agent_matrix
    from cld_tpu_torch.ops.raster import warp_scene_maps

    g = torch.Generator().manual_seed(8)
    pos = pack.init_states[:, :2]
    worst = 0.0
    for yaw in (pack.init_states[:, 3], (torch.rand((CL_B,), generator=g) * 6.2 - 3.1).to(dev)):
        wfa = world_from_agent_matrix(pos, yaw)
        args = (pack.world_map, pack.map_origin, pack.map_resolution, wfa, pack.scene_index,
                RASTER, 0.5, (-0.5, 0.0))
        exact = warp_scene_maps(*args, impl="exact")
        banded = warp_scene_maps(*args, impl="banded")
        torch.cuda.synchronize()
        check(torch.equal(banded[..., 0], exact[..., 0]) and torch.equal(banded[..., 2],
                                                                         exact[..., 2]),
              "banded warp differs from the exact warp on a {0, 1} layer")
        err = float((banded[..., 1] - exact[..., 1]).abs().max())
        check(err <= 1.0 / 510 + 1e-6, f"banded warp is {err} off on the 0.5 layer")
        check(0.0 < float(exact[..., 0].mean()) < 1.0, "warp fixture is degenerate")
        worst = max(worst, err)
    ms = {impl: cuda_ms(lambda: warp_scene_maps(*args, impl=impl), 10) for impl in
          ("banded", "exact")}
    log(f"warp_scene_maps banded vs exact, {CL_B} agents: {{0,1}} layers identical, 0.5 layer "
        f"max abs diff {worst:.3e} (<= 1/510); banded {ms['banded']:.3f} ms, exact "
        f"{ms['exact']:.3f} ms per call")
    report["warp"] = dict(max_abs_diff_half_layer=worst, banded_ms=ms["banded"],
                          exact_ms=ms["exact"])


def run_closed_loop(models, pack, report):
    """The guided closed loop at full width, once; launch counts exact."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.metrics import summarize_metrics

    dev = pack.init_states.device
    cfg = env.SimConfig(num_simulation_steps=CL_STEPS, n_step_action=CL_N_STEP,
                        raster_size=RASTER)
    policy = pipeline.make_dm_policy(models, CL_AGENTS)
    marks = []

    def timed_policy(obs, rng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = policy(obs, rng)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        return out

    g = torch.Generator(device=dev)
    # one replan first, so that the timed episode does not pay for first-call set-up
    warm = env.SimConfig(num_simulation_steps=CL_N_STEP, n_step_action=CL_N_STEP,
                         raster_size=RASTER)
    env.simulate(pack, policy, warm, generator=g.manual_seed(20))
    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, traj = env.simulate(pack, timed_policy, cfg, generator=g.manual_seed(21))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = cfg.num_replans
    want = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                  bit_gather=(N_STEPS - 1) * n, value_gather=n)
    log(f"closed loop ({CL_SCENES} x {CL_AGENTS} agents, {CL_STEPS} frames, {n} replans, "
        f"{wall:.2f} s): launches {launches}")
    check(launches == want, f"closed-loop launches {launches}, expected {want}")
    check(tuple(traj.shape) == (CL_STEPS, CL_B, 4), f"trajectory log shape {tuple(traj.shape)}")
    check(bool(torch.isfinite(traj).all()) and bool(torch.isfinite(state.states).all()),
          "closed-loop states are not finite")
    check(state.step == CL_STEPS, f"closed loop stopped at frame {state.step}")
    moved = traj[-1, :, 0] - pack.init_states[:, 0]
    check(bool((moved.abs() > 0.1).all()), "an agent did not move in the closed loop")
    metrics = summarize_metrics(pack, state, cfg)
    log(f"closed-loop metrics: {json.dumps(metrics)}")

    policy_s = sum(b - a for a, b in marks) / n
    # render and step alone, on the episode's last state
    world_q8 = env.quantize_world_maps_q8(pack.world_map)
    last = state._replace(step=CL_STEPS - CL_N_STEP)

    def host_s(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters

    render_s = host_s(lambda: env.render_observation(pack, last, cfg, world_q8=world_q8))
    acts = torch.zeros((CL_B, T, 2), device=dev)
    step_s = host_s(lambda: env._consume_actions(pack, last, acts, cfg))
    rate = CL_B * CL_STEPS / wall
    report["launches_closed_loop"] = launches
    report["closed_loop"] = dict(
        wall_s=wall, agent_steps_per_s=rate, replans=n, s_per_replan=wall / n,
        policy_s_per_replan=policy_s, render_s_per_replan=render_s,
        step_s_per_replan=step_s, metrics=metrics)
    log(f"closed loop {rate:.1f} agent-steps/s ({wall / n:.3f} s per replan: policy "
        f"{policy_s:.3f} s, render {render_s * 1e3:.2f} ms, {CL_N_STEP} frames of stepping "
        f"{step_s * 1e3:.2f} ms) at {CL_SCENES} x {CL_AGENTS} agents, raster {RASTER}, "
        f"{N_STEPS} DDPM steps per replan, on {report['card']}")


def offroad_observation(pack, g):
    """The pack's first observation with agents off the road and on top of
    each other, so that both losses and the gathers have work: lateral
    offsets up to the road's edge."""
    import torch

    from cld_tpu_torch.sim import env

    dev = pack.init_states.device
    cfg = env.SimConfig(num_simulation_steps=CL_STEPS, n_step_action=CL_N_STEP,
                        raster_size=RASTER)
    init = pack.init_states.clone()
    init[:, 1] += (torch.rand((CL_B,), generator=g) * 10.0 - 5.0).to(dev)
    init[:, 3] += (torch.rand((CL_B,), generator=g) * 0.6 - 0.3).to(dev)
    init[1::2, 0] = init[0::2, 0] + 3.0
    moved = pack._replace(init_states=init)
    return env.render_observation(moved, env.init_sim_state(moved, cfg), cfg)


def run_px_replan(models, pack, report):
    """One replan with the unpacked drivable gather: same guidance gradient
    and same plan as with the bit gather, exactly."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import guidance_gradient
    from cld_tpu_torch.ops import native

    dev = pack.init_states.device
    g = torch.Generator().manual_seed(9)
    obs = offroad_observation(pack, g)

    aux = models.context(obs)
    ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
        obs.drivable_map, obs.raster_from_agent, obs.extent, obs.curr_speed,
        obs.world_from_agent, obs.scene_index)))

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None]

    z = torch.randn((CL_B, T, L), generator=g).to(dev)
    grads = {impl: guidance_gradient(z, ctx, pipeline.flagship_guidance_specs(CL_AGENTS, impl),
                                     decode_fn) for impl in ("bits", "px")}
    torch.cuda.synchronize()
    gmax = float(grads["bits"].abs().max())
    gdiff = float((grads["bits"] - grads["px"]).abs().max())
    log(f"guidance gradient, bits vs px gather: max abs diff {gdiff} (tolerance 0, exact); "
        f"max |g| {gmax:.3e}")
    check(gmax > 0.0, "px replan: the guidance gradient is zero")
    check(torch.equal(grads["bits"], grads["px"]), "px and bits guidance gradients differ")

    gen = torch.Generator(device=dev)
    plans, launched = {}, {}
    for impl in ("bits", "px"):
        policy = pipeline.make_dm_policy(
            models, CL_AGENTS, specs=pipeline.flagship_guidance_specs(CL_AGENTS, impl))
        native.reset_launch_counts()
        plans[impl] = policy(obs, gen.manual_seed(22)).controls
        torch.cuda.synchronize()
        launched[impl] = native.launch_counts()
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=N_STEPS - 1, drivable_gather=N_STEPS - 1)
    log(f"px replan: launches {launched['px']}")
    check(launched["px"] == want, f"px replan launches {launched['px']}, expected {want}")
    check(bool(torch.isfinite(plans["px"]).all()), "px replan's plan is not finite")
    check(torch.equal(plans["px"], plans["bits"]), "px and bits plans differ")
    report["launches_px_replan"] = launched["px"]


def rigid_fixture(g, Bn, Qn, P, dev, d2=None, on=None):
    """(d2 [Bn, P, P], on [Bn, Qn, P] bool, pts, g_out) for the rigid kernels:
    a random point cloud's distances and random mask unless given; an
    all-off-road and an all-on-road step forced in; cotangents zero at
    on-road columns and in steps without an on-road row, as the loss has
    them."""
    import torch

    if d2 is None:
        local = torch.randn((Bn, P, 2), generator=g) * 2.0
        d2 = ((local[:, :, None] - local[:, None]) ** 2).sum(-1).to(dev).contiguous()
    if on is None:
        on = (torch.rand((Bn, Qn, P), generator=g) > 0.4).to(dev)
    on = on.clone()
    on[0, 0] = False
    on[1, 1] = True
    pts = (torch.randn((Bn, Qn, P, 2), generator=g) * 5.0).to(dev)
    gout = torch.randn((Bn, Qn, P), generator=g).to(dev)
    gout = torch.where(on | ~on.any(-1, keepdim=True), torch.zeros(()).to(dev), gout)
    return d2, on.contiguous(), pts, gout.contiguous()


def hold_rigid_min(name, outs, want_d, want_i, worst):
    """Both forward kernels' (dist, idx) equal to the plain version's bit for
    bit (compare-selects and one IEEE sqrt: no tolerance), and so to each
    other."""
    import torch

    for kname, (got_d, got_i) in outs.items():
        err = float((got_d - want_d).abs().max())
        rel_each = float(((got_d - want_d).abs() / want_d).max())
        exact = bool(torch.equal(got_d, want_d))
        Bn, Qn, Pn = want_d.shape
        log(f"{kname} [{name}: B={Bn}, Q={Qn}, P={Pn}]: dist max rel err {rel_each:.3e} "
            f"(bit for bit: {exact}), idx equal: {bool(torch.equal(got_i, want_i))}")
        check(exact, f"{kname} ({name}) dist differs from its plain version")
        check(torch.equal(got_i, want_i), f"{kname} ({name}) idx disagrees")
        worst[kname] = max(worst[kname], err)
    check(torch.equal(outs["rigid_min"][0], outs["rigid_min_fused"][0])
          and torch.equal(outs["rigid_min"][1], outs["rigid_min_fused"][1]),
          f"rigid_min_fused differs from rigid_min ({name})")


# (B, Q, P) where the forward kernels' bit-packed mask and step tiles are
# edge-prone: P at and around a mask word of 32 rows, up to MAX_P's 7 words;
# Q at one step, around `rigid_min`'s tile of 4 and the fused tile of 8, past
# `rigid_min`'s block of 16 steps and the fused sweep of 64; B = 1 and past
# the card's 132 SMs
RIGID_MIN_EDGES = {
    "p1": (4, 5, 1), "p31": (3, 9, 31), "p32": (3, 7, 32), "p33": (3, 17, 33),
    "p65": (2, 65, 65), "max_p": (2, 53, 224), "q1": (3, 1, 100), "q3": (3, 3, 100),
    "q5": (3, 5, 100), "q7": (3, 7, 100), "q9": (3, 9, 100), "q53": (2, 53, 100),
    "b1": (1, 52, 100), "b133": (133, 52, 100),
}


def lattice_d2(g, Bn, P, dev):
    """[Bn, P, P] squared distances of an R x C bbox lattice (R * C = P, R the
    largest divisor up to sqrt(P)) scaled by random extents, as
    `prepack_map_bbox` builds the cache: full of exactly tied distances."""
    import torch

    from cld_tpu_torch.guidance import losses as gl

    R = max(r for r in range(1, int(P ** 0.5) + 1) if P % r == 0)
    ext = torch.rand((Bn, 1, 2), generator=g) * 3.0 + 1.0
    pts = gl.bbox_local_grid((R, P // R), "cpu")[None] * ext
    return ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1).to(dev).contiguous()


def check_rigid_min_edges(g, dev, worst):
    """`rigid_min` and `rigid_min_fused` at RIGID_MIN_EDGES on lattice caches,
    random masks (60% on-road) with an all-off-road and an all-on-road step
    forced in where there are two steps."""
    import torch

    from cld_tpu_torch.ops import rigid_kernels as rk

    for name, (Bn, Qn, Pn) in RIGID_MIN_EDGES.items():
        d2 = lattice_d2(g, Bn, Pn, dev)
        on = torch.rand((Bn, Qn, Pn), generator=g) < 0.6
        if Bn * Qn > 1:
            on.view(Bn * Qn, Pn)[0] = False
            on.view(Bn * Qn, Pn)[-1] = True
        on = on.to(dev)
        want_d, want_i = rk.rigid_min_ref(d2, on)
        outs = {"rigid_min": rk.rigid_min(d2, on), "rigid_min_fused": rk.rigid_min_fused(d2, on)}
        torch.cuda.synchronize()
        hold_rigid_min(name, outs, want_d, want_i, worst)
        if Bn * Qn > 1:
            check(bool((want_d[0, 0] == 1e6).all()) and bool((want_i[0, 0] == 0).all()),
                  "all-off-road step: expected dist 1e6, idx 0")
            check(torch.equal(want_i[-1, -1].long(), torch.arange(Pn, device=dev)),
                  "all-on-road step: every column should match itself")


def check_rigid(batch, dev, report):
    """`rigid_min`, `rigid_min_fused` and `rigid_bwd` against their plain
    versions on the card."""
    import torch

    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import gather_kernels as gk
    from cld_tpu_torch.ops import rigid_kernels as rk

    g = torch.Generator().manual_seed(14)
    P = 100
    wfa = torch.eye(3, device=dev).expand(B, 3, 3)
    ctx = gl.prepack_map_bbox(gl.GuidanceContext(
        batch.drivable_map, batch.raster_from_agent, batch.extent, batch.curr_speed, wfa,
        torch.zeros((B,), dtype=torch.long, device=dev)))
    # the mask: the batch's own on-road bits under random pixels, 10% random bits mixed in
    Hm, W = batch.drivable_map.shape[-2:]
    pix = gather_pix(g, B, T * P, W, Hm, dev)
    on_map = gk.drivable_bit_gather(pix, gk.pack_drivable_bits(batch.drivable_map)) > 0
    flip = (torch.rand((B, T * P), generator=g) < 0.1).to(dev)
    rand = (torch.rand((B, T * P), generator=g) < 0.5).to(dev)
    on_full = torch.where(flip, rand, on_map).reshape(B, T, P)

    shapes = {"open_loop": (B, T, P, ctx.bbox_d2, on_full), "ragged": (5, 7, 16, None, None),
              "max_p": (2, 3, rk.MAX_P, None, None)}
    worst = {"rigid_min": 0.0, "rigid_min_fused": 0.0, "rigid_bwd": 0.0}
    for name, (Bn, Qn, Pn, d2, on) in shapes.items():
        d2, on, pts, gout = rigid_fixture(g, Bn, Qn, Pn, dev, d2, on)
        want_d, want_i = rk.rigid_min_ref(d2, on)
        outs = {"rigid_min": rk.rigid_min(d2, on), "rigid_min_fused": rk.rigid_min_fused(d2, on)}
        torch.cuda.synchronize()
        hold_rigid_min(name, outs, want_d, want_i, worst)
        check(bool((want_d[0, 0] == 1e6).all()) and bool((want_i[0, 0] == 0).all()),
              "all-off-road step: expected dist 1e6, idx 0")
        check(torch.equal(want_i[1, 1].long(), torch.arange(Pn, device=dev)),
              "all-on-road step: every column should match itself")
        n_on = int(on.sum())
        check(0 < n_on < on.numel(), "rigid fixture mask is degenerate")

        got = rk.rigid_bwd(pts, want_i, want_d, gout)
        again = rk.rigid_bwd(pts, want_i, want_d, gout)
        ref = rk.rigid_bwd_ref(pts, want_i, want_d, gout)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok = bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-5).all())
        log(f"rigid_bwd [{name}]: max abs err {err:.3e} (rtol 1e-4, atol 1e-5; max |plain| "
            f"{float(ref.abs().max()):.3g}); repeated launch bit-identical: "
            f"{bool(torch.equal(got, again))}")
        check(ok, f"rigid_bwd ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"rigid_bwd ({name}) differs between two launches")
        check(float(ref.abs().max()) > 0.0, "rigid_bwd fixture routes nothing")
        worst["rigid_bwd"] = max(worst["rigid_bwd"], err)
        if name == "open_loop":
            full = (d2, on, pts, gout, want_d, want_i)

    check_rigid_min_edges(g, dev, worst)

    # the backward alone where its grouping of a warp's columns by row is
    # edge-prone: one column, one column past a chunk of 32, every column
    # routed to one row (groups of 32)
    for name, (Bn, Qn, Pn, row) in {"p1": (4, 5, 1, None), "p33": (4, 5, 33, None),
                                    "one_row": (4, 5, P, 37),
                                    "one_row_max_p": (2, 3, rk.MAX_P, 0)}.items():
        pts = (torch.randn((Bn, Qn, Pn, 2), generator=g) * 5.0).to(dev)
        idx = (torch.randint(0, Pn, (Bn, Qn, Pn), generator=g) if row is None
               else torch.full((Bn, Qn, Pn), row)).to(torch.int32).to(dev)
        dist = (torch.rand((Bn, Qn, Pn), generator=g) * 1.5 + 0.5).to(dev)
        gout = torch.randn((Bn, Qn, Pn), generator=g).to(dev)
        got = rk.rigid_bwd(pts, idx, dist, gout)
        again = rk.rigid_bwd(pts, idx, dist, gout)
        ref = rk.rigid_bwd_ref(pts, idx, dist, gout)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        log(f"rigid_bwd [{name}: B={Bn}, Q={Qn}, P={Pn}]: max abs err {err:.3e} (rtol 1e-4, "
            f"atol 1e-5; max |plain| {float(ref.abs().max()):.3g}); repeated launch "
            f"bit-identical: {bool(torch.equal(got, again))}")
        check(bool(((got - ref).abs() <= 1e-4 * ref.abs() + 1e-5).all()),
              f"rigid_bwd ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"rigid_bwd ({name}) differs between two launches")
        # one point can only route to itself: p a - a p, zero up to rounding
        check(Pn == 1 or float(ref.abs().max()) > 0.0, "rigid_bwd fixture routes nothing")
        if row is not None:
            check(not bool(torch.cat([got[:, :, :row], got[:, :, row + 1:]], 2).any()),
                  f"rigid_bwd ({name}) routes to a row other than {row}")
        worst["rigid_bwd"] = max(worst["rigid_bwd"], err)

    d2, on, pts, gout, dist, idx = full
    ms = {
        "rigid_min": cuda_ms(lambda: rk.rigid_min(d2, on), 200),
        "rigid_min_fused": cuda_ms(lambda: rk.rigid_min_fused(d2, on), 200),
        "rigid_bwd": cuda_ms(lambda: rk.rigid_bwd(pts, idx, dist, gout), 200),
    }
    plain_min = cuda_ms(lambda: rk.rigid_min_ref(d2, on), 5)
    plain_bwd = cuda_ms(lambda: rk.rigid_bwd_ref(pts, idx, dist, gout), 5)
    # the closed loop's batch, for the schedule comparison
    d2s, ons = d2[:CL_B].contiguous(), on[:CL_B].contiguous()
    # device time from a CUDA graph, at both batch sizes: which schedule the card prefers
    gms = {
        "rigid_min": graph_ms(lambda: rk.rigid_min(d2, on)),
        "rigid_min_fused": graph_ms(lambda: rk.rigid_min_fused(d2, on)),
        "rigid_bwd": graph_ms(lambda: rk.rigid_bwd(pts, idx, dist, gout)),
    }
    gms32 = {k: graph_ms(lambda: getattr(rk, k)(d2s, ons))
             for k in ("rigid_min", "rigid_min_fused")}
    bwd32 = [t[:CL_B].contiguous() for t in (pts, idx, dist, gout)]
    gms32["rigid_bwd"] = graph_ms(lambda: rk.rigid_bwd(*bwd32))
    min_attrs = {k: rk.rigid_min_attributes(k) for k in ("rigid_min", "rigid_min_fused")}
    for k, a in min_attrs.items():
        log(f"{k}_kernel: {a['registers']} registers, {a['local_bytes']} bytes of local memory "
            f"per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    bwd_attrs = {Pn: rk.rigid_bwd_attributes(Pn) for Pn in (1, 33, P, rk.MAX_P)}
    for Pn, a in bwd_attrs.items():
        log(f"rigid_bwd_kernel P={Pn}: {a['registers']} registers, {a['local_bytes']} bytes of "
            f"local memory per thread{' (spills: reported, not failed)' if a['local_bytes'] else ''}")
    log(f"rigid kernels at B={B}, back to back from Python: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; plain min {plain_min:.3f} ms, plain bwd {plain_bwd:.3f} ms")
    log(f"rigid kernels from a CUDA graph: at B={B} "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in gms.items()) + f"; at B={CL_B} "
        + ", ".join(f"{k} {v:.5f} ms" for k, v in gms32.items()))
    # bytes: every input read once, every output written once; operations: the
    # min's one compare and one select per (b, q, i, j); the backward's division,
    # two products and three sums per column and two products and two
    # differences per row
    n = B * T * P
    min_b, min_by = bound(4 * B * P * P + n + 8 * n, 2.0 * n * P)
    bwd_b, bwd_by = bound(8 * n + 3 * 4 * n + 8 * n, 10.0 * n)
    n32 = CL_B * T * P
    min32_b = bound(4 * CL_B * P * P + n32 + 8 * n32, 2.0 * n32 * P)[0]
    log(f"rigid min from a graph: bound {min_b:.5f} ms at B={B} ({min_by}), {min32_b:.5f} at "
        f"B={CL_B}")
    for k in ("rigid_min", "rigid_min_fused"):
        report[k] = dict(max_abs_err=worst[k], ms=ms[k], plain_ms=plain_min, bound_ms=min_b,
                         bound_by=min_by, library_ms=None, graph_ms=gms[k],
                         graph_ms_at_b32=gms32[k], bound_ms_at_b32=min32_b,
                         attributes=min_attrs[k])
    bwd32_b = bound(8 * n32 + 3 * 4 * n32 + 8 * n32, 10.0 * n32)[0]
    log(f"rigid_bwd from a graph: {gms['rigid_bwd']:.5f} ms at B={B} (bound {bwd_b:.5f}), "
        f"{gms32['rigid_bwd']:.5f} at B={CL_B} (bound {bwd32_b:.5f})")
    report["rigid_bwd"] = dict(max_abs_err=worst["rigid_bwd"], ms=ms["rigid_bwd"],
                               plain_ms=plain_bwd, bound_ms=bwd_b, bound_by=bwd_by,
                               library_ms=None, graph_ms=gms["rigid_bwd"],
                               graph_ms_at_b32=gms32["rigid_bwd"], bound_ms_at_b32=bwd32_b,
                               attributes={str(k): v for k, v in bwd_attrs.items()})


RIGID_SPECS = {"rigid_kernel": dict(min_dist_impl="rigid_kernel"),
               "fused": dict(min_dist_impl="rigid", min_fwd_impl="fused")}


def run_rigid_paths(models, batch, report):
    """The full-width guided call with the rigid map-distance kernels:
    "rigid_kernel" (forward and backward kernels), then "rigid" + "fused"
    (the fused forward kernel, plain routing backward). Counts exact."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native

    g = torch.Generator(device=batch.image.device)
    n = N_STEPS - 1
    base = dict(lstm2_fwd=N_STEPS, lstm2_bwd=n, bit_gather=n, offroad_count=1)
    wants = {"rigid_kernel": counts(rigid_min=n, rigid_bwd=n, **base),
             "fused": counts(rigid_min_fused=n, **base)}
    for name, kw in RIGID_SPECS.items():
        specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, **kw)
        native.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.guided_collect(models, batch, guided=True, specs=specs,
                                      agents_per_scene=AGENTS_PER_SCENE,
                                      generator=g.manual_seed(10))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = native.launch_counts()
        log(f"guided pipeline, {name} ({secs:.2f} s, {B * N_STEPS / secs:.1f} NFE/s; the "
            f"separable call: {report['pipeline']['guided_nfe_per_s']:.1f} NFE/s): "
            f"launches {launches}, reward {float(out['reward']):.4f}")
        check(launches == wants[name], f"{name} launches {launches}, expected {wants[name]}")
        for k in ("pred_traj", "traj", "reward_per_agent"):
            check(bool(torch.isfinite(out[k]).all()), f"{name} guided output {k} is not finite")
        check(tuple(out["traj"].shape) == (B, 1, T, 6), f"traj shape {tuple(out['traj'].shape)}")
        report[f"launches_{name}"] = launches
        report["pipeline"][f"{name}_guided_s"] = secs
        report["pipeline"][f"{name}_guided_nfe_per_s"] = B * N_STEPS / secs


def check_rigid_agreement(models, batch, dev, report):
    """One guidance gradient at full width under "rigid_kernel", "rigid" +
    "fused" and "separable", on the decoded trajectories shifted sideways to
    the road's edge (`road_edge_shift`), so that the map loss has work. The
    first two share the tie rule (the lowest
    on-road row takes a tied column's cotangent): |a - b| <= 1e-4 |b| + 1e-6
    max |b|. "separable" splits ties, so only its loss value is held (1e-5
    relative); the gradients' largest difference is printed."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance import perturbation as gp

    g = torch.Generator().manual_seed(15)
    aux = models.context(batch)
    wfa, si = pipeline.scene_world_poses(B, AGENTS_PER_SCENE, dev)
    ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
        batch.drivable_map, batch.raster_from_agent, batch.extent, batch.curr_speed, wfa, si)))

    side = road_edge_shift(g, B).to(dev)

    def decode_fn(v):
        acts = pipeline.decode_actions(models.decoder, v, aux["cond_feat"])
        return pipeline.convert_action_to_state_and_action(
            acts, aux["curr_states"], models.dyn, pipeline.TrajNormalizer(),
            descaled_output=True)[:, None] + side

    z = torch.randn((B, T, L), generator=g).to(dev)
    grads, totals = {}, {}
    for name, kw in {**RIGID_SPECS, "separable": {}}.items():
        specs = pipeline.flagship_guidance_specs(AGENTS_PER_SCENE, **kw)
        grads[name] = gp.guidance_gradient(z, ctx, specs, decode_fn)
        with torch.no_grad():
            totals[name] = float(gp.compute_guidance_loss(decode_fn(z), ctx, specs[1:])[0])
    torch.cuda.synchronize()
    a, b = grads["rigid_kernel"], grads["fused"]
    gmax = float(b.abs().max())
    err = float((a - b).abs().max())
    log(f"guidance gradient at B={B}: rigid_kernel vs rigid+fused max abs diff {err:.3e} "
        f"(rtol 1e-4, floor 1e-6 of max |g| {gmax:.3e}); vs separable "
        f"{float((a - grads['separable']).abs().max()):.3e} (printed only: other tie rule)")
    check(gmax > 0.0 and totals["separable"] > 0.0, "the map guidance is idle on this batch")
    check(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-6 * gmax).all()),
          "rigid_kernel and rigid+fused guidance gradients disagree")
    for name in RIGID_SPECS:
        rel = abs(totals[name] - totals["separable"]) / totals["separable"]
        log(f"map loss value, {name} vs separable: {totals[name]:.6f} vs "
            f"{totals['separable']:.6f} (rel diff {rel:.2e}, tolerance 1e-5)")
        check(rel <= 1e-5, f"{name} map loss value differs from separable's")
    report["rigid_agreement"] = dict(
        kernel_vs_fused_grad=err, kernel_vs_separable_grad=float(
            (a - grads["separable"]).abs().max()), max_grad=gmax, map_loss=totals)


def run_rigid_replan(models, pack, report):
    """One closed-loop replan (4 x 8 agents) with "rigid_kernel" specs:
    exact launch counts and a finite plan."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native

    dev = pack.init_states.device
    obs = offroad_observation(pack, torch.Generator().manual_seed(9))
    gen = torch.Generator(device=dev)
    plans = {}
    for name in ("separable", "rigid_kernel"):
        policy = pipeline.make_dm_policy(models, CL_AGENTS, specs=pipeline.flagship_guidance_specs(
            CL_AGENTS, min_dist_impl=name))
        native.reset_launch_counts()
        plans[name] = policy(obs, gen.manual_seed(22)).controls
        torch.cuda.synchronize()
        launches = native.launch_counts()
    n = N_STEPS - 1
    want = counts(lstm2_fwd=N_STEPS, lstm2_bwd=n, bit_gather=n, rigid_min=n, rigid_bwd=n)
    diff = float((plans["rigid_kernel"] - plans["separable"]).abs().max())
    log(f"rigid replan: launches {launches}; plan vs the separable plan max abs diff {diff:.3e} "
        "(printed only: other tie rule)")
    check(launches == want, f"rigid replan launches {launches}, expected {want}")
    check(bool(torch.isfinite(plans["rigid_kernel"]).all()), "rigid replan's plan is not finite")
    check(tuple(plans["rigid_kernel"].shape) == (CL_B, T, 2), "rigid replan's plan shape")
    report["launches_rigid_replan"] = launches


def check_small_closed_loop(dev, report):
    """A small closed loop (2 x 3 agents, raster 64, 10 DDPM steps, 10
    frames) on the card and on the CPU, same weights and noise. The card
    takes the banded warp and the CPU the exact one, so the pack's map
    layers are first rounded to multiples of 1/255, where the two warps
    agree. Held as the small slice is: |card - cpu| <= 1e-4 |cpu| + 1e-6
    max |cpu| on the trajectory log; the accumulators' frame counts equal."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    S, A, steps, frames = 2, 3, 10, 10
    cfg = env.SimConfig(num_simulation_steps=frames, n_step_action=5, raster_size=64)
    g = torch.Generator().manual_seed(13)
    noises = [{"x_init": torch.randn((S * A, T, L), generator=g),
               "step_noises": torch.randn((steps, S * A, T, L), generator=g)}
              for _ in range(cfg.num_replans)]
    res = {}
    for where in ("cpu", dev):
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=steps)
        pack = synthetic_scene_pack(seed=3, num_scenes=S, agents_per_scene=A, world_map_size=256,
                                    sim_steps=frames, device=where)
        pack = pack._replace(world_map=torch.round(pack.world_map * 255.0) * (1.0 / 255.0))
        native.reset_launch_counts()
        state, traj = env.simulate(
            pack, pipeline.make_dm_policy(m, A), cfg,
            replan_noises=[{k: v.to(where) for k, v in n.items()} for n in noises])
        res[str(where)] = (state, traj.cpu(), native.launch_counts())
    (c_state, c_traj, c_launch), (g_state, g_traj, g_launch) = res["cpu"], res[str(dev)]
    n = cfg.num_replans
    want = counts(lstm2_fwd=steps * n, lstm2_bwd=(steps - 1) * n, bit_gather=(steps - 1) * n,
                  value_gather=n)
    check(g_launch == want, f"small closed loop launches {g_launch}, expected {want}")
    check(c_launch == {k: 0 for k in want}, f"the CPU run counted launches: {c_launch}")
    err = float((g_traj - c_traj).abs().max())
    tol = SLICE_RTOL * c_traj.abs() + 1e-6 * float(c_traj.abs().max())
    log(f"small closed loop trajectory log: card vs CPU max abs diff {err:.3e} "
        f"(rtol {SLICE_RTOL:.0e}, floor 1e-06 of max {float(c_traj.abs().max()):.3g})")
    check(bool(((g_traj - c_traj).abs() <= tol).all()),
          "small closed loop disagrees between card and CPU")
    for name in ("offroad_steps", "collision_steps", "collision_type_steps"):
        check(torch.equal(getattr(g_state, name).cpu(), getattr(c_state, name)),
              f"small closed loop {name} differ between card and CPU")
    report["small_closed_loop"] = dict(traj=err)


# the rules path: --guidance configs and --heuristics that, together,
# instantiate every one of the 15 rule classes (the agent-indexed ones by
# config, since the heuristics' pair and group pickers may find none)
RULE_CONFIGS = json.dumps([
    {"name": "acc_limit", "params": {"acc_limit": 2.0}, "weight": 1.0},
    {"name": "keep_distance", "weight": 1.0,
     "params": {"target_ind": 0, "ref_ind": 1, "min_distance": 4.0, "max_distance": 12.0}},
    {"name": "collision_attack", "weight": 1.0,
     "params": {"attacker_ind": 2, "victim_ind": 3, "time_lo": 5, "time_hi": 40}},
    {"name": "social_group", "params": {"group": [4, 5]}, "weight": 1.0},
])
RULE_HEURISTICS = ("target_speed,agent_collision,map_collision,speed_limit,lane_following,"
                   "global_target_pos,stop_sign,social_group,target_pos,target_pos_at_time,"
                   "global_target_pos_at_time,global_stop_sign,gptcollision,gptkeepdistance")
RULE_CLASSES = 15
RULES_STEPS = 20  # frames of the rules path: 4 replans


def rules_argv(scenes, agents, frames, raster, steps, device, output):
    return ["--num-scenes", str(scenes), "--agents-per-scene", str(agents),
            "--num-sim-steps", str(frames), "--raster-size", str(raster),
            "--diffusion-steps", str(steps), "--device", str(device), "--output", str(output),
            "--editing-source", "config,heuristic", "--guidance", RULE_CONFIGS,
            "--heuristics", RULE_HEURISTICS]


def run_rules_path(report):
    """The guidance rule library through the rollout CLI at the closed
    loop's width (4 scenes x 8 agents, raster 224, 100 DDPM steps), cut to
    20 frames (4 replans), with `--editing-source config,heuristic`: every
    rule class at least once; launch counts zeroed before and read after,
    exact (per replan 100 `lstm2_fwd`, 99 `lstm2_bwd`, 99 `bit_gather` for
    the one map-collision rule, 1 `value_gather`; 1 more `bit_gather` for the
    map-collision rule of the satisfaction report); a finite trajectory log
    and a finite satisfaction report."""
    import numpy as np

    from cld_tpu_torch import rollout
    from cld_tpu_torch.ops import native

    out = ROOT / "chiprun_out" / "rules_rollout"
    native.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rollout.main(rules_argv(CL_SCENES, CL_AGENTS, RULES_STEPS, RASTER, N_STEPS, "cuda",
                                  out))
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = RULES_STEPS // CL_N_STEP
    episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    want = cli_launches(episode, bit_gather=1)  # the report's map rule
    classes = sorted(set(rep["rules"]))
    log(f"rules path ({CL_SCENES} x {CL_AGENTS} agents, {RULES_STEPS} frames, {n} replans, "
        f"{wall:.1f} s with the set-up): {len(rep['rules'])} rules of {len(classes)} classes; "
        f"launches {launches} (episode {rep['launches']})")
    log(f"guidance satisfaction: {json.dumps(rep['guidance_satisfaction'])}")
    check(len(classes) == RULE_CLASSES, f"the rules path built {classes}, not all 15 classes")
    check(rep["launches"] == episode, f"rules path episode launches {rep['launches']}, "
          f"expected {episode}")
    check(launches == want, f"rules path launches {launches}, expected {want}")
    with np.load(out / "trajectories.npz") as f:
        traj = f["trajectories"]
    check(traj.shape == (RULES_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
          "the rules path's trajectory log is not finite or has the wrong shape")
    check(all(np.isfinite(v) for v in rep["guidance_satisfaction"].values()),
          "the guidance-satisfaction report is not finite")
    report["launches_rules"] = launches
    report["rules"] = dict(wall_s=wall, rules=rep["rules"], agent_steps_per_sec=rep[
        "agent_steps_per_sec"], satisfaction=rep["guidance_satisfaction"])


def check_rules_replan(dev, report):
    """One guided replan's guidance gradient under every rule class, on the
    card and on the CPU, at a small size (2 scenes x 4 agents, raster 64,
    the rules path's configs and heuristics on the first observation), same
    weights and latent; the pack's maps rounded to multiples of 1/255 (where
    the card's banded warp and the CPU's exact one agree). The total loss
    must be finite and equal within 1e-5 relative; the gradient within
    |card - cpu| <= 1e-4 |cpu| + 1e-5 max |cpu| (Adam's sign amplifies
    differences of the latents, not of the gradient)."""
    import torch

    from cld_tpu_torch import pipeline, rollout
    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.guidance.perturbation import compute_guidance_loss, guidance_gradient
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import synthetic_scene_pack

    S, A, R = 2, 4, 64
    argv = rules_argv(S, A, 10, R, 10, "cpu", ROOT / "chiprun_out" / "rules_small")
    g = torch.Generator().manual_seed(17)
    z = torch.randn((S * A, T, L), generator=g)
    res = {}
    for where in ("cpu", dev):
        args = rollout.parse_args(argv)
        hist = rollout.experiment_config(args).algo.history_num_frames
        cfg = env.SimConfig(num_simulation_steps=10, n_step_action=5, hist_frames=hist,
                            raster_size=R)
        pack = synthetic_scene_pack(seed=3, num_scenes=S, agents_per_scene=A,
                                    world_map_size=256, sim_steps=10, device=where)
        pack = pack._replace(world_map=torch.round(pack.world_map * 255.0) * (1.0 / 255.0))
        specs = rollout.build_guidance_specs(args, pack, cfg, pack.num_agents)
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=10,
                                  raster_channels=hist + 1 + pack.world_map.shape[-1])
        obs = env.render_observation(pack, env.init_sim_state(pack, cfg), cfg)
        aux = m.context(obs)
        ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
            obs.drivable_map, obs.raster_from_agent, obs.extent, obs.curr_speed,
            obs.world_from_agent, obs.scene_index,
            **pipeline.observation_context_fields(obs))), with_d2=False)

        def decode_fn(v):
            acts = pipeline.decode_actions(m.decoder, v, aux["cond_feat"])
            return pipeline.convert_action_to_state_and_action(
                acts, aux["curr_states"], m.dyn, pipeline.TrajNormalizer(),
                descaled_output=True)[:, None]

        zz = z.to(where)
        with torch.no_grad():
            total, _ = compute_guidance_loss(decode_fn(zz), ctx, specs)
        grad = guidance_gradient(zz, ctx, specs, decode_fn)
        res[str(where)] = (float(total), grad.cpu(), len({type(s.loss) for s in specs}))
    (c_loss, c_grad, c_n), (g_loss, g_grad, g_n) = res["cpu"], res[str(dev)]
    err = float((g_grad - c_grad).abs().max())
    scale = float(c_grad.abs().max())
    log(f"rules replan ({S} x {A} agents, {c_n} rule classes): loss card {g_loss:.6g}, CPU "
        f"{c_loss:.6g}; guidance gradient card vs CPU max abs diff {err:.3e} (max |cpu| "
        f"{scale:.3g})")
    check(c_n == RULE_CLASSES and g_n == RULE_CLASSES, f"the small rules replan built {c_n} "
          "rule classes")
    check(all(map(lambda v: v == v and abs(v) < float("inf"), (c_loss, g_loss))),
          "the rules replan's guidance loss is not finite")
    check(bool(torch.isfinite(g_grad).all()) and bool(torch.isfinite(c_grad).all()),
          "the rules replan's guidance gradient is not finite")
    check(abs(g_loss - c_loss) <= 1e-5 * abs(c_loss), "the rules replan's loss differs between "
          "card and CPU")
    check(bool(((g_grad - c_grad).abs() <= 1e-4 * c_grad.abs() + 1e-5 * scale).all()),
          "the rules replan's guidance gradient differs between card and CPU")
    report["rules_replan"] = dict(loss_cpu=c_loss, loss_card=g_loss, grad_err=err,
                                  grad_max=scale)


CKPT_STEPS = 20  # frames of the checkpoint path's rollouts: 4 replans


def ckpt_rollout_argv(vae, dm, output):
    return ["--registered-name", "cld_dm_nusc", "--vae-ckpt", str(vae), "--dm-ckpt", str(dm),
            "--num-scenes", str(CL_SCENES), "--agents-per-scene", str(CL_AGENTS),
            "--num-sim-steps", str(CKPT_STEPS), "--cle-report", "--guidance", "flagship",
            "--device", "cuda", "--output", str(output)]


def first_plan(run, models=None):
    """The first replan's plan (the kept sample's [Na, T, 2] controls) of the
    CLI's policy, or of the same policy over other `models`, drawn from a
    generator seeded as the CLI seeds its own."""
    import torch

    from cld_tpu_torch import pipeline
    from cld_tpu_torch.sim import env

    policy = run.policy if models is None else pipeline.make_dm_policy(
        models, CL_AGENTS, guided=True, specs=run.specs, options=run.options)
    obs = env.render_observation(run.pack, env.init_sim_state(run.pack, run.sim_cfg),
                                 run.sim_cfg, world_q8=env.quantize_world_maps_q8(
                                     run.pack.world_map))
    return policy(obs, torch.Generator(device=run.device).manual_seed(0)).controls


def run_checkpoint_path(report):
    """Train, roll out and evaluate: the trainers' `ckpt_final` files through
    the rollout CLI and `--mode test`, and the same weights as a
    Lightning-style file (see step 18 of the module's docstring)."""
    import numpy as np
    import torch

    from cld_tpu_torch import pipeline, rollout, train
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.utils.torch_import import submap

    t_phase = time.perf_counter()
    out = ROOT / "chiprun_out" / "ckpt_path"
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps({"train": {"training": {"steps_per_epoch": 1}}}))
    base = ["--registered-name", "cld_vae_nusc", "--config", str(out / "config.json"),
            "--device", "cuda", "--output", str(out / "runs"), "--steps", "2"]
    vae_ckpt, dm_ckpt = out / "runs" / "vae" / "ckpt_final", out / "runs" / "dm" / "ckpt_final"
    native.reset_launch_counts()
    vae_state = train.main(base + ["--mode", "vae"])
    dm_state = train.main(base + ["--mode", "dm", "--vae-ckpt", str(vae_ckpt)])
    train_launches = native.launch_counts()
    check(train_launches == counts(), f"checkpoint training launches {train_launches}")
    check(vae_state.step == 2 and dm_state.step == 2, "the trainers did not take 2 steps")

    # (b) the trainers' checkpoints through the rollout CLI
    argv = ckpt_rollout_argv(vae_ckpt, dm_ckpt, out / "rollout")
    run = rollout.build(rollout.parse_args(argv))
    check(run.sim_cfg.raster_size == RASTER and run.models.schedule.n_timesteps == N_STEPS,
          "the checkpoint path is not at the config of record's raster and steps")
    direct = pipeline.build_models_from_config(run.cfg, device=run.device, seed=0)
    direct.context.load_state_dict(submap(vae_state.model.state_dict(), "context_encoder"))
    direct.decoder.load_state_dict(submap(vae_state.model.state_dict(), "lstmvae.lstm_dec"))
    direct.unet.load_state_dict(dm_state.model.state_dict())
    fresh = pipeline.build_models_from_config(run.cfg, device=run.device, seed=0)
    check(any(not torch.equal(a, b) for a, b in zip(fresh.unet.state_dict().values(),
                                                   run.models.unet.state_dict().values())),
          "the CLI's denoiser holds the random initial weights, not the trained ones")
    plan = first_plan(run)
    plan_direct = first_plan(run, direct)
    check(tuple(plan.shape) == (CL_B, T, 2) and bool(torch.isfinite(plan).all()),
          "the checkpoint path's first plan is not finite [Na, T, 2]")
    check(torch.equal(plan, plan_direct), "the CLI's first plan differs from the plan of the "
          "models loaded straight from the trainers' state dicts")
    del direct, fresh
    native.reset_launch_counts()
    t0 = time.perf_counter()
    rep = rollout.main(argv)
    wall = time.perf_counter() - t0
    launches = native.launch_counts()
    n = CKPT_STEPS // CL_N_STEP
    episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                     bit_gather=(N_STEPS - 1) * n, value_gather=n)
    want = cli_launches(episode, bit_gather=1)  # the report's map rule
    check(rep["launches"] == episode, f"checkpoint rollout episode launches {rep['launches']}, "
          f"expected {episode}")
    check(launches == want, f"checkpoint rollout launches {launches}, expected {want}")
    numbers = [v for k, v in rep.items() if isinstance(v, (int, float))]
    numbers += [v for sub in rep["cle"].values() if isinstance(sub, dict) for v in sub.values()]
    numbers += list(rep["guidance_satisfaction"].values())
    check(all(np.isfinite(v) for v in numbers) and "occupancy_coverage" in rep,
          "the checkpoint rollout's report is not finite")
    with np.load(out / "rollout" / "trajectories.npz") as f:
        traj = f["trajectories"]
    check(traj.shape == (CKPT_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
          "the checkpoint rollout's trajectory log is not finite")
    # the eval layer's host time on this log: the occupancy report and the CLE summary
    from cld_tpu_torch.eval.cle import cle_report

    log_t = torch.from_numpy(traj).to(run.device)
    eval_layer_s = {}
    for name, fn in (("occupancy_report", lambda: rollout.occupancy_report(run.pack, log_t)),
                     ("cle_report", lambda: cle_report(run.pack, log_t, run.sim_cfg))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        eval_layer_s[name] = (time.perf_counter() - t0) / 5
    log(f"eval layer on the rollout's log ({CKPT_STEPS} frames x {CL_B} agents, host s per call, "
        f"mean of 5): {json.dumps(eval_layer_s)} on {report['card']}")
    del run
    log(f"checkpoint rollout ({CL_SCENES} x {CL_AGENTS} agents, {CKPT_STEPS} frames, {n} "
        f"replans): {rep['agent_steps_per_sec']:.2f} agent-steps/s ({rep['wall_clock_s']:.2f} s "
        f"the episode, {wall:.1f} s with the set-up and reports) on {report['card']}; metrics "
        f"{json.dumps({k: rep[k] for k in ('offroad_rate', 'collision_rate')})}, occupancy "
        f"{rep['occupancy_coverage']:.4f}, cle {json.dumps(rep['cle'])}; launches {launches}")

    # (c) the same weights as a Lightning-style file
    light = out / "reference.ckpt"
    sd = {f"vae.{k}": v for k, v in vae_state.model.state_dict().items()}
    sd.update({f"dm.model.{k}": v for k, v in dm_state.model.state_dict().items()})
    torch.save({"state_dict": sd, "epoch": 0, "global_step": 2}, light)
    largv = ckpt_rollout_argv(light, light, out / "rollout_lightning")
    check(torch.equal(first_plan(rollout.build(rollout.parse_args(largv))), plan),
          "the Lightning file's first plan differs from the trainers' checkpoints'")
    native.reset_launch_counts()
    rollout.main(largv)
    check(native.launch_counts() == want, "the Lightning rollout's launches differ")
    with np.load(out / "rollout_lightning" / "trajectories.npz") as f:
        check(np.array_equal(f["trajectories"], traj),
              "the Lightning file's trajectory log differs from the checkpoints'")
    log("Lightning-style .ckpt: the same first plan and trajectory log, bit for bit")

    # (d) --mode test on the checkpoints
    native.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.main(["--registered-name", "cld_dm_nusc", "--mode", "test", "--steps", "2",
                      "--vae-ckpt", str(vae_ckpt), "--dm-ckpt", str(dm_ckpt), "--device", "cuda",
                      "--output", str(out / "runs")])
    eval_s = time.perf_counter() - t0
    eval_launches = native.launch_counts()
    check(eval_launches == counts(lstm2_fwd=2), f"--mode test launches {eval_launches}, "
          "expected 2 lstm2_fwd")
    check(all(np.isfinite(v) for v in res.values()) and "realism_deviation" in res,
          f"--mode test result is not finite: {res}")
    # the report directory keeps the small outputs only: the checkpoints hold ~0.4 GB with
    # their optimizer states
    shutil.rmtree(out / "runs")
    light.unlink()
    secs = time.perf_counter() - t_phase
    log(f"--mode test (2 batches of 128): {json.dumps(res)} in {eval_s:.1f} s; checkpoint "
        f"phase {secs:.1f} s in all, on {report['card']}")
    report["launches_checkpoint_rollout"] = launches
    report["launches_evaluate"] = eval_launches
    report["checkpoint_path"] = dict(
        phase_s=secs, rollout_wall_clock_s=rep["wall_clock_s"],
        rollout_agent_steps_per_sec=rep["agent_steps_per_sec"], eval_s=eval_s,
        eval_layer_s=eval_layer_s,
        evaluate=res, occupancy={k: rep[k] for k in ("occupancy_coverage",
                                                     "offroad_occupancy_fraction",
                                                     "occupied_cells")},
        cle=rep["cle"])


DATA_BATCHES, DATA_BATCH = 2, 32  # shards of the data path: 64 samples at raster 224
DATA_STEPS = 20  # frames of the scene-data rollouts: 4 replans
MODEL_FREE = ("gt_replay", "lattice", "mpc", "contingency")
OCC_THRESH = 0.1  # occupancy_metrics' occupied_thresh


def planner_observation(Bn, dev):
    """The model-free planners' card-vs-CPU fixture: a synthetic batch at
    raster 224 with its road and lanes shifted 1.5 m to +y (3 pixel rows),
    so that the ego is off the road's center line and mirror-image
    candidates do not tie (as in `tests/test_torch_planners.py`)."""
    import torch

    from cld_tpu_torch.data.synthetic import synthetic_batch

    b = synthetic_batch(seed=5, batch_size=Bn, raster_size=RASTER, device="cpu")
    hist = b.history_positions.shape[1]
    image = b.image.clone()
    image[..., hist:] = torch.roll(image[..., hist:], 3, dims=1)
    lanes = b.lane_points.clone()
    lanes[..., 1] += 1.5
    b = b._replace(image=image, drivable_map=torch.roll(b.drivable_map, 3, dims=1),
                   lane_points=lanes)
    return b._replace(**{k: v.to(dev) for k, v in b._asdict().items() if torch.is_tensor(v)})


def check_planners_card_vs_cpu() -> dict:
    """One MPC and one contingency replan of `CL_B` agents on
    `planner_observation`, card against CPU. Both planners amplify
    last-bit differences by design, so each is held where it is continuous:
    float32 against float64 on the CPU already moves 14 of 32 agents' MPC
    controls by > 1e-3 after the record's 100 Adam iterations at a fixed
    rate (0.78 at most; 2.5e-4 after 20), and each agent's final FTOCP
    cost by 4.2e-2 of itself at most; and it picks another contingency
    branch for 5 agents (progress saturates, so branches tie to the last
    bits). Held: the MPC's controls after 20 iterations within 1e-3, and
    at the record's 100 iterations (`--policy mpc`) each agent's final cost
    within `MPC_COST_RTOL` of the CPU's (the controls' difference is
    reported; 20, 50 or 90 iterations, or a rate of 0.1 or 0.25, move
    8-22 agents' costs by more than 0.1 on the CPU); the contingency
    planner, on the fixture with every pixel drivable (the off-road cost is
    a pixel indicator), its root costs within 1e-4 of their largest
    magnitude, and the branch the card picks optimal within that under the CPU's costs;
    where both pick the same leaf, the plans within 1e-4 m."""
    import torch

    from cld_tpu_torch.policies import contingency, mpc

    out = {}
    for where in ("cpu", "cuda"):
        obs = planner_observation(CL_B, where)
        sols = {it: mpc.solve_from_observation(mpc.MPCConfig(iters=it), obs) for it in (20, 100)}
        ctrl = {it: torch.cat([sol["u0"][:, None], sol["ubr"][:, 0]], dim=1).cpu()
                for it, sol in sols.items()}
        ctrl["cost"] = sols[100]["cost"].cpu()
        plan = contingency.plan_from_observation(contingency.ContingencyConfig(), obs._replace(
            drivable_map=torch.ones_like(obs.drivable_map)))
        out[where] = (ctrl, {k: plan[k].cpu() for k in ("branch", "leaf", "plan", "root_cost")})
    (c_ctrl, c_plan), (g_ctrl, g_plan) = out["cpu"], out["cuda"]
    err20 = float((g_ctrl[20] - c_ctrl[20]).abs().max())
    err100 = (g_ctrl[100] - c_ctrl[100]).abs().amax(dim=(1, 2))
    cost_rel = float(((g_ctrl["cost"] - c_ctrl["cost"]).abs() / c_ctrl["cost"].abs()).max())
    log(f"one mpc replan ({CL_B} agents), controls card vs CPU: 20 iterations max |diff| "
        f"{err20:.3e} (tolerance 1e-3); the record's 100: final cost max relative |diff| "
        f"{cost_rel:.3e} (tolerance {MPC_COST_RTOL:g}), controls {float(err100.max()):.3e}, "
        f"{int((err100 > 1e-3).sum())} agents above 1e-3 (not held)")
    check(err20 <= 1e-3, "the mpc replan's controls differ between card and CPU")
    check(cost_rel <= MPC_COST_RTOL,
          "the mpc replan's final costs at 100 iterations differ between card and CPU")
    rc_c, rc_g = c_plan["root_cost"], g_plan["root_cost"]
    scale = float(rc_c.abs().max())
    rc_err = float((rc_g - rc_c).abs().max())
    rows = torch.arange(CL_B)
    regret = float((rc_c[rows, g_plan["branch"]] - rc_c.amin(dim=-1)).max())
    same = g_plan["leaf"] == c_plan["leaf"]
    plan_err = float((g_plan["plan"][same] - c_plan["plan"][same]).abs().max())
    log(f"one contingency replan ({CL_B} agents, every pixel drivable), card vs CPU: root costs "
        f"max |diff| {rc_err:.3e} (max |cost| {scale:.3g}), the card's branch {regret:.3e} above "
        f"the CPU's optimum, the same leaf for {int(same.sum())} agents, their plans max |diff| "
        f"{plan_err:.3e} m")
    check(rc_err <= 1e-4 * scale and regret <= 1e-4 * scale and plan_err <= 1e-4,
          "the contingency replan differs between card and CPU")
    return dict(mpc_card_vs_cpu_20=err20, mpc_card_vs_cpu_100=float(err100.max()),
                mpc_cost_rel_err_100=cost_rel,
                contingency_root_cost_err=rc_err, contingency_regret=regret,
                contingency_same_leaf=int(same.sum()), contingency_plan_err=plan_err)


def check_occupancy_twice(pack, traj, report):
    """The occupancy splat adds with atomics on the card: two runs on the
    same log give grids within rtol 1e-5 / atol 1e-7 (float32 sums in
    another order), every cell clear of the occupied threshold by more than
    that, so the metrics of the two runs are equal."""
    import torch

    from cld_tpu_torch import rollout
    from cld_tpu_torch.sim.occupancy import occupancy_init, occupancy_update

    Hw = pack.world_map.shape[1]
    worst, clear = 0.0, float("inf")
    for s in range(pack.world_map.shape[0]):
        pos = traj[:, pack.scene_index == s, :2].reshape(-1, 2)
        grids = []
        for _ in range(2):
            origin = (float(pack.map_origin[s, 0]), float(pack.map_origin[s, 1]))
            occ = occupancy_init(origin=origin, size=(Hw // 2, Hw // 2),
                                 step=2 * pack.map_resolution, sigma=1.0, device=traj.device)
            grids.append(occupancy_update(occ, pos).grid)
        a, b = grids
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-7)),
              f"scene {s}: two occupancy grids differ beyond rtol 1e-5 / atol 1e-7")
        worst = max(worst, float((a - b).abs().max()))
        clear = min(clear, float((a - OCC_THRESH).abs().min()))
    check(clear > 1e-5 * OCC_THRESH + 1e-7, f"a grid cell lies within the tolerance of the "
          f"occupied threshold ({clear:.3e}): the metrics' equality would not be meaningful")
    m1, m2 = rollout.occupancy_report(pack, traj), rollout.occupancy_report(pack, traj)
    check(m1 == m2, f"two occupancy reports of the same log differ: {m1} vs {m2}")
    log(f"occupancy grid on the card, twice on the scene-data log: max |diff| {worst:.3e}, "
        f"nearest cell to the threshold {clear:.3e} away, metrics equal {json.dumps(m1)}")
    report["occupancy_twice"] = dict(max_abs_diff=worst, clear_of_thresh=clear, metrics=m1)


def run_data_path(report):
    """The data stack and the model-free policies at full width (see step
    19 of the module's docstring). Writes the shards into a temporary
    directory outside the checkout and deletes it at the end."""
    import tempfile

    import numpy as np
    import torch

    from cld_tpu_torch import rollout, train
    from cld_tpu_torch.data import convert, packed
    from cld_tpu_torch.data.loader import make_loader
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.policies import contingency, hardcoded, mpc
    from cld_tpu_torch.sim import env
    from cld_tpu_torch.sim.scene import scene_pack_from_shards
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import config_from_flags

    t_phase = time.perf_counter()
    out = ROOT / "chiprun_out" / "data_path"
    out.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cld_shards_"))
    res = {}
    try:
        shards = tmp / "shards"
        t0 = time.perf_counter()
        convert.convert_synthetic(str(shards), DATA_BATCHES, DATA_BATCH, RASTER, 0)
        res["write_s"] = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in shards.iterdir())
        log(f"wrote {DATA_BATCHES * DATA_BATCH} synthetic samples at raster {RASTER} "
            f"({nbytes / 1e9:.3f} GB) in {res['write_s']:.1f} s")

        # (a) the loader's order: the first batch on the card is the host's, bit for bit
        cfg_file = tmp / "config.json"
        cfg_file.write_text(json.dumps({
            "train": {"data_path": str(shards), "training": {"steps_per_epoch": 1,
                                                             "batch_size": B}},
            "env": {"rasterizer": {"raster_size": RASTER}}}))
        cfg = config_from_flags("cld_vae_nusc", str(cfg_file))
        card_b = next(iter(make_loader(cfg, "train", device="cuda")))
        host_b = next(iter(make_loader(cfg, "train", device="cpu")))
        same = [k for k, v in host_b._asdict().items() if torch.is_tensor(v)]
        check(card_b.image.shape[0] == B and all(
            torch.equal(getattr(card_b, k).cpu(), getattr(host_b, k)) for k in same),
            "the loader's first batch on the card differs from the host's")
        log(f"loader: the first batch of {B} on the card equals the host's, {len(same)} fields "
            "bit for bit")
        del card_b, host_b

        # (b) the loader's time per batch of 128 (host gather, copy to the card) beside a
        # VAE step's
        ldr = packed.PackedShardLoader(str(shards), batch_size=B, device="cuda")
        rng = np.random.default_rng(1)
        trainer = VAETrainer(cfg, device="cuda")
        state = trainer.init_state(0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        gather_s, copy_s, step_s = [], [], []
        for i in range(4):
            t0 = time.perf_counter()
            raw = ldr.ds.gather(rng.integers(0, ldr.ds.num_samples, B))
            t1 = time.perf_counter()
            batch = packed.to_traffic_batch(raw, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            trainer.train_step(state, batch, generator=gen)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if i:  # the first round warms up
                gather_s.append(t1 - t0)
                copy_s.append(t2 - t1)
                step_s.append(t3 - t2)
        batch_gb = sum(v.nbytes for v in raw.values()) / 1e9
        res["loader_ms"] = dict(gather=1e3 * float(np.mean(gather_s)),
                                copy=1e3 * float(np.mean(copy_s)),
                                vae_step=1e3 * float(np.mean(step_s)), batch_gb=batch_gb)
        log(f"loader per batch of {B} ({batch_gb:.3f} GB, mean of 3): host gather "
            f"{res['loader_ms']['gather']:.1f} ms + copy to the card "
            f"{res['loader_ms']['copy']:.1f} ms, beside a VAE step's "
            f"{res['loader_ms']['vae_step']:.1f} ms, on {report['card']}")
        ldr.ds.close()
        del trainer, state, batch, raw

        # (c) train the VAE and then the DM stage from the shards, 2 steps each
        base = ["--registered-name", "cld_vae_nusc", "--config", str(cfg_file), "--device",
                "cuda", "--output", str(tmp / "runs"), "--steps", "2"]
        native.reset_launch_counts()
        t0 = time.perf_counter()
        vae_state = train.main(base + ["--mode", "vae"])
        dm_state = train.main(base + ["--mode", "dm", "--vae-ckpt",
                                      str(tmp / "runs" / "vae" / "ckpt_final")])
        res["train_s"] = time.perf_counter() - t0
        train_launches = native.launch_counts()
        check(train_launches == counts(), f"training from shards launched {train_launches}")
        check(vae_state.step == 2 and dm_state.step == 2, "the trainers did not take 2 steps")
        losses = {}
        for stage in ("vae", "dm"):
            recs = [json.loads(line) for line in
                    (tmp / "runs" / stage / "metrics.jsonl").read_text().splitlines()]
            losses[stage] = [r["train/loss"] for r in recs]
            check(len(recs) == 2 and all(np.isfinite(v) for r in recs for v in r.values()),
                  f"the {stage} stage's metrics from the shards are not finite")
        del vae_state, dm_state
        log(f"trained from the shards, 2 VAE + 2 DM steps in {res['train_s']:.1f} s: losses "
            f"{json.dumps(losses)}")
        report["launches_data_train"] = train_launches

        # (d) the guided rollout on the scene data
        n = DATA_STEPS // CL_N_STEP
        scene = ["--scene-data", str(shards), "--num-scenes", str(CL_SCENES),
                 "--agents-per-scene", str(CL_AGENTS), "--num-sim-steps", str(DATA_STEPS),
                 "--raster-size", str(RASTER), "--diffusion-steps", str(N_STEPS),
                 "--device", "cuda"]
        argv = scene + ["--policy", "dm", "--agents-policy", "gt_replay", "--guidance",
                        "flagship", "--num-action-samples", "2", "--guide-with-gt",
                        "--cle-report", "--output", str(out / "scene_rollout")]
        native.reset_launch_counts()
        t0 = time.perf_counter()
        rep = rollout.main(argv)
        wall = time.perf_counter() - t0
        launches = native.launch_counts()
        episode = counts(lstm2_fwd=N_STEPS * n, lstm2_bwd=(N_STEPS - 1) * n,
                         bit_gather=(N_STEPS - 1) * n, value_gather=n)
        want = cli_launches(episode, bit_gather=1)  # the report's map rule
        check(rep["launches"] == episode, f"scene-data rollout episode launches "
              f"{rep['launches']}, expected {episode}")
        check(launches == want, f"scene-data rollout launches {launches}, expected {want}")
        numbers = [v for v in rep.values() if isinstance(v, (int, float))]
        numbers += [v for sub in rep["cle"].values() if isinstance(sub, dict)
                    for v in sub.values()]
        numbers += list(rep["guidance_satisfaction"].values())
        check(all(np.isfinite(v) for v in numbers) and "compile_and_first_run_s" in rep,
              "the scene-data rollout's report is not finite or lacks compile_and_first_run_s")
        with np.load(out / "scene_rollout" / "trajectories.npz") as f:
            traj = f["trajectories"]
        check(traj.shape == (DATA_STEPS, CL_B, 4) and bool(np.isfinite(traj).all()),
              "the scene-data rollout's trajectory log is not finite")
        log(f"scene-data rollout (dm ego + gt_replay agents, flagship rules, 2 samples, "
            f"--guide-with-gt; {CL_SCENES} x {CL_AGENTS} agents, {DATA_STEPS} frames, {n} "
            f"replans): {rep['agent_steps_per_sec']:.2f} agent-steps/s ({rep['wall_clock_s']:.2f} "
            f"s the timed episode, {rep['compile_and_first_run_s']:.2f} s the first, {wall:.1f} s "
            f"with the set-up and reports) on {report['card']}; launches {launches}")
        report["launches_scene_data_rollout"] = launches
        res["scene_rollout"] = dict(
            wall_clock_s=rep["wall_clock_s"], agent_steps_per_sec=rep["agent_steps_per_sec"],
            compile_and_first_run_s=rep["compile_and_first_run_s"],
            metrics={k: rep[k] for k in ("offroad_rate", "collision_rate", "occupancy_coverage")})
        pack = scene_pack_from_shards(str(shards), num_scenes=CL_SCENES,
                                      agents_per_scene=CL_AGENTS, sim_steps=DATA_STEPS,
                                      device="cuda")
        check_occupancy_twice(pack, torch.from_numpy(traj).cuda(), res)

        # (e) the model-free policies at the same width: no LSTM launch, one warp a replan
        res["policies"] = {}
        for name in MODEL_FREE:
            native.reset_launch_counts()
            rep = rollout.main(scene + ["--policy", name, "--output", str(out / name)])
            launches = native.launch_counts()
            check(rep["launches"] == counts(value_gather=n) and
                  launches == cli_launches(counts(value_gather=n)),
                  f"--policy {name} launched {rep['launches']} in its timed episode, {launches} "
                  f"in all, expected {counts(value_gather=n)} per episode")
            with np.load(out / name / "trajectories.npz") as f:
                check(bool(np.isfinite(f["trajectories"]).all()),
                      f"--policy {name}'s trajectory log is not finite")
            per_replan = rep["wall_clock_s"] / n
            res["policies"][name] = dict(s_per_replan=per_replan,
                                         first_episode_s=rep["compile_and_first_run_s"],
                                         offroad_rate=rep["offroad_rate"],
                                         collision_rate=rep["collision_rate"])
            report[f"launches_{name}"] = launches
            log(f"--policy {name}: {per_replan:.3f} s per replan ({CL_B} agents, timed episode), "
                f"offroad {rep['offroad_rate']:.3f}, collision {rep['collision_rate']:.3f}")

        # (f) card against CPU: the uncontrolled replay follows the dataset, and one MPC and
        # one contingency replan agree
        sim_cfg = env.SimConfig(num_simulation_steps=DATA_STEPS, n_step_action=CL_N_STEP,
                                raster_size=RASTER)
        for where in ("cpu", "cuda"):
            p = scene_pack_from_shards(str(shards), num_scenes=CL_SCENES,
                                       agents_per_scene=CL_AGENTS, sim_steps=DATA_STEPS,
                                       controlled_mask=np.zeros(CL_B, bool), device=where)
            _, log_r = env.simulate(p, hardcoded.replay_policy(p.replay_actions), sim_cfg)
            gt = p.gt_states[:, 1:DATA_STEPS + 1].transpose(0, 1)
            err = float((log_r[..., :2] - gt[..., :2]).abs().max())
            scale = float(gt[..., :2].abs().max())
            log(f"uncontrolled gt_replay on the {where}: log vs gt_states max |diff| {err:.3e} m "
                f"(coordinates up to {scale:.1f} m; tolerance 1e-5 m)")
            check(err <= 1e-5, f"the uncontrolled replay on the {where} leaves the dataset by "
                  f"{err:.3e} m")
            res[f"replay_err_{where}"] = err
        # the planners are argmin and fixed-rate Adam: held where they are continuous (see
        # `planner_observation`)
        res.update(check_planners_card_vs_cpu())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"data path phase {res['phase_s']:.1f} s in all, on {report['card']}")
    report["data_path"] = res


def max_param_change(before, module) -> float:
    """Largest absolute change of a module's parameters since `before`."""
    return max(float((p.detach() - b).abs().max()) for p, b in zip(module.parameters(), before))


def snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def scene_pair_mask(Bn, agents_per_scene, dev):
    """[Bn, Bn] bool: pairs of different agents of one scene."""
    import torch

    scene = torch.arange(Bn, device=dev) // agents_per_scene
    return (scene[:, None] == scene[None, :]) & ~torch.eye(Bn, dtype=torch.bool, device=dev)


# P, G and B at which `offroad_count` is held, every combination: one point,
# a warp's 32 lanes, 64 and a pass of 128 (4 points a lane) and one point
# either side, the reward's 52, two passes; the reward's one group and the
# samples' several; one map, the reward's 128 and one past a block of 4 warps
OFFROAD_EDGES = dict(P=(1, 31, 32, 33, 52, 64, 65, 127, 128, 129, 200), G=(1, 3, 5),
                     B=(1, 128, 129))


def check_offroad_edges(g, dev) -> dict:
    """`offroad_count` at every combination of `OFFROAD_EDGES` on 224 x 224
    f32 maps (a fifth of them exact zeros, which count as off-road), with
    coordinates up to 8 pixels outside the map (clamped): equal to its plain
    version (tolerance 0) and to a second launch bit for bit."""
    import torch

    from cld_tpu_torch.ops import reward_kernels as rk

    R, held = RASTER, {}
    maps = torch.rand((max(OFFROAD_EDGES["B"]), R, R), generator=g) - 0.4
    maps = torch.where(maps > 0.4, torch.zeros(()), maps).to(dev)
    for Bn in OFFROAD_EDGES["B"]:
        m = maps[:Bn].contiguous()
        for Gn in OFFROAD_EDGES["G"]:
            for Pn in OFFROAD_EDGES["P"]:
                shape = (Bn, Gn, Pn) if Gn > 1 else (Bn, Pn)
                pix = torch.stack([torch.randint(-8, R + 8, shape, generator=g),
                                   torch.randint(-8, R + 8, shape, generator=g)], -1)
                pix = pix.to(torch.int32).to(dev).contiguous()
                got, again = rk.offroad_count(pix, m), rk.offroad_count(pix, m)
                want = rk.offroad_count_ref(pix, m)
                torch.cuda.synchronize()
                key = f"B={Bn},G={Gn},P={Pn}"
                held[key] = float((got - want).abs().max())
                check(torch.equal(got, want), f"offroad_count ({key}) disagrees with its plain "
                      "version")
                check(torch.equal(got, again), f"offroad_count ({key}) differs between two "
                      "launches")
    log(f"offroad_count at {len(held)} edge shapes (P {OFFROAD_EDGES['P']}, G "
        f"{OFFROAD_EDGES['G']}, B {OFFROAD_EDGES['B']}): equal to its plain version and to a "
        "second launch (tolerance 0, exact)")
    return held


def disk_fixture(g, Tn, Bn, Dn, mask, dev):
    """(centroids [Tn, Bn, Dn, 2], penalty distances [Bn, Bn], mask, decay
    [Tn]) of the disk-collision kernel: random disk centres; at Bn = B,
    scenes of 4 agents on top of each other (a scene centre 50 m scale, a
    spread of 2 m), so that same-scene pairs collide and others do not."""
    import torch

    cent = (torch.randn((Tn, Bn, Dn, 2), generator=g) * 2.0).to(dev)
    if Bn == B:
        centre = torch.randn((1, Bn // AGENTS_PER_SCENE, 1, 1, 2), generator=g) * 50.0
        spread = torch.randn((Tn, Bn // AGENTS_PER_SCENE, AGENTS_PER_SCENE, Dn, 2),
                             generator=g) * 2.0
        cent = (centre + spread).reshape(Tn, Bn, Dn, 2).to(dev).contiguous()
    rad = torch.rand((Bn,), generator=g) * 0.4 + 0.8
    pen = (rad[:, None] + rad[None, :] + 0.2).to(dev)
    decay = 0.9 ** torch.arange(Tn, dtype=torch.float32)
    return cent, pen, mask, (decay / decay.sum()).to(dev)


def check_reward_kernels(batch, dev, report):
    """`offroad_count` and `disk_collision` against their plain versions on
    the card."""
    import torch

    from cld_tpu_torch.ops import reward_kernels as rk

    g = torch.Generator().manual_seed(16)
    drv = batch.drivable_map
    Hm, W = drv.shape[-2:]
    maps = {"reward": (drv, (B, T)), "five_samples": (drv, (B, 5, T)),
            "odd": ((torch.rand((5, 64, 64), generator=g) > 0.4).float().to(dev), (5, 7)),
            "odd_groups": ((torch.rand((3, 33, 47), generator=g) - 0.4).to(dev), (3, 4, 9))}
    worst = 0.0
    for name, (m, shape) in maps.items():
        hm, w = m.shape[-2:]
        pix = torch.stack([torch.randint(0, w, shape, generator=g),
                           torch.randint(0, hm, shape, generator=g)], dim=-1)
        pix = pix.to(torch.int32).to(dev).contiguous()
        got, again, want = rk.offroad_count(pix, m), rk.offroad_count(pix, m), \
            rk.offroad_count_ref(pix, m)
        torch.cuda.synchronize()
        n_off = int(want.sum())
        log(f"offroad_count [{name}: pix {tuple(pix.shape)}, map {hm}x{w}]: equal to its plain "
            f"version: {bool(torch.equal(got, want))} (tolerance 0, exact); {n_off} of "
            f"{pix[..., 0].numel()} points off-road")
        check(torch.equal(got, want), f"offroad_count ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"offroad_count ({name}) differs between two launches")
        check(tuple(got.shape) == tuple(shape[:-1]), f"offroad_count ({name}) output shape")
        check(0 < n_off < pix[..., 0].numel(), "offroad_count fixture is degenerate")
        worst = max(worst, float((got - want).abs().max()))
        if name == "reward":
            full = (pix, m)
    held = check_offroad_edges(g, dev)
    attrs = rk.offroad_count_attributes()
    spills = " (spills: reported, not failed)" if attrs["local_bytes"] else ""
    log(f"offroad_count_kernel: {attrs['registers']} registers, {attrs['local_bytes']} bytes of "
        f"local memory per thread{spills}")
    pix, m = full
    ms = cuda_ms(lambda: rk.offroad_count(pix, m), 200)
    g_ms = graph_ms(lambda: rk.offroad_count(pix, m))
    plain_ms = cuda_ms(lambda: rk.offroad_count_ref(pix, m), 50)
    # bytes: the coordinates, the map values under them (distinct ones), one f32 per map
    flat = (torch.arange(B, device=dev)[:, None] * Hm + pix[..., 1].long()) * W + pix[..., 0].long()
    needed = 4 * int(torch.unique(flat).numel())
    b_ms, b_by = bound(8 * B * T + needed + 4 * B, float(B * T))
    log(f"offroad_count at B={B}, P={T}: {ms:.4f} ms from Python, {g_ms:.5f} ms from a CUDA "
        f"graph, plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms by {b_by} ({needed} map bytes)")
    report["offroad_count"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None, graph_ms=g_ms,
                                   source_bytes_needed=needed, held=held, attributes=attrs)

    off_diag = lambda n: ~torch.eye(n, dtype=torch.bool, device=dev)
    cases = {"ppo": (T, B, 5, scene_pair_mask(B, AGENTS_PER_SCENE, dev)),
             "all_pairs": (T, B, 5, off_diag(B)), "odd": (8, 6, 4, off_diag(6)),
             "one_disk": (3, 5, 1, off_diag(5)), "nine_disks": (6, 7, 9, off_diag(7)),
             "one_agent": (T, 1, 5, torch.ones((1, 1), dtype=torch.bool, device=dev)),
             "b33": (T, 33, 5, off_diag(33)),
             "empty_mask": (T, B, 5, torch.zeros((B, B), dtype=torch.bool, device=dev)),
             "nine_disks_ppo": (T, B, 9, scene_pair_mask(B, AGENTS_PER_SCENE, dev))}
    worst, timed = 0.0, {}
    for name, (Tn, Bn, Dn, mask) in cases.items():
        args = disk_fixture(g, Tn, Bn, Dn, mask, dev)
        got, again = rk.disk_collision_penalty(*args), rk.disk_collision_penalty(*args)
        want = rk.disk_collision_penalty_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-6).all())
        log(f"disk_collision [{name}: T={Tn}, B={Bn}, D={Dn}, {int(mask.sum())} pairs]: max abs "
            f"err {err:.3e} (rtol 1e-5, atol 1e-6; max |plain| {float(want.max()):.3g}, "
            f"{int((want > 0).sum())} agents penalized); repeated launch bit-identical: "
            f"{bool(torch.equal(got, again))}")
        check(ok, f"disk_collision ({name}) disagrees with its plain version")
        check(torch.equal(got, again), f"disk_collision ({name}) differs between two launches")
        if name == "empty_mask":
            check(float(got.abs().max()) == 0.0, "disk_collision with an empty mask is not 0")
        else:
            check(float(want.max()) > 0.0, f"disk_collision fixture ({name}) has no collision")
        worst = max(worst, err)
        timed[name] = args
        if name == "ppo":  # the runtime-D loop (what D > 8 takes) at the timed shape
            looped = rk.disk_collision_penalty(*args, unrolled=False)
            err = float((looped - want).abs().max())
            log(f"disk_collision [{name}, runtime-D loop]: max abs err {err:.3e}")
            check(bool(((looped - want).abs() <= 1e-5 * want.abs() + 1e-6).all()),
                  "disk_collision (runtime-D loop) disagrees with its plain version")
            worst = max(worst, err)
    args = timed["ppo"]
    ms = cuda_ms(lambda: rk.disk_collision_penalty(*args), 200)
    g_ms = graph_ms(lambda: rk.disk_collision_penalty(*args))
    g_all = graph_ms(lambda: rk.disk_collision_penalty(*timed["all_pairs"]))
    g_loop = graph_ms(lambda: rk.disk_collision_penalty(*args, unrolled=False))
    g_all_loop = graph_ms(lambda: rk.disk_collision_penalty(*timed["all_pairs"], unrolled=False))
    plain_ms = cuda_ms(lambda: rk.disk_collision_penalty_ref(*args), 5)
    # bytes: every input once, the output once. operations: the 25 disk pairs (2
    # subtractions, 2 products, a sum, a min) once per step and unordered pair {i, j}
    # that either direction's mask holds, since pair[t, i, j] = pair[t, j, i]; ~6 for the
    # penalty per step and ordered pair in the mask; a masked pair needs none
    D = 5
    nbytes = 4 * T * B * D * 2 + 4 * B * B + B * B + 4 * T + 4 * B

    def disk_ops(mask):
        either = mask | mask.T
        unordered = (int(either.sum()) + int(either.diagonal().sum())) // 2
        return T * (6.0 * D * D * unordered + 6.0 * int(mask.sum()))

    b_ms, b_by = bound(nbytes, disk_ops(args[2]))
    ball_ms, ball_by = bound(nbytes, disk_ops(timed["all_pairs"][2]))
    disk_attrs = {str(Dn): rk.disk_collision_attributes(Dn) for Dn in range(1, 10)}
    for Dn, a in disk_attrs.items():
        log(f"disk_collision_kernel<{Dn if Dn != '9' else '0 (runtime-D loop)'}>: "
            f"{a['registers']} registers, {a['local_bytes']} bytes of local memory per thread "
            "(spills: reported, not failed)")
    log(f"disk_collision at T={T}, B={B}, D={D}, same-scene pairs: {ms:.4f} ms from Python, "
        f"{g_ms:.5f} ms from a CUDA graph, plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by}; "
        f"every off-diagonal pair: {g_all:.5f} ms from a graph, bound {ball_ms:.6f} ms by "
        f"{ball_by}; with the runtime-D loop in place of the unrolled D x D: {g_loop:.5f} ms "
        f"and {g_all_loop:.5f} ms from a graph")
    report["disk_collision"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=None, graph_ms=g_ms,
                                    graph_ms_all_pairs=g_all, graph_ms_looped=g_loop,
                                    graph_ms_all_pairs_looped=g_all_loop,
                                    bound_ms_all_pairs=ball_ms,
                                    bound_by_all_pairs=ball_by, attributes=disk_attrs)


def record_config():
    """The config of record, with epochs of one step: the warm-up rate is 0
    for the whole first epoch, so with the record's 1,000-step epochs a short
    run would move nothing."""
    from cld_tpu_torch.utils.config import default_config

    cfg = default_config()
    cfg.train.training.steps_per_epoch = 1
    return cfg.lock()


def run_training(batch, dev, report):
    """The VAE and DM stages at full width: 2 warm-up + 5 timed train steps
    each and one eval step. Returns (config, VAE state, DM trainer, DM state)
    for the PPO phase."""
    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.vae import VAETrainer

    cfg = record_config()
    gen = torch.Generator(device=dev)
    WARM, STEPS = 2, 5

    def drive(name, state, step, evaluate, seed):
        gen.manual_seed(seed)
        before = snapshot(state.model)
        native.reset_launch_counts()
        losses = []
        for k in range(WARM + STEPS):
            if k == WARM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            _, m = step(state, batch, generator=gen)
            losses.append(m["loss"])
            check(m["skipped_nonfinite"] == 0.0, f"{name} step {k} skipped a non-finite loss")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ev = float(evaluate(state)["loss"])
        launches = native.launch_counts()
        losses = [float(v) for v in losses]
        delta = max_param_change(before, state.model)
        rate = STEPS / secs
        log(f"{name}: {rate:.2f} train steps/s ({secs / STEPS * 1e3:.1f} ms/step) at B={B}, "
            f"raster {RASTER}, on {report['card']}; losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"eval {ev:.4f}; parameters moved by up to {delta:.3e}; launches {launches}")
        check(all(v == v and abs(v) != float("inf") for v in losses + [ev]),
              f"{name}: a loss is not finite")
        check(delta > 0.0, f"{name}: no parameter moved")
        check(state.step == WARM + STEPS, f"{name}: step count {state.step}")
        return rate, launches, losses, ev

    vae_tr = VAETrainer(cfg, device=dev)
    vae_state = vae_tr.init_state(seed=0)
    rate, launches, losses, ev = drive("vae_train", vae_state, vae_tr.train_step,
                                       lambda s: vae_tr.eval_step(s, batch), 30)
    want = counts(lstm2_fwd=1)  # the eval step's deterministic decoder
    check(launches == want, f"vae_train launches {launches}, expected {want}")
    report["launches_vae_train"] = launches
    report["training"] = dict(vae_train_steps_per_sec=rate, vae_losses=losses, vae_eval_loss=ev)

    # the two LSTM stacks of a train step alone (encoder and train-mode decoder run layer by
    # layer through PyTorch's LSTM operator, cuDNN here, not through the fused kernel)
    lstmvae = vae_state.model.lstmvae
    g = torch.Generator().manual_seed(33)
    cond_dim, hid, lat = (lstmvae.lstm_enc.cond2hidden.in_features, lstmvae.hidden_size,
                          lstmvae.mu.out_features)
    x = torch.randn((B, T, 6), generator=g).to(dev)
    cond = torch.randn((B, cond_dim), generator=g).to(dev)
    noise = torch.randn((B, T, lat), generator=g).to(dev)
    masks = tuple((torch.rand((B, T, hid), generator=g) >= 0.2).float().to(dev) for _ in range(2))

    def stacks_fwd_bwd():
        acts, mu, logvar = lstmvae(x, cond, train=True, noise=noise, keep_masks=masks)
        (acts.sum() + mu.sum() + logvar.sum()).backward()

    stacks_ms = cuda_ms(stacks_fwd_bwd, 20)
    vae_state.optimizer.zero_grad(set_to_none=True)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: lstmvae.traj2z(x, cond, noise=noise), 20)
    log(f"LSTM stacks through PyTorch's LSTM operator at B={B}: encoder + train-mode decoder "
        f"forward and backward {stacks_ms:.3f} ms; encoder forward alone {enc_ms:.3f} ms")
    report["training"].update(lstm_stacks_train_fwd_bwd_ms=stacks_ms, lstm_encoder_fwd_ms=enc_ms)

    dm_tr = DMTrainer(cfg, vae_state.model, device=dev)
    dm_state = dm_tr.init_state(seed=2)
    rate, launches, losses, ev = drive(
        "dm_train", dm_state, dm_tr.train_step,
        lambda s: dm_tr.eval_step(s, batch, generator=gen), 31)
    check(launches == counts(), f"dm_train launches {launches}, expected none")
    report["launches_dm_train"] = launches
    report["training"].update(dm_train_steps_per_sec=rate, dm_losses=losses, dm_eval_loss=ev)
    return cfg, dm_tr, dm_state


def run_ppo(cfg, dm_tr, dm_state, batch, dev, report):
    """The PPO stage at full width: 3 collections into a buffer of 3,000, a
    30-iteration update phase at mini-batch 128, one test step. Returns the
    last collection's trajectories."""
    import torch

    from cld_tpu_torch.ops import native
    from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init

    COLLECTS, ITERS = 3, 30
    algo = cfg.algo
    ppo = PPOTrainer(cfg, dm_tr)
    buf = buffer_init(algo.buffer_max, algo.horizon, algo.vae.latent_size, algo.cond_feat_dim,
                      device=dev)
    check(buf.capacity == 3000 and ppo.mini_batch == 128, "PPO is not at the record's sizes")
    gen = torch.Generator(device=dev).manual_seed(32)
    native.reset_launch_counts()
    secs = []
    for k in range(COLLECTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        buf, out = ppo.collect_step(dm_state, buf, batch, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(out["reward"])), f"collect step {k}: reward is not finite")
    traj = out["traj"]
    check(buf.size == COLLECTS * B and buf.ptr == COLLECTS * B, f"buffer fill {buf.size}")
    check(tuple(traj.shape) == (B, 1, T, 6) and bool(torch.isfinite(traj).all()),
          "collected trajectories are not finite [B, 1, T, 6]")
    for name in ("x0", "x1", "log_p", "reward", "cond_feat"):
        check(bool(torch.isfinite(getattr(buf, name)[:buf.size]).all()),
              f"buffer field {name} is not finite")
    collect_rate = (COLLECTS - 1) / sum(secs[1:])
    launches = native.launch_counts()
    want = counts(lstm2_fwd=COLLECTS, offroad_count=COLLECTS)
    check(launches == want, f"collect launches {launches}, expected {want}")

    before = snapshot(dm_state.model)
    step0 = dm_state.step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    indices = torch.randint(0, buf.size, (ITERS, ppo.mini_batch), generator=gen, device=dev)
    _, pm = ppo.ppo_update(dm_state, buf, indices=indices)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    pm = {k: float(v) for k, v in pm.items()}
    delta = max_param_change(before, dm_state.model)
    check(all(v == v for v in pm.values()), f"PPO metrics hold a NaN: {pm}")
    check(0.0 <= pm["clip_fraction"] <= 1.0, f"clip_fraction {pm['clip_fraction']}")
    check(dm_state.step == step0 + ITERS, f"PPO update took {dm_state.step - step0} steps")
    check(delta > 0.0, "the PPO update moved no parameter")

    rates, stats = ppo.test_step(dm_state, batch, generator=gen)
    torch.cuda.synchronize()
    rates = {k: float(v) for k, v in rates.items()}
    check(all(0.0 <= v <= 1.0 for v in rates.values()), f"failure rates {rates}")
    check(tuple(stats["long_acc_pred"].shape) == (B, T)
          and all(bool(torch.isfinite(v).all()) for v in stats.values()),
          "test step statistics are not finite [B, T]")
    launches = native.launch_counts()
    want = counts(lstm2_fwd=COLLECTS + 1, offroad_count=COLLECTS)
    check(launches == want, f"PPO launches {launches}, expected {want}")
    report["launches_ppo"] = launches
    report["ppo"] = dict(ppo_collect_steps_per_sec=collect_rate, collect_s=secs,
                         ppo_update_iters_per_sec=ITERS / update_s, update_iters=ITERS,
                         update_metrics=pm, failure_rates=rates,
                         mean_reward=float(out["reward"]))
    log(f"ppo: {collect_rate:.3f} collect steps/s ({', '.join(f'{v:.2f}' for v in secs)} s), "
        f"{ITERS / update_s:.2f} update iterations/s at mini-batch {ppo.mini_batch} ({ITERS} "
        f"iterations, {update_s:.2f} s; parameters moved by up to {delta:.3e}), on "
        f"{report['card']}; update metrics {json.dumps(pm)}; failure rates {json.dumps(rates)}; "
        f"launches {launches}")
    return traj


def run_ppo_disk_penalty(traj, batch, dev, report, kernels):
    """The disk-collision penalty of the trajectories that the PPO stage
    collected. No entry point of the trainer calls this op (it has no
    gradient and the PPO reward does not use it), so its launch is counted as
    a path of its own, `ppo_disk_penalty`, and the `ppo` path launches it 0
    times. The scene poses are this script's: scenes of 4 agents parked 3 m
    apart in one lane, so that neighbours' disks overlap from the start."""
    import torch

    from cld_tpu_torch.guidance import losses as gl
    from cld_tpu_torch.ops import native
    from cld_tpu_torch.ops import reward_kernels as rk
    from cld_tpu_torch.ops.geometry import world_from_agent_matrix

    native.reset_launch_counts()
    lane = (torch.arange(B, device=dev) % AGENTS_PER_SCENE).float()
    wfa = world_from_agent_matrix(torch.stack([lane * 3.0, torch.zeros_like(lane)], -1),
                                  torch.zeros_like(lane))
    scene = torch.arange(B, device=dev) // AGENTS_PER_SCENE
    ctx = gl.GuidanceContext(batch.drivable_map, batch.raster_from_agent, batch.extent,
                             batch.curr_speed, wfa, scene)
    rule = gl.AgentCollisionLoss(num_disks=5, buffer_dist=0.2)
    cent = gl.disk_centres_world(traj, ctx, rule.num_disks)[:, 0].permute(1, 0, 2, 3).contiguous()
    rad = batch.extent[:, 1] / 2.0
    pen_d = rad[:, None] + rad[None, :] + rule.buffer_dist
    mask = scene_pair_mask(B, AGENTS_PER_SCENE, dev)
    decay = gl._decay_weights(T, rule.decay_rate, dev)
    got = rk.disk_collision_penalty(cent, pen_d, mask, decay)
    torch.cuda.synchronize()
    ref = rk.disk_collision_penalty_ref(cent, pen_d, mask, decay)
    flat_rule = rule(traj, ctx)[:, 0]  # the rule's flat path; 0 for agents that stand still
    moving = batch.curr_speed.abs() > rule.guide_moving_speed_th
    err = float((got - ref).abs().max())
    err_rule = float((torch.where(moving, got, torch.zeros(()).to(dev)) - flat_rule).abs().max())
    log(f"disk_collision on the collected trajectories: max abs err vs plain {err:.3e}, vs "
        f"AgentCollisionLoss {err_rule:.3e} (rtol 1e-5, atol 1e-6; max penalty "
        f"{float(ref.max()):.4f}, {int((ref > 0).sum())} of {B} agents penalized)")
    check(bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-6).all()),
          "disk_collision disagrees with its plain version on the collected trajectories")
    check(bool(((torch.where(moving, got, torch.zeros(()).to(dev)) - flat_rule).abs()
                <= 1e-5 * flat_rule.abs() + 1e-6).all()),
          "disk_collision disagrees with AgentCollisionLoss on the collected trajectories")
    check(float(ref.max()) > 0.0, "the collected trajectories have no collision")
    kernels["disk_collision"]["max_abs_err"] = max(kernels["disk_collision"]["max_abs_err"], err)
    launches = native.launch_counts()
    check(launches == counts(disk_collision=1), f"disk penalty launches {launches}, expected 1")
    report["launches_ppo_disk_penalty"] = launches
    report["ppo"]["disk_penalty_max"] = float(ref.max())


def check_small_training(dev, report):
    """One VAE step's and one DM step's gradients, and one collection's
    trajectories and rewards, on the card against the CPU at the `cld_smoke`
    widths (B=8, raster 64, 5 diffusion steps): same weights, same explicit
    noise and dropout masks. Gradients are held over each stage's whole
    gradient vector: |card - cpu| <= 1e-4 |cpu| + 1e-4 max |cpu| (f32
    convolutions, BatchNorm over a batch of 8 and two LSTM implementations on
    two backends); trajectories as the small slice's; rewards within 1e-3."""
    import torch

    from cld_tpu_torch.algos.dm import dm_loss
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    cfg = get_registered_experiment_config("cld_smoke")
    algo = cfg.algo
    Bs, Hs, Ls, steps = 8, algo.vae.hidden_size, algo.vae.latent_size, algo.n_diffusion_steps
    g = torch.Generator().manual_seed(17)
    noise = torch.randn((Bs, T, Ls), generator=g)
    masks = tuple((torch.rand((Bs, T, Hs), generator=g) >= 0.2).float() for _ in range(2))
    t = torch.randint(0, steps, (Bs,), generator=g)
    eps = torch.randn((Bs, T, Ls), generator=g)
    x_init = torch.randn((Bs, T, Ls), generator=g)
    step_noises = torch.randn((steps, Bs, T, Ls), generator=g)
    res, weights = {}, None
    for where in ("cpu", dev):
        batch = synthetic_batch(seed=4, batch_size=Bs, raster_size=64,
                                hist_frames=algo.history_num_frames, device=where)
        vs = VAETrainer(cfg, device=where).init_state(seed=5)
        if weights is None:  # copied now: the train-mode forward moves BatchNorm's statistics
            vae_weights = {k: v.clone() for k, v in vs.model.state_dict().items()}
        else:
            vs.model.load_state_dict(weights[0])
        mv = lambda v: v.to(where)
        out = vs.model(batch, 0.05, train=True, noise=mv(noise), keep_masks=tuple(map(mv, masks)))
        out["loss"].backward()
        vae_grad = torch.cat([p.grad.flatten().cpu() for p in vs.model.parameters()])
        dm_tr = DMTrainer(cfg, vs.model, device=where)  # freezes the VAE
        ds = dm_tr.init_state(seed=6)
        if weights is None:
            weights = (vae_weights, ds.model.state_dict())
        else:
            ds.model.load_state_dict(weights[1])
        z0, aux = dm_tr.encode(batch, mv(noise))
        loss = dm_loss(ds.model, dm_tr.schedule, z0, aux["cond_feat"], mv(t), mv(eps))
        loss.backward()
        dm_grad = torch.cat([p.grad.flatten().cpu() for p in ds.model.parameters()])
        ds.optimizer.zero_grad(set_to_none=True)
        ppo = PPOTrainer(cfg, dm_tr)
        buf = buffer_init(algo.buffer_max, algo.horizon, Ls, algo.cond_feat_dim, device=where)
        buf, col = ppo.collect_step(ds, buf, batch, x_init=mv(x_init), step_noises=mv(step_noises))
        res[str(where)] = dict(vae_loss=float(out["loss"].detach()), vae_grad=vae_grad,
                               dm_loss=float(loss.detach()), dm_grad=dm_grad, traj=col["traj"].cpu(),
                               reward=buf.reward[:Bs].cpu())
    c, k = res["cpu"], res[str(dev)]
    summary = {}
    for name in ("vae_grad", "dm_grad"):
        a, b = k[name], c[name]
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        log(f"small training {name}: card vs CPU max abs diff {err:.3e} (rtol 1e-4, floor 1e-4 "
            f"of max {scale:.3g}); losses {k[name[:-4] + 'loss']:.6f} vs "
            f"{c[name[:-4] + 'loss']:.6f}")
        check(scale > 0.0, f"small training {name} is zero")
        check(bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-4 * scale).all()),
              f"small training {name} disagrees between card and CPU")
        summary[name] = err
    a, b = k["traj"], c["traj"]
    err = float((a - b).abs().max())
    check(bool(((a - b).abs() <= SLICE_RTOL * b.abs() + 1e-6 * float(b.abs().max())).all()),
          "small collection trajectories disagree between card and CPU")
    r_err = float((k["reward"] - c["reward"]).abs().max())
    log(f"small collection: trajectories card vs CPU max abs diff {err:.3e}, rewards {r_err:.3e} "
        f"(tolerance 1e-3; CPU rewards {[round(v, 3) for v in c['reward'].tolist()]})")
    check(r_err <= 1e-3, "small collection rewards disagree between card and CPU")
    summary.update(traj=err, reward=r_err)
    report["small_training"] = summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test needs a CUDA card")
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from cld_tpu_torch import pipeline
        from cld_tpu_torch.data.synthetic import synthetic_batch
        from cld_tpu_torch.ops import native
        from cld_tpu_torch.sim.scene import synthetic_scene_pack
    except ImportError as e:
        log(f"FAIL: the cld_tpu_torch package is not beside this script: {e}")
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    native.library()
    report["build_s"] = time.perf_counter() - t0
    t_start = t0
    log(f"kernels built and loaded in {report['build_s']:.1f} s: {native.library_path().name}")

    t0 = time.perf_counter()
    models = pipeline.build_models(seed=0, device=dev)
    batch = synthetic_batch(seed=0, batch_size=B, raster_size=RASTER, device=dev)
    torch.cuda.synchronize()
    log(f"models + synthetic batch (B={B}, {RASTER}x{RASTER}x{batch.image.shape[-1]}) "
        f"in {time.perf_counter() - t0:.1f} s")

    kernels = {}
    check_lstm(models, dev, kernels)
    check_gather(batch, dev, kernels)
    check_rigid(batch, dev, kernels)
    check_reward_kernels(batch, dev, kernels)
    run_main_path(models, batch, report)
    run_rigid_paths(models, batch, report)
    check_rigid_agreement(models, batch, dev, report)
    check_small_slice(dev, report)
    check_small_slice(dev, report, min_dist_impl="rigid_kernel")
    cfg, dm_tr, dm_state = run_training(batch, dev, report)
    traj = run_ppo(cfg, dm_tr, dm_state, batch, dev, report)
    run_ppo_disk_penalty(traj, batch, dev, report, kernels)
    check_small_training(dev, report)
    del batch, dm_tr, dm_state
    torch.cuda.empty_cache()

    pack = synthetic_scene_pack(seed=0, num_scenes=CL_SCENES, agents_per_scene=CL_AGENTS,
                                world_map_size=WORLD_MAP, sim_steps=CL_STEPS, device=dev)
    check_map_gathers(dev, kernels)
    check_warp(pack, dev, report)
    run_closed_loop(models, pack, report)
    run_px_replan(models, pack, report)
    run_rigid_replan(models, pack, report)
    check_small_closed_loop(dev, report)
    del pack
    run_rules_path(report)
    check_rules_replan(dev, report)
    run_checkpoint_path(report)
    run_data_path(report)

    replaces = {
        "lstm2_fwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:169"),
        "lstm2_bwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:312"),
        "bit_gather": ("cld_tpu_torch/csrc/bit_gather.cu", "cld_tpu/ops/pallas_kernels.py:179"),
        "value_gather": ("cld_tpu_torch/csrc/value_gather.cu",
                         "cld_tpu/ops/pallas_kernels.py:291"),
        "drivable_gather": ("cld_tpu_torch/csrc/drivable_gather.cu",
                            "cld_tpu/ops/pallas_kernels.py:102"),
        "rigid_min": ("cld_tpu_torch/csrc/rigid_min.cu", "cld_tpu/ops/pallas_kernels.py:471"),
        "rigid_min_fused": ("cld_tpu_torch/csrc/rigid_min.cu",
                            "cld_tpu/ops/pallas_kernels.py:404"),
        "rigid_bwd": ("cld_tpu_torch/csrc/rigid_bwd.cu", "cld_tpu/ops/pallas_kernels.py:541"),
        "offroad_count": ("cld_tpu_torch/csrc/offroad_count.cu",
                          "cld_tpu/ops/pallas_kernels.py:41"),
        "disk_collision": ("cld_tpu_torch/csrc/disk_collision.cu",
                           "cld_tpu/ops/pallas_kernels.py:617"),
    }
    paths = {"open_loop": "launches", "closed_loop": "launches_closed_loop",
             "px_replan": "launches_px_replan", "rigid_open_loop": "launches_rigid_kernel",
             "fused_open_loop": "launches_fused", "rigid_replan": "launches_rigid_replan",
             "vae_train": "launches_vae_train", "dm_train": "launches_dm_train",
             "ppo": "launches_ppo", "ppo_disk_penalty": "launches_ppo_disk_penalty",
             "rules": "launches_rules", "checkpoint_rollout": "launches_checkpoint_rollout",
             "evaluate": "launches_evaluate", "data_train": "launches_data_train",
             "scene_data_rollout": "launches_scene_data_rollout",
             **{f"policy_{p}": f"launches_{p}" for p in MODEL_FREE}}
    # the launch floor: one kernel node of a graph that does nothing (one
    # thread that exits at once), timed as every kernel's graph_ms is
    floor_ms = graph_ms(lambda: torch.cuda._sleep(0))
    report["launch_floor_ms"] = floor_ms
    log(f"launch floor (torch.cuda._sleep(0) from a CUDA graph): {floor_ms:.5f} ms")
    line = []
    for name, (src, rep) in replaces.items():
        k = kernels[name]
        k_graph = k["graph_ms"][str(B)] if isinstance(k["graph_ms"], dict) else k["graph_ms"]
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(report[p][name] for p in paths.values()),
            "launches_by_path": {path: report[p][name] for path, p in paths.items()},
            "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "graph_ms": k_graph, "launch_floor_ms": floor_ms,
        })
    report["kernels"] = kernels
    check(len(line) == len(native.KERNELS), "a kernel is missing from the kernels line")
    for k in line:
        check(k["launches"] > 0, f"kernel {k['name']} was launched by no main-path run")
    report["total_s"] = time.perf_counter() - t_start
    log(f"all checks passed in {report['total_s']:.1f} s (build included)")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
