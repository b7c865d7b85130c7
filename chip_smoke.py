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
   forward, and the bit gather (exactly). Times each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call; computes each kernel's bound from its bytes and operations.
4. Runs `pipeline.guided_collect` at the full width of the config of record
   (ResNet-18 over 224x224x34, cond 256, UNet dim 32 x (2, 4, 8), LSTM H=64,
   100 DDPM steps, agent + map collision guidance) with seeded random
   weights, guided then unguided: launch counts are zeroed just before the
   guided run and read just after; outputs must be finite; prints NFE/s.
5. Runs the slice at a small size (B=8, raster 64, 10 steps) on the card and
   on the CPU (plain versions) with the same weights and noise, and holds
   the results against each other.
6. Prints the card line, one `{"kernels": [...]}` line, and last
   `{"ok": true, "device": {...}}`. Any failed check exits non-zero first.

A longer report goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
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

LSTM_REL_TOL = 1e-5  # max |kernel - plain| / max |plain|: f32, other summation order
SLICE_RTOL = 1e-4  # small-slice card vs CPU: f32 networks on two backends


class CheckFailed(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple:
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / max(scale, 1e-30)


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

    got = lk.lstm2_fwd(*args)
    want = lk.lstm2_core_ref(*args)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    fwd_abs = max(e[0] for e in errs)
    fwd_rel = max(e[1] for e in errs)
    log(f"lstm2_fwd: max abs err {fwd_abs:.3e}, max rel err {fwd_rel:.3e} "
        f"(tolerance {LSTM_REL_TOL:.0e} of max |plain|)")
    check(fwd_rel <= LSTM_REL_TOL, f"lstm2_fwd disagrees with its plain version: {fwd_rel:.3e}")

    y, h1s, c1s, c2s = want
    dy = torch.randn((B, T, H), generator=g).to(dev)
    bargs = (dy, *args, h1s, c1s, y, c2s)
    dg_k = lk.lstm2_bwd(*bargs)
    dg_p = lk.lstm2_bwd_ref(*bargs)
    torch.cuda.synchronize()
    errs = [rel_err(a, b) for a, b in zip(dg_k, dg_p)]
    bwd_abs = max(e[0] for e in errs)
    bwd_rel = max(e[1] for e in errs)
    log(f"lstm2_bwd: max abs err {bwd_abs:.3e}, max rel err {bwd_rel:.3e} "
        f"(tolerance {LSTM_REL_TOL:.0e} of max |plain|)")
    check(bwd_rel <= LSTM_REL_TOL, f"lstm2_bwd disagrees with its plain version: {bwd_rel:.3e}")

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

    # timings: kernel, plain version, and cuDNN's LSTM from the same latents
    fwd_ms = cuda_ms(lambda: lk.lstm2_fwd(*args), 50)
    fwd_plain_ms = cuda_ms(lambda: lk.lstm2_core_ref(*args), 5)
    bwd_ms = cuda_ms(lambda: lk.lstm2_bwd(*bargs), 50)
    bwd_plain_ms = cuda_ms(lambda: lk.lstm2_bwd_ref(*bargs), 5)
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

    f32 = 4
    w_bytes = f32 * (H * 4 * H + 2 * H * 4 * H + 4 * H)
    fwd_b, fwd_by = bound(f32 * (B * T * 4 * H + B * H + 4 * B * T * H) + w_bytes,
                          2.0 * B * T * (H * 4 * H + 2 * H * 4 * H))
    bwd_b, bwd_by = bound(
        f32 * (B * T * H + B * T * 4 * H + B * H + 4 * B * T * H + 2 * B * T * 4 * H) + w_bytes,
        2.0 * B * T * (H * 4 * H + 2 * H * 4 * H + 4 * H * 2 * H + 4 * H * H))
    report["lstm2_fwd"] = dict(max_abs_err=fwd_abs, max_rel_err=fwd_rel, ms=fwd_ms,
                               plain_ms=fwd_plain_ms, bound_ms=fwd_b, bound_by=fwd_by,
                               library_ms=fwd_lib_ms)
    report["lstm2_bwd"] = dict(max_abs_err=bwd_abs, max_rel_err=bwd_rel, ms=bwd_ms,
                               plain_ms=bwd_plain_ms, bound_ms=bwd_b, bound_by=bwd_by,
                               library_ms=None)


def check_gather(batch, dev, report):
    import torch

    from cld_tpu_torch.ops import gather_kernels as gk

    packed = gk.pack_drivable_bits(batch.drivable_map)
    Hm, W8 = packed.shape[1:]
    W = batch.drivable_map.shape[-1]
    g = torch.Generator().manual_seed(2)
    pix = torch.stack([torch.randint(0, W, (B, Q), generator=g),
                       torch.randint(0, Hm, (B, Q), generator=g)], dim=-1)
    pix[:, :4] = torch.tensor([[0, 0], [W - 1, 0], [0, Hm - 1], [W - 1, Hm - 1]])
    pix = pix.to(torch.int32).to(dev).contiguous()
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
    b_ms, b_by = bound(8 * B * Q + B * Hm * W8 + 4 * B * Q, 0.0)
    report["bit_gather"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None)


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
    want = {"lstm2_fwd": N_STEPS, "lstm2_bwd": N_STEPS - 1, "bit_gather": N_STEPS - 1}
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
    check(uo["launches"] == {"lstm2_fwd": 1, "lstm2_bwd": 0, "bit_gather": 0},
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


def check_small_slice(dev, report):
    """The slice at a small size on the card (kernels) and on the CPU (plain
    versions), same weights and noise. Each comparison holds
    |card - cpu| <= 1e-4 |cpu| + floor * max |cpu|. The floor is 1e-6 for
    trajectories and unguided latents. It is 1e-4 for the guided latents:
    one Adam step from m = v = 0 moves a component by ~lr * sign(g), so a
    gradient component near zero can take the other sign and move by up to
    2 sigma. It is 1e-4 for the guidance gradient too, whose near-zero
    components carry the rounding of f32 sums over the bbox grid."""
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
    res = {}
    for where in ("cpu", dev):
        m = pipeline.build_models(seed=5, device=where, n_diffusion_steps=steps)
        b = synthetic_batch(seed=4, batch_size=Bs, raster_size=64, device=where)
        outs = {gd: pipeline.guided_collect(m, b, guided=gd, agents_per_scene=AGENTS_PER_SCENE,
                                            x_init=x_init.to(where), step_noises=noises.to(where))
                for gd in (False, True)}
        aux = m.context(b)
        wfa, si = pipeline.scene_world_poses(Bs, AGENTS_PER_SCENE, where)
        ctx = gl.prepack_map_bbox(gl.prepack_drivable(gl.GuidanceContext(
            b.drivable_map, b.raster_from_agent, b.extent, b.curr_speed, wfa, si)))

        def decode_fn(v):
            acts = pipeline.decode_actions(m.decoder, v, aux["cond_feat"])
            return pipeline.convert_action_to_state_and_action(
                acts, aux["curr_states"], m.dyn, pipeline.TrajNormalizer(),
                descaled_output=True)[:, None]

        grad = guidance_gradient(z.to(where), ctx, pipeline.flagship_guidance_specs(
            AGENTS_PER_SCENE), decode_fn)
        res[str(where)] = (outs, grad.cpu(), outs[True]["launches"])
    (c_outs, c_grad, _), (g_outs, g_grad, g_launch) = res["cpu"], res[str(dev)]
    check(g_launch == {"lstm2_fwd": steps, "lstm2_bwd": steps - 1, "bit_gather": steps - 1},
          f"small slice launches {g_launch}")

    def close(name, a, b, floor):
        a, b = a.detach().cpu(), b.detach().cpu()
        err = float((a - b).abs().max())
        tol = SLICE_RTOL * b.abs() + floor * float(b.abs().max())
        ok = bool(((a - b).abs() <= tol).all())
        log(f"small slice {name}: card vs CPU max abs diff {err:.3e} "
            f"(rtol {SLICE_RTOL:.0e}, floor {floor:.0e} of max {float(b.abs().max()):.3g})")
        check(ok, f"small slice {name} disagrees between card and CPU")
        return err

    summary = {}
    for gd in (False, True):
        tag = "guided" if gd else "unguided"
        summary[f"{tag}_traj"] = close(f"{tag} traj", g_outs[gd]["traj"], c_outs[gd]["traj"], 1e-6)
        summary[f"{tag}_latents"] = close(f"{tag} latents", g_outs[gd]["pred_traj"],
                                          c_outs[gd]["pred_traj"], 1e-4 if gd else 1e-6)
    check(float(c_grad.abs().max()) > 0.0, "small slice guidance gradient is zero")
    summary["guidance_grad"] = close("guidance gradient", g_grad, c_grad, 1e-4)
    report["small_slice"] = summary


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
    run_main_path(models, batch, report)
    check_small_slice(dev, report)

    replaces = {
        "lstm2_fwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:169"),
        "lstm2_bwd": ("cld_tpu_torch/csrc/lstm.cu", "cld_tpu/ops/lstm_pallas.py:312"),
        "bit_gather": ("cld_tpu_torch/csrc/bit_gather.cu", "cld_tpu/ops/pallas_kernels.py:179"),
    }
    line = []
    for name, (src, rep) in replaces.items():
        k = kernels[name]
        line.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": report["launches"][name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
        })
    report["kernels"] = kernels
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
