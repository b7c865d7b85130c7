"""Package rules of the port: `cld_tpu_torch` imports no JAX, flax or
cld_tpu module; its entry points default to the CUDA device; its kernel
wrappers dispatch by tensor device and never fall back quietly."""

import ast
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cld_tpu_torch
import numpy as np

from cld_tpu_torch import pipeline, rollout, train
from cld_tpu_torch.algos import diffuser
from cld_tpu_torch.data import convert, loader, multihost, packed, synthetic
from cld_tpu_torch.eval import composers
from cld_tpu_torch.parallel import mesh
from cld_tpu_torch.utils import timer
from cld_tpu_torch.ops import diffusion, gather_kernels, lstm_kernels, native
from cld_tpu_torch.sim import scene
from cld_tpu_torch.algos import scene_dm as scene_dm_algo
from cld_tpu_torch.training import dm as training_dm
from cld_tpu_torch.training import ebm as training_ebm
from cld_tpu_torch.training import gan as training_gan
from cld_tpu_torch.training import ppo as training_ppo
from cld_tpu_torch.training import scene_dm as training_scene_dm
from cld_tpu_torch.training import vae as training_vae
from cld_tpu_torch.training import zoo as training_zoo

torch.set_num_threads(2)
PKG = Path(cld_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cld_tpu")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_package_imports():
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]
    assert len(files) > 35
    names = {str(f.relative_to(PKG.parent)) for f in files}
    assert {"cld_tpu_torch/sim/env.py", "cld_tpu_torch/ops/raster.py", "cld_tpu_torch/rollout.py",
            "cld_tpu_torch/train.py", "cld_tpu_torch/training/state.py",
            "cld_tpu_torch/training/vae.py", "cld_tpu_torch/training/dm.py",
            "cld_tpu_torch/training/ppo.py", "cld_tpu_torch/training/checkpoints.py",
            "cld_tpu_torch/data/loader.py", "cld_tpu_torch/utils/config.py",
            "cld_tpu_torch/utils/registry.py", "cld_tpu_torch/ops/reward_kernels.py",
            "cld_tpu_torch/utils/torch_import.py", "cld_tpu_torch/eval/metrics.py",
            "cld_tpu_torch/eval/cle.py", "cld_tpu_torch/sim/occupancy.py",
            "cld_tpu_torch/rules/stl.py", "cld_tpu_torch/ops/metrics.py",
            "cld_tpu_torch/sim/logger.py", "cld_tpu_torch/test.py",
            "cld_tpu_torch/data/packed.py", "cld_tpu_torch/data/convert.py",
            "cld_tpu_torch/data/multihost.py", "cld_tpu_torch/data/validation.py",
            "cld_tpu_torch/data/scene_batch.py", "cld_tpu_torch/ops/dynamics_extra.py",
            "cld_tpu_torch/policies/hardcoded.py", "cld_tpu_torch/policies/planner.py",
            "cld_tpu_torch/policies/mpc.py", "cld_tpu_torch/policies/contingency.py",
            "cld_tpu_torch/training/zoo.py", "cld_tpu_torch/ops/losses.py",
            "cld_tpu_torch/algos/diffuser.py", "cld_tpu_torch/models/bc.py",
            "cld_tpu_torch/models/cvae.py", "cld_tpu_torch/models/cvae_nets.py",
            "cld_tpu_torch/models/discrete_cvae.py", "cld_tpu_torch/models/dm_mlp.py",
            "cld_tpu_torch/models/transformer_baseline.py", "cld_tpu_torch/models/tree_vae.py",
            "cld_tpu_torch/models/roi_encoder.py", "cld_tpu_torch/models/agent_predictor.py",
            "cld_tpu_torch/models/map_unet.py", "cld_tpu_torch/models/spatial_planner.py",
            "cld_tpu_torch/models/occupancy.py", "cld_tpu_torch/models/spatial_softmax.py",
            "cld_tpu_torch/models/learned_metric.py", "cld_tpu_torch/models/gan.py",
            "cld_tpu_torch/models/history_encoders.py",
            "cld_tpu_torch/models/scene_transformer.py", "cld_tpu_torch/training/ebm.py",
            "cld_tpu_torch/training/gan.py", "cld_tpu_torch/training/scene_dm.py",
            "cld_tpu_torch/sim/learned_metrics.py", "cld_tpu_torch/algos/scene_dm.py",
            "cld_tpu_torch/algos/latent_attack.py", "cld_tpu_torch/policies/scene_policy.py",
            "cld_tpu_torch/eval/composers.py", "cld_tpu_torch/viz/render.py",
            "cld_tpu_torch/parallel/mesh.py", "cld_tpu_torch/utils/timer.py",
            "cld_tpu_torch/utils/experiment.py", "cld_tpu_torch/utils/wandb_logging.py",
            "cld_tpu_torch/ops/precision.py", "chip_smoke.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, f"{f.relative_to(PKG.parent)} imports {mod}"


@pytest.mark.parametrize("fn", [pipeline.build_models, synthetic.synthetic_batch,
                                diffusion.make_schedule, scene.synthetic_scene_pack,
                                loader.make_loader, loader.SyntheticLoader.__init__,
                                packed.PackedShardLoader.__init__,
                                multihost.DistributedPackedLoader.__init__,
                                scene.scene_pack_from_batches, scene.scene_pack_from_shards,
                                convert.parse_raw_batch, convert.convert_nuscenes,
                                training_vae.VAETrainer.__init__, training_dm.DMTrainer.__init__,
                                training_ppo.buffer_init, training_zoo.ZooTrainer.__init__,
                                diffuser.draw_loss_noise, training_ebm.EBMTrainer.__init__,
                                training_gan.GANTrainer.__init__, training_gan.draw_gan_noise,
                                training_scene_dm.SceneDMTrainer.__init__,
                                scene_dm_algo.draw_scene_loss_noise,
                                scene_dm_algo.draw_scene_sample_noise, mesh.make_mesh,
                                timer.device_trace, *composers.COMPOSER_REGISTRY.values()])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_wrappers_raise_on_devices_without_a_kernel():
    B, T, H = 2, 3, 4
    m = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")
    with pytest.raises(ValueError):
        lstm_kernels.lstm2_fwd(m(B, T, 4 * H), m(B, H), m(H, 4 * H), m(2 * H, 4 * H), m(4 * H))
    with pytest.raises(ValueError):
        lstm_kernels.lstm2_bwd(m(B, T, H), m(B, T, 4 * H), m(B, H), m(H, 4 * H),
                               m(2 * H, 4 * H), m(4 * H), *(m(B, T, H) for _ in range(4)))
    with pytest.raises(ValueError):
        gather_kernels.drivable_bit_gather(m(B, 5, 2, dtype=torch.int32),
                                           m(B, 4, 1, dtype=torch.int8))
    with pytest.raises(ValueError):
        gather_kernels.drivable_gather(m(B, 5, 2, dtype=torch.int32),
                                       m(B, 4, 4, dtype=torch.int8))
    with pytest.raises(ValueError):
        gather_kernels.value_gather(m(B, 5, 2, dtype=torch.int32),
                                    m(B, 4, 4, 3, dtype=torch.int8))


def test_cpu_tensors_take_the_plain_versions_without_counting():
    native.reset_launch_counts()
    pix = torch.zeros((1, 3, 2), dtype=torch.int32)
    packed = gather_kernels.pack_drivable_bits(torch.ones((1, 4, 9)))
    assert gather_kernels.drivable_bit_gather(pix, packed).tolist() == [[1.0, 1.0, 1.0]]
    drv = torch.full((1, 4, 9), 3, dtype=torch.int8)
    assert gather_kernels.drivable_gather(pix, drv).tolist() == [[3.0, 3.0, 3.0]]
    assert gather_kernels.value_gather(pix, drv[..., None]).tolist() == [[[3.0]] * 3]
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}


def test_kernel_library_name_tracks_the_sources():
    path = native.library_path()
    assert path.parent == PKG / "_build" and path.suffix == ".so"
    assert sorted(p.name for p in native.CSRC.glob("*.cu")) == [
        "bit_gather.cu", "disk_collision.cu", "dma_probe.cu", "drivable_gather.cu", "lstm.cu",
        "lstm_bf16.cu", "lstm_wide.cu", "offroad_count.cu", "rigid_bwd.cu", "rigid_min.cu",
        "value_gather.cu"]
    # ten kernels, the LSTM pair in two storage types (bf16: `lstm_bf16.cu`) and
    # above H = 64 in both (`lstm_wide.cu`), and the bulk-copy probe
    assert len(native.KERNELS) == 17
    assert {"lstm2_fwd_bf16", "lstm2_bwd_bf16", "lstm2_fwd_wide", "lstm2_bwd_wide",
            "lstm2_fwd_wide_bf16", "lstm2_bwd_wide_bf16", "dma_probe"} <= set(native.KERNELS)


def test_rollout_cli_defaults_to_cuda_and_runs_on_the_cpu(tmp_path, capsys):
    """The CLI at a small size on the CPU: 1 scene x 2 agents, raster 64,
    4 DDPM steps, 10 frames; finite trajectory log of the right shape,
    reproducible from the seed; without `--device cpu` it asks for the card."""
    argv = ["--num-scenes", "1", "--agents-per-scene", "2", "--num-sim-steps", "10",
            "--raster-size", "64", "--hist-frames", "10", "--diffusion-steps", "4"]
    runs = []
    for guidance in ("flagship", "flagship", "none"):
        out = tmp_path / f"{guidance}{len(runs)}"
        report = rollout.main(argv + ["--device", "cpu", "--guidance", guidance,
                                      "--output", str(out)])
        assert report["num_sim_steps"] == 10 and report["device"] == "cpu"
        assert report["num_controlled_agents"] == 1
        with np.load(out / "trajectories.npz") as f:
            traj = f["trajectories"]
            assert f["controlled_mask"].tolist() == [True, False]
        assert traj.shape == (10, 2, 4) and np.isfinite(traj).all()
        runs.append(traj)
    assert "offroad_rate" in capsys.readouterr().out
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0][:, 1], runs[2][:, 1])  # the replay agent ignores guidance
    assert (np.diff(runs[2][:, :, 0], axis=0) > 0).all()  # both agents drive on
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            rollout.main(argv + ["--output", str(tmp_path / "cuda")])


@pytest.mark.parametrize("flags", [
    ["--sampler", "ddim", "--ddim-steps", "3", "--ddim-eta", "0.5", "--num-action-samples", "2"],
    ["--guidance-stride", "2", "--guide-clean", "--guide-output", "--guidance-lr", "0.1",
     "--guidance-steps", "2", "--perturb-th", "0.5", "--num-action-samples", "3"],
], ids=["ddim_two_samples", "ddpm_stride_clean_output_three_samples"])
def test_rollout_cli_sampler_and_guidance_flags(flags, tmp_path):
    """The flags that pick the sampler, the samples per agent and the guidance
    schedule, on the CPU at a small size:
    a finite trajectory log, reproducible from the seed."""
    argv = ["--device", "cpu", "--num-scenes", "1", "--agents-per-scene", "2",
            "--num-sim-steps", "5", "--raster-size", "64", "--hist-frames", "10",
            "--diffusion-steps", "4"]
    runs = []
    for extra in (flags + ["--guidance", "flagship"], flags + ["--guidance", "flagship"],
                  flags + ["--guidance", "none"]):
        out = tmp_path / str(len(runs))
        rollout.main(argv + extra + ["--output", str(out)])
        with np.load(out / "trajectories.npz") as f:
            runs.append(f["trajectories"])
        assert runs[-1].shape == (5, 2, 4) and np.isfinite(runs[-1]).all()
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0][:, 1], runs[2][:, 1])  # the replay agent ignores guidance
    assert (np.diff(runs[0][:, :, 0], axis=0) > 0).all()  # both agents drive on


def _jax_rollout_defaults():
    """{option: default} of the JAX package's `rollout.py` argument parser,
    read from its source."""
    tree = ast.parse((PKG.parent / "rollout.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = (ast.literal_eval(kw["default"]) if "default" in kw
                                       else False if "action" in kw else None)
    return out


def test_rollout_cli_takes_the_jax_defaults_and_times_a_warm_episode(tmp_path, monkeypatch):
    """The port's rollout CLI has every option of the JAX CLI, each with the
    JAX CLI's default (one scene of 4 agents, no guidance rule, no composer,
    no render among them). `main` runs a
    warm-up episode from a generator seeded `--seed`, then the timed one
    from `--seed` + 1, whose log it writes; its launches are the timed
    episode's alone, and the process-wide counts are left to add up."""
    jax_defaults = _jax_rollout_defaults()
    ours = vars(rollout.parse_args([]))
    shared = {o for o in jax_defaults if o.lstrip("-").replace("-", "_") in ours}
    assert shared == set(jax_defaults), sorted(set(jax_defaults) - shared)
    assert {"--num-scenes", "--agents-per-scene", "--guidance", "--policy", "--agents-policy",
            "--scene-data", "--scene-start-index", "--guide-with-gt", "--seed", "--composer",
            "--composer-ckpt", "--render", "--save-every-n-frames", "--render-size"} <= shared
    for opt in shared:
        assert ours[opt.lstrip("-").replace("-", "_")] == jax_defaults[opt], opt
    assert (ours["num_scenes"], ours["agents_per_scene"], ours["guidance"]) == (1, 4, "")

    seeds = []
    simulate = rollout.simulate

    def counted(pack, policy, cfg, generator=None):
        seeds.append(generator.initial_seed())
        native.count_launch("value_gather")  # one pretend launch per episode
        return simulate(pack, policy, cfg, generator=generator)

    monkeypatch.setattr(rollout, "simulate", counted)
    argv = ["--device", "cpu", "--num-sim-steps", "5", "--raster-size", "64", "--hist-frames",
            "10", "--diffusion-steps", "3", "--seed", "7", "--output", str(tmp_path)]
    native.reset_launch_counts()
    native.count_launch("value_gather")  # counted before the call, and kept
    rep = rollout.main(argv)
    assert seeds == [7, 8]
    assert rep["launches"]["value_gather"] == 1
    assert native.launch_counts()["value_gather"] == 3
    assert rep["rules"] == [] and "guidance_satisfaction" not in rep
    assert rep["compile_and_first_run_s"] > 0 and rep["wall_clock_s"] > 0
    assert rep["agent_steps_per_sec"] == pytest.approx(4 * 5 / rep["wall_clock_s"])
    run = rollout.build(rollout.parse_args(argv))
    _, want = simulate(run.pack, run.policy, run.sim_cfg,
                       generator=torch.Generator().manual_seed(8))
    with np.load(tmp_path / "trajectories.npz") as f:
        assert f["trajectories"].shape == (5, 4, 4)
        np.testing.assert_array_equal(f["trajectories"], want.numpy())
    native.reset_launch_counts()


def test_train_cli_runs_every_stage_on_the_cpu_without_jax(tmp_path):
    """`python -m cld_tpu_torch.train --device cpu` on `cld_smoke` for 2 steps
    of each stage, each loading the stage before it, then a resumed run, in
    one subprocess that fails if any JAX-side module got imported."""
    out = tmp_path / "runs"
    code = f"""
import json, sys
from cld_tpu_torch import train
base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", {str(out)!r}]
train.main(base + ["--mode", "vae", "--steps", "2"])
vae = ["--vae-ckpt", {str(out / "vae" / "ckpt_final")!r}]
train.main(base + vae + ["--mode", "dm", "--steps", "2"])
dm = ["--dm-ckpt", {str(out / "dm" / "ckpt_final")!r}]
train.main(base + vae + dm + ["--mode", "ppo", "--steps", "2"])
train.main(base + vae + ["--mode", "dm", "--steps", "4",
                         "--resume", {str(out / "dm" / "ckpt_final_full")!r}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print("FORBIDDEN_IMPORTED=" + json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent),
               OMP_NUM_THREADS="2")  # torch's threads, as this process's
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN_IMPORTED=[]" in res.stdout, res.stdout[-500:]
    assert "resumed full train state" in res.stdout and "at step 2" in res.stdout
    for stage, steps in (("vae", [0, 1]), ("dm", [0, 1, 2, 3]), ("ppo", [0, 1])):
        files = sorted(p.name for p in (out / stage).iterdir())
        assert files == ["ckpt_final", "ckpt_final_full", "metrics.jsonl"], files
        records = [json.loads(line) for line in (out / stage / "metrics.jsonl").read_text()
                   .splitlines()]
        assert [r["step"] for r in records] == steps
        assert all(np.isfinite(v) for r in records for v in r.values())
    full = torch.load(out / "dm" / "ckpt_final_full", weights_only=True)
    assert full["step"] == 4 and full["loop_step"] == 4
    assert sorted(full) == ["loop_step", "opt_state", "params", "step"]


def test_train_cli_flags_and_unported_modes(tmp_path):
    """The JAX CLI's flag names and modes, `--device` defaulting to the
    card, and a data path without shards raising as the JAX loader does.
    The GAN, EBM and scene diffusion modes run a step each; `--precision
    bf16` runs a VAE step and an EBM step in bf16 compute."""
    base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", str(tmp_path)]
    for mode in ("scene_dm", "gan", "ebm"):
        state = train.main(base + ["--mode", mode, "--steps", "1"])
        assert state.step == 1 and (tmp_path / mode / "ckpt_final").exists(), mode
    state = train.main(base + ["--mode", "vae", "--precision", "bf16", "--steps", "1"])
    assert state.step == 1 and state.model.context_encoder.compute_dtype == torch.bfloat16
    state = train.main(base + ["--mode", "ebm", "--precision", "bf16", "--steps", "1"])
    assert state.step == 1 and state.model.compute_dtype == torch.bfloat16
    # packed shards are ported: a data path without shards fails as the JAX loader does
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"train:\n  data_path: {tmp_path / 'no_shards'}\n")
    with pytest.raises(FileNotFoundError, match="no split 'train'"):
        train.main(base + ["--mode", "vae", "--config", str(cfg), "--steps", "1"])
    src = Path(train.__file__).read_text()
    for flag in ("--config", "--registered-name", "--mode", "--output", "--steps", "--resume",
                 "--vae-ckpt", "--dm-ckpt", "--precision", "--device", "--zoo-algo"):
        assert f'"{flag}"' in src, flag
    assert 'add_argument("--device", type=str, default="cuda"' in src
    src_modes = ast.literal_eval(src.split('"--mode", type=str, default=None,')[1]
                                 .split("choices=")[1].split(")")[0])
    jax_src = (PKG.parent / "train.py").read_text()
    assert src_modes == ast.literal_eval(jax_src.split('"--mode", type=str, default=None,')[1]
                                         .split("choices=")[1].split(")")[0])
    if not torch.cuda.is_available():
        for mode in (["--mode", "vae"], ["--mode", "zoo", "--zoo-algo", "bc"], ["--mode", "ebm"]):
            with pytest.raises((RuntimeError, AssertionError)):
                train.main(["--registered-name", "cld_smoke", *mode, "--steps", "1",
                            "--output", str(tmp_path / "cuda")])


@pytest.mark.parametrize("start_step", [0, 3])
def test_train_cli_batch_stream_matches_the_jax_cli(start_step):
    """The port's train stream at step `start_step` (a fresh run, and a run
    resumed there) is the JAX CLI's: `make_loader(cfg, "train")`, one batch
    drawn for init, then `start_step` skipped. Field by field, exactly."""
    from cld_tpu.data.loader import make_loader as jax_make_loader
    from cld_tpu.utils.registry import get_registered_experiment_config as jax_config
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    it = iter(jax_make_loader(jax_config("cld_smoke"), "train"))
    for _ in range(1 + start_step):
        next(it)
    ours = train._batches(get_registered_experiment_config("cld_smoke"), "cpu", start_step)
    for _ in range(2):  # the step's batch and the next
        want, got = next(it), next(ours)
        assert set(got._fields) == set(want._fields)
        compared = 0
        for name in want._fields:
            w, g = getattr(want, name), getattr(got, name)
            if w is not None and g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
                compared += 1
        assert compared >= 9


@pytest.mark.parametrize("script", ["chip_smoke.py", "cld_tpu_torch/kernel_ab.py"])
def test_measurement_scripts_fail_without_a_card(script):
    """On a host without CUDA the scripts that time the card exit non-zero
    and print no result; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the script would run in full")
    res = subprocess.run([sys.executable, str(PKG.parent / script)], capture_output=True,
                         text=True, timeout=300, cwd=str(PKG.parent))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout and "{" not in res.stdout, res.stdout[-500:]
