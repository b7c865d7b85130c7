"""The port's tools against the JAX package's: the timers and the device
trace (`utils/timer.py`), config sweeps and checkpoint lookup
(`utils/experiment.py`), the wandb sink (`utils/wandb_logging.py`), and
data parallelism (`parallel/mesh.py`): two gloo ranks under torchrun take
the step of one process on the global batch, and world size 1 changes
nothing."""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cld_tpu.utils.config import default_config as jax_default_config
from cld_tpu.utils.experiment import ParamRange as JRange
from cld_tpu.utils.experiment import ParamSearchPlan as JPlan
from cld_tpu.utils.experiment import find_checkpoint as jax_find_checkpoint
from cld_tpu_torch.data.loader import make_loader
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.parallel import mesh as pm
from cld_tpu_torch.training.checkpoints import save_pytree
from cld_tpu_torch.utils.config import default_config
from cld_tpu_torch.utils.experiment import ParamRange, ParamSearchPlan, find_checkpoint
from cld_tpu_torch.utils.registry import get_registered_experiment_config
from cld_tpu_torch.utils.timer import Timers, device_trace
from cld_tpu_torch.utils.wandb_logging import WandbSink

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


# -- timers and traces --------------------------------------------------------


def test_timers_report_totals_counts_and_averages():
    timers = Timers()
    for _ in range(3):
        with timers.timed("step"):
            time.sleep(0.002)
    timers.tic("render")
    assert timers.toc("render") >= 0.0
    rep = timers.report()
    assert sorted(rep) == ["render", "step"]
    assert rep["step"]["count"] == 3 and rep["render"]["count"] == 1
    assert rep["step"]["total"] >= 0.006
    assert rep["step"]["average"] == pytest.approx(rep["step"]["total"] / 3)
    assert str(timers).startswith("step: ") and "x3" in str(timers)


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """On the CPU the trace holds the host's operators; the file is a Chrome
    trace (JSON with `traceEvents`)."""
    x = torch.randn(64, 64)
    with device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        (x @ x).sum()
    path = Path(prof.trace_path)
    assert path.parent == tmp_path / "trace" and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names, sorted(n for n in names if n)[:20]


# -- sweeps, checkpoint lookup, wandb -----------------------------------------


def test_param_search_plan_gives_the_jax_runs():
    """The same ranges over the two packages' default configs give the same
    run names in the same order, the swept values at their paths, and
    otherwise the defaults; the configs come out locked."""
    def ranges(R):
        return [R("algo.cond_feat_dim", [32, 64]), R("train.training.batch_size", [4, 8], "bs"),
                R("algo.map_encoder_model_arch", ["resnet18", "resnet50"])]

    ours = list(ParamSearchPlan(default_config(), ranges(ParamRange)).generate())
    want = list(JPlan(jax_default_config(), ranges(JRange)).generate())
    assert [n for n, _ in ours] == [n for n, _ in want]
    assert ours[0][0] == "cond_feat_dim=32_bs=4_map_encoder_model_arch=resnet18"
    assert len(ours) == 8
    for (_, c), (_, w) in zip(ours, want):
        assert c.to_dict() == w.to_dict()
        with pytest.raises(KeyError):
            c.algo["no_such_key"] = 1


def test_find_checkpoint_finds_port_files_and_directories(tmp_path):
    """The port's `ckpt_final` is a file: found by key, as the JAX lookup
    finds orbax directories (which the port's finds too)."""
    final = tmp_path / "runs" / "vae" / "ckpt_final"
    save_pytree(str(final), {"params": {"w": torch.zeros(2)}})
    save_pytree(str(tmp_path / "runs" / "vae" / "ckpt_200"), {"params": {}})
    (tmp_path / "runs" / "dm" / "ckpt_400").mkdir(parents=True)
    assert find_checkpoint(str(tmp_path)) == str(final)
    assert find_checkpoint(str(tmp_path), "200") == str(tmp_path / "runs" / "vae" / "ckpt_200")
    assert (find_checkpoint(str(tmp_path), "400") == jax_find_checkpoint(str(tmp_path), "400")
            == str(tmp_path / "runs" / "dm" / "ckpt_400"))
    with pytest.raises(FileNotFoundError):
        jax_find_checkpoint(str(tmp_path), "final")  # files are not orbax checkpoints
    with pytest.raises(FileNotFoundError):
        find_checkpoint(str(tmp_path), "999")


def test_wandb_sink_is_inactive_without_the_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    sink = WandbSink("cld", run_name="r", config={"a": 1})
    assert not sink.active
    assert "wandb" in sink.reason
    sink.log(0, {"loss": 1.0})  # no-ops
    sink.finish()


# -- data parallelism ---------------------------------------------------------

# The steps both sides take, written beside the torchrun worker and imported
# by the test: one VAE step (float32: the averaged gradients; float64: the
# parameters and BatchNorm statistics after the update, away from Adam's
# first-step sign amplification of rounding), one EBM step (float64), and
# in float32 one denoiser step (its gradients) and PPO (a collection and an
# update phase), each on the global batch in one process or on this rank's
# rows under `mesh`.
STEPS = textwrap.dedent('''
    import torch
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.models.vae import dropout_keep_mask
    from cld_tpu_torch.parallel import mesh as pm
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.ebm import EBMTrainer
    from cld_tpu_torch.training.ppo import PPOTrainer, buffer_add, buffer_init
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    B = 4


    def inputs(cfg, dtype):
        """The global batch (a dense Gaussian raster: BatchNorm over the
        mostly-zero synthetic one is ill-conditioned) and the VAE's draws."""
        g = torch.Generator().manual_seed(5)
        batch = synthetic_batch(seed=3, batch_size=B, raster_size=64,
                                hist_frames=cfg.algo.history_num_frames, device="cpu")
        batch = batch._replace(image=torch.randn(batch.image.shape, generator=g))
        batch = batch._replace(**{k: v.to(dtype) for k, v in batch._asdict().items()
                                  if torch.is_tensor(v) and v.is_floating_point()})
        T, L, H = cfg.algo.horizon, cfg.algo.vae.latent_size, cfg.algo.vae.hidden_size
        noise = torch.randn((B, T, L), generator=g).to(dtype)
        masks = tuple(dropout_keep_mask((B, T, H), g, "cpu").to(dtype) for _ in range(2))
        return batch, noise, masks


    def take(state, mesh):
        if mesh is not None:
            pm.replicate(state.model, mesh)
            state.mesh = mesh
        return state


    def record_grads(state):
        """{'grad.<name>': the gradient the optimizer's next update takes}, filled
        in when it takes it."""
        grads, step = {}, state.optimizer.step

        def recorded(*a, **k):
            grads.update({"grad." + n: p.grad.clone() for n, p in state.model.named_parameters()
                          if p.grad is not None})
            return step(*a, **k)

        state.optimizer.step = recorded
        return grads


    def vae_step(mesh, dtype):
        """{'grad.<name>': gradient before the update, '<name>': the state
        after it}, one step at rate 1e-3."""
        cfg = get_registered_experiment_config("cld_smoke")
        trainer = VAETrainer(cfg, device="cpu")
        state = trainer.init_state(0)
        state.model.to(dtype)
        state = take(state, mesh)
        state.lr_schedule = lambda step: 1e-3  # cld_smoke's first epoch has rate 0
        batch, noise, masks = inputs(cfg, dtype)
        if mesh is not None:
            batch, noise = pm.shard_batch(batch, mesh), pm.shard_batch(noise, mesh)
            masks = tuple(pm.shard_batch(m, mesh) for m in masks)
        grads = record_grads(state)
        trainer.train_step(state, batch, noise=noise, keep_masks=masks)
        return {**grads, **{k: v.clone() for k, v in state.model.state_dict().items()}}


    def ebm_step(mesh):
        """The EBM's state after one InfoNCE step (float64)."""
        cfg = get_registered_experiment_config("cld_smoke")
        trainer = EBMTrainer(cfg, device="cpu")
        state = trainer.init_state(0)
        state.model.double()
        state = take(state, mesh)
        batch = inputs(cfg, torch.float64)[0]
        if mesh is not None:
            batch = pm.shard_batch(batch, mesh)
        trainer.train_step(state, batch)
        return {k: v.clone() for k, v in state.model.state_dict().items()}


    def denoiser(cfg, mesh):
        """The DM trainer on a fresh VAE and its state, at rate 1e-3."""
        dm = DMTrainer(cfg, VAETrainer(cfg, device="cpu").init_state(0).model, device="cpu")
        state = dm.init_state(2)
        state.lr_schedule = lambda step: 1e-3
        return dm, take(state, mesh)


    def draws(seed, *shapes):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(s, generator=g) for s in shapes]


    def dm_step(mesh):
        """The denoiser's gradient in its first step (float32: the
        temporal UNet runs in float32 only)."""
        cfg = get_registered_experiment_config("cld_smoke")
        dm, state = denoiser(cfg, mesh)
        batch = inputs(cfg, torch.float32)[0]
        T, L = cfg.algo.horizon, cfg.algo.vae.latent_size
        enc_noise, noise = draws(6, (B, T, L), (B, T, L))
        t = torch.arange(B) % cfg.algo.n_diffusion_steps
        if mesh is not None:
            batch, enc_noise, noise, t = (pm.shard_batch(x, mesh)
                                          for x in (batch, enc_noise, noise, t))
        grads = record_grads(state)
        dm.train_step(state, batch, enc_noise=enc_noise, t=t, noise=noise)
        return grads


    def ppo_step(mesh):
        """PPO (float32): one collection, 2 samples an agent, into the global
        buffer (its transitions and baseline); then an update phase of 2
        iterations on given global minibatches of 4 from a buffer of 16
        random transitions (the state after the phase and the phase's
        metrics over the ranks). For the phase, SGD takes Adam's place (Adam's
        first steps turn rounding into a sign) and sigma at t = 0 is 1, not the
        schedule's 1e-10, at which a rounding difference of 1e-7 in the
        recomputed mean moves the log-prob by ~1e3: no two splits of one
        minibatch would agree."""
        cfg = get_registered_experiment_config("cld_smoke").unlock()
        cfg.algo.num_samp = N = 2
        cfg = cfg.lock()
        a = cfg.algo
        dm, state = denoiser(cfg, mesh)
        ppo = PPOTrainer(cfg, dm)
        new_buffer = lambda: buffer_init(a.buffer_max, a.horizon, a.vae.latent_size,
                                         a.cond_feat_dim, device="cpu")
        batch = inputs(cfg, torch.float32)[0]
        shape = (B * N, a.horizon, a.vae.latent_size)
        x_init, step_noises = draws(7, shape, (a.n_diffusion_steps,) + shape)
        if mesh is not None:
            batch, x_init = pm.shard_batch(batch, mesh), pm.shard_batch(x_init, mesh)
            step_noises = pm.shard_batch(step_noises.transpose(0, 1), mesh).transpose(0, 1)
        buf = new_buffer()
        _, collected = ppo.collect_step(state, buf, batch, x_init=x_init,
                                        step_noises=step_noises)
        out = {f"buf.{k}": getattr(buf, k).clone()
               for k in ("x0", "x1", "log_p", "reward", "cond_feat", "baseline")}

        log_var = dm.schedule.posterior_log_variance_clipped.clone()
        log_var[0] = 0.0
        dm.schedule = dm.schedule._replace(posterior_log_variance_clipped=log_var)
        state.optimizer = torch.optim.SGD(state.model.parameters(), lr=0.0)
        state.lr_schedule = lambda step: 1e-2
        x0, x1, log_p, reward, cond = draws(9, (16,) + shape[1:], (16,) + shape[1:], (16,), (16,),
                                            (16, a.cond_feat_dim))
        buf = buffer_add(new_buffer(), x0, x1, 0.3 * log_p - 1.5, reward, cond)
        indices = torch.randint(0, 16, (2, a.ppo_mini_batch),
                                generator=torch.Generator().manual_seed(8))
        _, metrics = ppo.ppo_update(state, buf, indices=indices)
        metrics = pm.mean_over_ranks({"reward": collected["reward"], **metrics}, mesh)
        out.update({f"metric.{k}": v.reshape(()) for k, v in metrics.items()})
        return {**out, **{k: v.clone() for k, v in state.model.state_dict().items()}}


    def all_steps(mesh):
        return {"vae32": vae_step(mesh, torch.float32), "vae64": vae_step(mesh, torch.float64),
                "ebm64": ebm_step(mesh), "dm32": dm_step(mesh), "ppo32": ppo_step(mesh)}
''')

WORKER = textwrap.dedent('''
    import json, sys
    import torch
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {here!r})
    torch.set_num_threads(1)
    import dp_steps
    from cld_tpu_torch import train
    from cld_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    torch.save(dp_steps.all_steps(mesh), {here!r} + f"/rank{{mesh.rank}}.pt")
    # the CLI on the same process group: rank 0 logs the ranks' mean and writes
    for mode in ("vae", "ppo"):
        train.main(["--registered-name", "cld_smoke", "--mode", mode, "--device", "cpu",
                    "--steps", "2", "--output", {runs!r}])
    print("RANK_DONE", mesh.rank, mesh.world_size, flush=True)
''')


def _steps_module(path: Path):
    path.write_text(STEPS)
    spec = importlib.util.spec_from_file_location("dp_steps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_tree_close(got: dict, want: dict, rtol: float, what: str):
    """Every floating entry within rtol of its own largest |entry| (plus 1e-7
    of it where it is 0); integer entries equal."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k]
        if w.is_floating_point():
            scale = max(float(w.abs().max()), 1e-7)
            err = float((g - w).abs().max())
            assert err <= rtol * scale, f"{what} {k}: {err:.3e} against {scale:.3e}"
        else:
            assert torch.equal(g, w), f"{what} {k}"


def test_world_size_one_leaves_the_step_bit_identical(tmp_path, monkeypatch):
    """Without torchrun's environment `make_mesh` is world size 1: no group,
    `shard_batch`, `gather_rows` and `replicate` leave batch and module as
    they are, and a VAE step, an EBM step and PPO's collection and update
    phase on a state that carries the mesh equal the plain ones bit for
    bit."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    mesh = pm.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.active, mesh.is_main) == (0, 1, False, True)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="dp=2"):
        pm.make_mesh(2, device="cpu")
    steps = _steps_module(tmp_path / "dp_steps.py")
    for run in (lambda m: steps.vae_step(m, torch.float32), steps.ebm_step, steps.ppo_step):
        plain, meshed = run(None), run(mesh)
        assert sorted(plain) == sorted(meshed)
        for k in plain:
            assert torch.equal(plain[k], meshed[k]), k
    x = torch.arange(6.0)
    assert pm.shard_batch(x, mesh) is x
    assert pm.gather_rows(x, mesh) is x and pm.broadcast_from_main(x, mesh) is x
    assert pm.max_over_ranks(x, mesh) is x
    metrics = {"loss": x[0]}
    assert pm.mean_over_ranks(metrics, mesh) is metrics


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """`torchrun --standalone --nproc-per-node 2` on the CPU (gloo): each rank
    takes `all_steps` on its half of the global batch of 4, then the train
    CLI on the same group (2 VAE steps, 2 PPO collections). -> (the ranks'
    results, one process's on all 4, the torchrun output, the CLI's output
    directory)."""
    tmp = tmp_path_factory.mktemp("dp")
    steps = _steps_module(tmp / "dp_steps.py")
    runs = tmp / "runs"
    worker = tmp / "worker.py"
    worker.write_text(WORKER.format(root=str(ROOT), here=str(tmp), runs=str(runs)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", str(worker)],
                         capture_output=True, text=True, env=env, timeout=300, cwd=str(tmp))
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert "RANK_DONE 0 2" in res.stdout and "RANK_DONE 1 2" in res.stdout
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(2)]
    return ranks, steps.all_steps(None), res.stdout, runs


def _grads(d):
    return {k: v for k, v in d.items() if k.startswith("grad.")}


def test_two_gloo_ranks_take_the_global_batch_step(two_ranks):
    """Two gloo ranks against one process on the global batch. In float64
    the VAE's averaged gradients, and after the update the VAE's and the
    EBM's parameters and BatchNorm running statistics, within 1e-5 of each
    tensor's largest entry (the EBM contrasts every rank's trajectories); in
    float32 the gradients within float32's own spread; both ranks hold the
    same state, bit for bit. Then the train CLI on the same group: 2 VAE
    steps, one `metrics.jsonl` and one `ckpt_final` written by rank 0."""
    ranks, want, stdout, runs = two_ranks
    for part in ranks[0]:
        for k in ranks[0][part]:
            assert torch.equal(ranks[0][part][k], ranks[1][part][k]), (part, k)
    got = ranks[0]
    grads = _grads
    assert len(grads(want["vae64"])) > 50
    _assert_tree_close(grads(got["vae64"]), grads(want["vae64"]), 1e-5, "VAE float64 gradient")
    state = lambda d: {k: v for k, v in d.items() if not k.startswith("grad.")}
    assert any("running_var" in k for k in state(want["vae64"]))
    _assert_tree_close(state(got["vae64"]), state(want["vae64"]), 1e-5, "VAE float64 state")
    _assert_tree_close(got["ebm64"], want["ebm64"], 1e-5, "EBM float64 state")
    # float32: train-mode BatchNorm over 2 x 2 maps of 4 samples puts the one-process
    # gradient up to 8e-2 of its tensor's largest entry away from float64's; the ranks'
    # gradient stays within twice that spread of it (plus 1e-5 of the largest entry)
    for k, w64 in grads(want["vae64"]).items():
        w32, g32 = want["vae32"][k].double(), got["vae32"][k].double()
        spread = float((w32 - w64).abs().max())
        err = float((g32 - w32).abs().max())
        assert err <= 2 * spread + 1e-5 * float(w64.abs().max()), (k, err, spread)

    out = runs / "vae"
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_final", "ckpt_final_full",
                                                     "metrics.jsonl"]
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert "rank=0/2" in stdout and "rank=1/2" in stdout


def test_two_gloo_ranks_take_the_global_dm_and_ppo_steps(two_ranks):
    """The denoiser and PPO under two gloo ranks against one process on the
    global batch, in float32 (the temporal UNet's only dtype): the DM
    step's averaged gradients within 1e-5 of each tensor's largest entry;
    PPO's collection fills the same global buffer on every rank, the
    transitions in the global batch's order and the baseline the global
    mean reward's, within 1e-5; after an update phase on the global
    minibatches, split over the ranks, the denoiser and the phase's metrics
    (`ratio_max` the ranks' largest) within 1e-5. Then the CLI's PPO stage
    on the group: 2 collections, written by rank 0."""
    ranks, want, stdout, runs = two_ranks
    got = ranks[0]
    assert len(_grads(want["dm32"])) > 20
    _assert_tree_close(got["dm32"], want["dm32"], 1e-5, "DM float32 gradient")
    buf = lambda d: {k: v for k, v in d.items() if k.startswith("buf.")}
    assert float(want["ppo32"]["buf.reward"][8:].abs().max()) == 0.0  # 4 agents x 2 samples
    _assert_tree_close(buf(got["ppo32"]), buf(want["ppo32"]), 1e-5, "PPO buffer")
    metrics = {k: v for k, v in want["ppo32"].items() if k.startswith("metric.")}
    assert 0.0 < float(metrics["metric.clip_fraction"]) < 1.0
    for k, w in metrics.items():
        assert abs(float(got["ppo32"][k] - w)) <= 1e-5 * max(abs(float(w)), 1.0), k
    params = {k: v for k, v in want["ppo32"].items() if not k.startswith(("buf.", "metric."))}
    _assert_tree_close({k: got["ppo32"][k] for k in params}, params, 1e-5, "PPO state")

    out = runs / "ppo"
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_final", "ckpt_final_full",
                                                     "metrics.jsonl"]
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train/reward"]) for r in records)


def test_a_rank_makes_only_its_rows_of_the_synthetic_batch():
    """Under data parallelism the synthetic loader's batches are the rank's
    rows of the global ones, bit for bit, and a rank paints no other row."""
    glob = synthetic_batch(seed=3, batch_size=4, raster_size=32, hist_frames=4, horizon=8,
                           device="cpu")
    for rank in range(2):
        mine = synthetic_batch(seed=3, batch_size=4, raster_size=32, hist_frames=4, horizon=8,
                               device="cpu", rank=rank, world_size=2)
        for k, v in glob._asdict().items():
            if torch.is_tensor(v):
                assert torch.equal(getattr(mine, k), v[2 * rank:2 * rank + 2]), k
    with pytest.raises(ValueError, match="does not divide"):
        synthetic_batch(seed=3, batch_size=3, raster_size=32, device="cpu", rank=0,
                        world_size=2)
    cfg = get_registered_experiment_config("cld_smoke")
    loader = make_loader(cfg, "train", device="cpu", rank=1, world_size=2)
    first = next(iter(loader))
    want = next(iter(make_loader(cfg, "train", device="cpu")))
    assert first.batch_size == 2
    assert torch.equal(first.image, want.image[2:])
