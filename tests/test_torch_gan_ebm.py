"""The GAN and the EBM learned metric of the port against the JAX package's:
`PermuteEBM` and `ebm_infonce_loss`, `EBMTrainer`, the learned rollout
metric (`sim.learned_metrics`), `TrajectoryGAN` with both generators and
`GANTrainer`, each from the same weights (seeded flax variables converted by
`utils.weights.load_flax`, strict) on the same numpy-made inputs; then
`--mode gan|ebm` and the rollout CLI's `--ebm-ckpt` end to end on the CPU.

Fixture (`zoo_parity.py`): the `cld_smoke` widths (map feature and cond 32,
12 raster channels), raster 40, B=3, the synthetic batch with a dense
Gaussian raster. The GAN's noise is read off the JAX side's own draws
(`zoo_parity.record_draws`) and passed to the port.

Tolerances: in eval mode (running BatchNorm statistics) values at rtol
1e-5 and gradients at rtol 1e-4, each with a floor of 1e-5 of the tensor's
largest component. A train step (BatchNorm on the batch's statistics)
as in `test_torch_zoo_trainer.py`: losses and metrics at rtol 1e-4,
BatchNorm's running statistics at 1e-5, and the gradients of each update
within twice (+1e-5) the port's own float32 error on the same step, its
relative L2 distance to the step in float64 (train-mode BatchNorm on three
samples per channel is ill-conditioned in float32). The rollout metric's
scores compound a render and the networks: rtol 1e-4, floor 1e-5.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import zoo_parity as zp

from cld_tpu.models.gan import TrajectoryGAN as JGAN
from cld_tpu.models.learned_metric import PermuteEBM as JEBM
from cld_tpu.models.learned_metric import ebm_infonce_loss as jax_infonce
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu.sim.learned_metrics import ebm_rollout_scores as jax_rollout_scores
from cld_tpu.training import gan as jgan
from cld_tpu.training.ebm import EBMTrainer as JEBMTrainer
from cld_tpu.training.state import TrainStateWithStats
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.models.learned_metric import ebm_infonce_loss
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.sim.learned_metrics import ebm_rollout_metric, ebm_rollout_scores
from cld_tpu_torch.training import gan
from cld_tpu_torch.training.checkpoints import restore_pytree
from cld_tpu_torch.training.ebm import EBMTrainer
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
STEP = 5  # the JAX GAN trainer's state.step, folded into its rng
W = 32  # the cld_smoke map feature and cond widths


def smoke_config(get):
    cfg = get("cld_smoke").unlock()
    cfg.env.rasterizer.raster_size = zp.RASTER
    return cfg.lock()


def jax_ebm():
    return JEBM(map_feature_dim=W, traj_feature_dim=W, embedding_dim=W)


def jax_gan(arch):
    return JGAN(horizon=52, cond_feat_dim=W, generator_arch=arch)


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])


def assert_train_grads(got32: dict, want: dict, exact: dict, keys):
    """The port's float32 gradients against JAX's within twice (+1e-5) the
    port's own float32 error (its distance to the float64 step)."""
    got, want, exact = _flat(got32, keys), _flat(want, keys), _flat(exact, keys)
    err_jax = np.linalg.norm(got - want) / np.linalg.norm(exact)
    err_f32 = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    print(f"train-step gradients: {err_jax:.3e} from JAX, {err_f32:.3e} from float64")
    assert err_jax <= 2 * err_f32 + 1e-5, (err_jax, err_f32)


def double_model(model):
    """A float64 copy whose Linear layers also take float32 inputs in
    float64 (the positional and time embeddings are float32 by definition)."""
    import copy

    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if isinstance(mod, torch.nn.Linear):
            mod.register_forward_pre_hook(lambda _, args: tuple(a.double() for a in args))
    return m64


def grads_by_key(model, keys=None):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()
            if p.grad is not None and (keys is None or k in keys)}


def bn_stats_close(model, want: dict):
    n = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            zp.assert_close(v.numpy(), want[k], rtol=1e-5, floor=1e-5, msg=k)
            n += 1
    assert n > 0


def recording(tx, sink: list):
    """An optax transformation that appends the gradients it is given to
    `sink` (traced values, returned from the jitted function)."""
    def update(grads, opt_state, params=None):
        sink.append(grads)
        return tx.update(grads, opt_state, params)

    return optax.GradientTransformation(tx.init, update)


# -- the EBM ------------------------------------------------------------------


def test_infonce_loss_matches_jax():
    scores = np.random.default_rng(0).normal(size=(5, 5)).astype(np.float32)
    lj, gj = jax.value_and_grad(jax_infonce)(jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    lp = ebm_infonce_loss(s)
    lp.backward()
    zp.assert_close(float(lp.detach()), float(lj), rtol=1e-6, floor=0)
    zp.assert_close(s.grad.numpy(), np.asarray(gj), rtol=1e-5, floor=1e-6)


@pytest.fixture(scope="module")
def ebm_fixture():
    """The batches, seeded EBM variables, the port's config, and from one JAX
    compile: the model in eval mode (matched-pair scores, the InfoNCE value,
    the score matrix and embeddings, the gradients) and one JAX trainer step
    (its new state, metrics and gradients, read off its optimizer) with
    `score_fn` after it."""
    jb, tb = zp.batches()
    jm = jax_ebm()
    v = zp.random_variables(jm, jb)
    jtr = JEBMTrainer(smoke_config(jax_registry.get_registered_experiment_config))
    sink = []
    jstate = TrainStateWithStats.create(apply_fn=jtr.model.apply, params=v["params"],
                                        batch_stats=v["batch_stats"],
                                        tx=recording(jtr.optimizer, sink))

    # weights and batch are arguments: closed over, XLA would fold them
    # through the network at compile time
    @jax.jit
    def jax_side(v, jb, jstate):
        def loss(p):
            out = jm.apply(dict(v, params=p), jb)
            return jax_infonce(out["scores"]), out

        sink.clear()
        eval_out = (jm.apply(v, jb, method="get_scores"),
                    jax.value_and_grad(loss, has_aux=True)(v["params"]))
        new, m = jtr._train_step(jstate, jb, jax.random.key(8))
        return eval_out, (new, m, sink[0], jtr.score_fn(new)(jb))

    evaluated, stepped = jax_side(v, jb, jstate)
    cfg = smoke_config(registry.get_registered_experiment_config)
    return jb, tb, v, cfg, evaluated, stepped


def test_permute_ebm_matches_jax_in_eval_mode(ebm_fixture):
    """The score matrix, the embeddings, the matched-pair scores and the
    InfoNCE gradients in every parameter, with running statistics; the
    converted keys and shapes are the port module's."""
    jb, tb, v, cfg, (want_scores, ((lj, want), gj)), _ = ebm_fixture
    model = EBMTrainer(cfg, device="cpu").build()
    converted = tw.export_flax(model, v["params"], v["batch_stats"])
    assert {k: tuple(a.shape) for k, a in converted.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    tw.load_flax(model, v)
    got = model(tb)
    for k in ("scores", "features"):
        zp.assert_close(got[k].detach().numpy(), np.asarray(want[k]), msg=k)
    assert got["scores"].shape == (zp.B, zp.B)
    zp.assert_close(model.get_scores(tb).detach().numpy(), np.asarray(want_scores))
    # the diagonal of the matrix is the matched-pair score
    zp.assert_close(np.diag(got["scores"].detach().numpy()),
                    model.get_scores(tb).detach().numpy())

    model.zero_grad()
    lp = ebm_infonce_loss(model(tb)["scores"])
    lp.backward()
    zp.assert_close(float(lp.detach()), float(lj), rtol=1e-5, floor=0)
    zp.assert_grads_close(model, tw.export_flax(model, zp.np_tree(gj), v["batch_stats"]))


def test_ebm_trainer_step_matches_jax(ebm_fixture):
    """One `EBMTrainer.train_step` against the JAX trainer's from the same
    weights: loss, `infonce_acc` (its argmax is clear of ties here),
    BatchNorm statistics, gradients; then `eval_step` and `score_fn`."""
    jb, tb, v, cfg, _, (new_j, mj, gj, scores_after) = ebm_fixture
    trainer = EBMTrainer(cfg, device="cpu")
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    m64 = double_model(state.model)
    captured = {}
    state.optimizer.register_step_pre_hook(
        lambda *_: captured.update(grads_by_key(state.model)))
    state, mp = trainer.train_step(state, tb)
    assert state.step == 1
    for k in ("loss", "infonce_acc"):
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    bn_stats_close(state.model, tw.export_flax(state.model, v["params"],
                                               zp.np_tree(new_j.batch_stats)))
    keys = [k for k in captured if "bias_hh" not in k and not k.endswith(zp.ZERO_IN_EXACT)]
    scores64 = m64(zp.to_double(tb), train=True)["scores"]
    top2 = np.sort(scores64.detach().numpy(), axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-3).all()  # no near-tie under the argmax
    ebm_infonce_loss(scores64).backward()
    assert_train_grads(captured, tw.export_flax(state.model, zp.np_tree(gj), v["batch_stats"]),
                       grads_by_key(m64), keys)

    # after one step the two packages' weights differ where Adam's first step
    # divides a gradient of rounding size by itself: rtol 1e-3
    ep = trainer.eval_step(state, tb)
    ej = {"score_mean": np.mean(scores_after), "score_std": np.std(scores_after)}  # JAX's eval_step
    assert set(ep) == set(ej)
    for k in ep:
        zp.assert_close(float(ep[k]), float(ej[k]), rtol=1e-3, floor=1e-4, msg=k)
    zp.assert_close(trainer.score_fn(state)(tb).detach().numpy(), np.asarray(scores_after),
                    rtol=1e-3, floor=1e-4)


def test_ebm_nonfinite_loss_keeps_the_state(ebm_fixture):
    """A batch whose raster is NaN: the step is skipped; parameters,
    moments, BatchNorm statistics and the step count stay."""
    tb, cfg = ebm_fixture[1], ebm_fixture[3]
    trainer = EBMTrainer(cfg, device="cpu")
    state = trainer.init_state(1)
    state, _ = trainer.train_step(state, tb)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    moments = [t.clone() for s in state.optimizer.state.values() for t in s.values()]
    state, m = trainer.train_step(state, tb._replace(image=tb.image * float("nan")))
    assert not np.isfinite(float(m["loss"])) and state.step == 1
    for k, t in state.model.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0, msg=k)
    after = [t for s in state.optimizer.state.values() for t in s.values()]
    for a, b in zip(after, moments):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("horizon,stride", [(8, 8), (52, 10)])
def test_ebm_rollout_scores_match_jax(ebm_fixture, horizon, stride):
    """The learned metric of a 20-frame log of the port's simulator (2 scenes
    x 3 agents, turning), re-rendered at each anchor: anchors below T - 1,
    futures clamped past the log's end with availability 0."""
    v, cfg = ebm_fixture[2], ebm_fixture[3]
    kw = dict(seed=0, num_scenes=2, agents_per_scene=3, world_map_size=256, sim_steps=20)
    sim_kw = dict(num_simulation_steps=20, n_step_action=5, raster_size=zp.RASTER,
                  hist_frames=zp.HIST)
    jp, tp = jscene.synthetic_scene_pack(**kw), tscene.synthetic_scene_pack(**kw, device="cpu")

    def turning(obs, rng):
        u = torch.zeros((obs.curr_speed.shape[0], 52, 2))
        u[..., 0], u[..., 1] = 1.0, 0.3
        return u

    _, traj = tenv.simulate(tp, turning, tenv.SimConfig(**sim_kw))
    model = tw.load_flax(EBMTrainer(cfg, device="cpu").build(), v)
    jm = jax_ebm()
    with torch.no_grad():
        got = ebm_rollout_scores(tp, traj, model.get_scores, tenv.SimConfig(**sim_kw),
                                 horizon=horizon, stride=stride)
    want = jax.jit(lambda v, tr: jax_rollout_scores(
        jp, tr, lambda obs: jm.apply(v, obs, method="get_scores"), jenv.SimConfig(**sim_kw),
        horizon=horizon, stride=stride))(v, jnp.asarray(traj.numpy()))
    assert got.shape == want.shape == (len(range(0, 19, stride)), 6)
    zp.assert_close(got.numpy(), np.asarray(want), rtol=1e-4, floor=1e-5)
    with torch.no_grad():
        m = ebm_rollout_metric(tp, traj, model.get_scores, tenv.SimConfig(**sim_kw),
                               horizon=horizon, stride=stride)
    assert float(m["ebm_score_min"]) == float(got.min())
    assert m["ebm_score_per_agent"].shape == (6,)


# -- the GAN ------------------------------------------------------------------


@pytest.fixture(scope="module", params=["mlp", "transformer"])
def gan_fixture(request):
    """Both generators: the batches, seeded GAN variables, and from one JAX
    compile the model in eval mode (the losses, trajectories and means, and
    the gradients of d_loss + 3 g_loss) and one JAX trainer step at step
    `STEP` (its new state and metrics, and each update's gradients read off
    its optimizers), with the noise each drew."""
    arch = request.param
    jb, tb = zp.batches()
    jm = jax_gan(arch)
    v = zp.random_variables(jm, jb, rngs=("params", "sample"))
    jcfg = smoke_config(jax_registry.get_registered_experiment_config).unlock()
    jcfg.algo.gan_generator_arch = arch
    jtr = jgan.GANTrainer(jcfg.lock())
    g_sub, d_sub = jgan._split_params(v["params"])
    jstate = jgan.GANTrainState(params=v["params"], batch_stats=v["batch_stats"],
                                g_opt_state=jtr.g_opt.init(g_sub),
                                d_opt_state=jtr.d_opt.init(d_sub), step=jnp.int32(STEP))
    sink = []
    jtr.d_opt, jtr.g_opt = recording(jtr.d_opt, sink), recording(jtr.g_opt, sink)

    def jax_side(v, jb, jstate):
        def loss(p):
            out = jm.apply(dict(v, params=p), jb, rngs={"sample": jax.random.key(3)})
            return out["d_loss"] + 3.0 * out["g_loss"], out

        evaluated = jax.grad(loss, has_aux=True)(v["params"])
        sink.clear()
        return evaluated, (jtr._train_step(jstate, jb, jax.random.key(12)), list(sink))

    drawn, (evaluated, stepped) = zp.record_draws(pytest.MonkeyPatch(), jax_side, v, jb, jstate,
                                                  keep_output=True)
    # the eval call's draw, then the step's discriminator and generator draws
    assert len(drawn["normal"]) == 3 and drawn["normal"][0].shape == (zp.B, 16)
    return dict(arch=arch, jb=jb, tb=tb, v=v, d_sub=d_sub, evaluated=evaluated,
                stepped=stepped, eval_z=drawn["normal"][0], step_z=drawn["normal"][1:])


def port_gan(arch, v):
    """The port's trainer and a state holding the JAX weights."""
    cfg = smoke_config(registry.get_registered_experiment_config).unlock()
    cfg.algo.gan_generator_arch = arch
    trainer = gan.GANTrainer(cfg.lock(), device="cpu")
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    return trainer, state


def test_trajectory_gan_matches_jax_in_eval_mode(gan_fixture):
    """Both views of the LSGAN losses, the trajectories and the
    discriminator means from the JAX side's own noise draw, and the
    gradients of d_loss + 3 g_loss in every parameter (one backward through
    both views); `generate` with two samples per agent."""
    f = gan_fixture
    tb, v, (grads, want) = f["tb"], f["v"], f["evaluated"]
    _, state = port_gan(f["arch"], v)
    model = state.model
    assert set(model.state_dict()) == set(tw.export_flax(model, v["params"], v["batch_stats"]))
    zt = torch.tensor(f["eval_z"])
    got = model(tb, zt)
    for k in ("d_loss", "g_loss", "trajectories", "d_real_mean", "d_fake_mean"):
        zp.assert_close(got[k].detach().numpy(), np.asarray(want[k]), msg=k)
    (got["d_loss"] + 3.0 * got["g_loss"]).backward()
    zp.assert_grads_close(model, tw.export_flax(model, zp.np_tree(grads), v["batch_stats"]))
    # num_samp samples per agent: agent b takes rows b * num_samp ... of z
    with torch.no_grad():
        traj, _ = model.generate(tb, torch.repeat_interleave(zt, 2, dim=0), num_samp=2)
    assert traj.shape == (zp.B, 2, 52, 6)
    torch.testing.assert_close(traj[:, 1], got["trajectories"].detach(), rtol=0, atol=0)


def test_gan_train_step_matches_jax(gan_fixture):
    """One `GANTrainer.train_step` against the JAX trainer's, from the same
    weights and the JAX step's two noise draws: the metrics; the
    discriminator update's gradients (generator side frozen) at the old
    weights; the generator update's gradients through the updated
    discriminator (each package's own); BatchNorm statistics that are the
    generator pass's, from the statistics before the step (the
    discriminator pass's are dropped); and each side's update touching only
    its own parameters."""
    f = gan_fixture
    tb, v = f["tb"], f["v"]
    (new_j, mj), (gd, gg) = f["stepped"]
    trainer, state = port_gan(f["arch"], v)
    model = state.model
    m64 = double_model(model)
    seen = {}
    state.d_optimizer.register_step_pre_hook(lambda *_: seen.update(
        d=grads_by_key(model), before_d={k: t.clone() for k, t in model.state_dict().items()}))
    state.g_optimizer.register_step_pre_hook(lambda *_: seen.update(
        g=grads_by_key(model), before_g={k: t.clone() for k, t in model.state_dict().items()}))
    z_d, z_g = (torch.tensor(a) for a in f["step_z"])
    state, mp = trainer.train_step(state, tb, noise=(z_d, z_g))
    assert state.step == 1
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    bn_stats_close(model, tw.export_flax(model, v["params"], zp.np_tree(new_j.batch_stats)))

    # the discriminator update: only the discriminator has a gradient
    assert all(k.startswith("discriminator.") for k in seen["d"])
    m64(zp.to_double(tb), z_d.double(), train=True)["d_loss"].backward()
    bs = v["batch_stats"]
    want_d = tw.export_flax(model, zp.np_tree(dict(v["params"], **gd)), bs)
    d_keys = sorted(seen["d"])
    assert_train_grads(seen["d"], want_d, grads_by_key(m64, d_keys), d_keys)

    # the generator update: the port's through its updated discriminator,
    # JAX's through its own (the two differ only where Adam's first step
    # divides a gradient of rounding size by itself)
    sd_g = seen["before_g"]
    assert not any(k.startswith("discriminator.") for k in seen["g"])
    m64 = double_model(model)
    m64.load_state_dict({k: t.double() if t.is_floating_point() else t
                         for k, t in sd_g.items()})
    for p in m64.discriminator.parameters():
        p.requires_grad_(False)
    m64(zp.to_double(tb), z_g.double(), train=True)["g_loss"].backward()
    g_keys = sorted(k for k in seen["g"] if "bias_hh" not in k
                    and not k.endswith(zp.ZERO_IN_EXACT))
    want_g = tw.export_flax(model, zp.np_tree(dict(gg, **f["d_sub"])), bs)
    assert_train_grads(seen["g"], want_g, grads_by_key(m64, g_keys), g_keys)

    # each update moved its side only
    sd = model.state_dict()
    for k, t in sd.items():
        if not k.endswith(("weight", "bias")):
            continue
        d_side = k.startswith("discriminator.")
        assert torch.equal(seen["before_g"][k], seen["before_d"][k]) != d_side, k
        assert torch.equal(t, seen["before_g"][k]) == d_side, k


# -- the CLIs ----------------------------------------------------------------


def test_train_cli_gan_and_ebm_and_rollout_ebm_ckpt_end_to_end(tmp_path):
    """`python -m cld_tpu_torch.train --device cpu` on `cld_smoke`: `--mode
    gan` with both generators (`ckpt_final`, no `_full` file), `--mode ebm`
    2 steps then `--resume` to 3, then the rollout CLI with `--ebm-ckpt` on
    that `ckpt_final` reporting `ebm_score_mean` / `ebm_score_min`, in one
    process that imports no JAX."""
    out = tmp_path / "runs"
    code = f"""
import json, sys
from cld_tpu_torch import rollout, train
base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", {str(out)!r}]
train.main(base + ["--mode", "gan", "--steps", "2"])
cfg = {str(tmp_path / "tgan.json")!r}
json.dump({{"algo": {{"gan_generator_arch": "transformer"}}}}, open(cfg, "w"))
train.main(base + ["--mode", "gan", "--steps", "1", "--config", cfg,
                   "--output", {str(out / "tgan")!r}])
train.main(base + ["--mode", "ebm", "--steps", "2"])
train.main(base + ["--mode", "ebm", "--steps", "3",
                   "--resume", {str(out / "ebm" / "ckpt_final_full")!r}])
rep = rollout.main(["--registered-name", "cld_smoke", "--device", "cpu", "--num-sim-steps",
                    "20", "--agents-per-scene", "2", "--raster-size", "64",
                    "--ebm-ckpt", {str(out / "ebm" / "ckpt_final")!r},
                    "--output", {str(tmp_path / "roll")!r}])
print("EBM=" + json.dumps([rep["ebm_score_mean"], rep["ebm_score_min"]]))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cld_tpu"))
print("FORBIDDEN_IMPORTED=" + json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN_IMPORTED=[]" in res.stdout, res.stdout[-500:]
    assert "resumed full train state" in res.stdout and "at step 2" in res.stdout
    for stage, files in (("gan", ["ckpt_final", "metrics.jsonl"]),
                         ("tgan/gan", ["ckpt_final", "metrics.jsonl"]),
                         ("ebm", ["ckpt_final", "ckpt_final_full", "metrics.jsonl"])):
        assert sorted(p.name for p in (out / stage).iterdir()) == files, stage
        recs = [json.loads(x) for x in (out / stage / "metrics.jsonl").read_text().splitlines()]
        assert all(np.isfinite(val) for r in recs for val in r.values())
    recs = [json.loads(x) for x in (out / "gan" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert set(recs[0]) == {"step", "train/d_loss", "train/g_loss", "train/d_real_mean",
                            "train/d_fake_mean"}
    sd = restore_pytree(str(out / "tgan" / "gan" / "ckpt_final"))["params"]
    assert "generator.attn0.query.weight" in sd
    recs = [json.loads(x) for x in (out / "ebm" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2] and "train/infonce_acc" in recs[0]
    ebm = json.loads(res.stdout.split("EBM=")[1].splitlines()[0])
    assert np.isfinite(ebm).all() and ebm[1] <= ebm[0]
    with pytest.raises(SystemExit, match="no full-state checkpoint"):
        from cld_tpu_torch import train

        train.main(["--registered-name", "cld_smoke", "--device", "cpu", "--mode", "gan",
                    "--resume", str(out / "ebm" / "ckpt_final_full"), "--output",
                    str(tmp_path / "x")])
