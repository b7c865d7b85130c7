"""The EBM learned metric of the port against the JAX package's:
`PermuteEBM` and `ebm_infonce_loss`, `EBMTrainer` and the learned rollout
metric (`sim.learned_metrics`), each from the same weights (seeded flax
variables converted by `utils.weights.load_flax`, strict) on the same
numpy-made inputs. `--mode ebm` and the rollout CLI's `--ebm-ckpt` run end to
end in `test_torch_gan.py`'s CLI test.

Fixture (`zoo_parity.py`, `gan_ebm_parity.py`): the `cld_smoke` widths (map
feature and cond 32, 12 raster channels), raster 40, B=3, the synthetic
batch with a dense Gaussian raster.

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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp
from gan_ebm_parity import (
    assert_train_grads,
    bn_stats_close,
    double_model,
    grads_by_key,
    jax_ebm,
    recording,
    smoke_config,
)

from cld_tpu.models.learned_metric import ebm_infonce_loss as jax_infonce
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu.sim.learned_metrics import ebm_rollout_scores as jax_rollout_scores
from cld_tpu.training.ebm import EBMTrainer as JEBMTrainer
from cld_tpu.training.state import TrainStateWithStats
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.models.learned_metric import ebm_infonce_loss
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.sim.learned_metrics import ebm_rollout_metric, ebm_rollout_scores
from cld_tpu_torch.training.ebm import EBMTrainer
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)


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
