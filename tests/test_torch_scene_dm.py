"""Scene diffusion and the latent attack of the port against the JAX
package's: `prepare_hist_in` and the history encoders, the factorized scene
transformer, `scene_dm_loss` / `scene_sample`, `SceneDMModel` and
`SceneDMTrainer`, the scene policy in a short closed loop, and
`latent_attack` through a VAE decoder; each from the same weights (seeded
flax variables converted by `utils.weights.load_flax`, strict) on the same
numpy-made inputs and the JAX side's own draws; then `--mode scene_dm` end
to end on the CPU.

Sizes: the `cld_smoke` scene widths (width 32, 2 layers, cond 16), history
4 frames, horizon 16, scenes of 4 agents (the last of each padding), 10
diffusion steps for the sampler, 10 attack steps.

Tolerances: values at rtol 1e-5 and gradients at rtol 1e-4, each with a
floor of 1e-5 of the tensor's largest component (nothing here has
BatchNorm); the sampler's 10 steps and the closed loop's two replans
compound the denoiser: rtol 1e-4, floor 1e-5. The attack runs Adam, which
turns a last-bit difference of a near-zero gradient into a full step
(ROADMAP Queue C), so it is held by one step's gradient (rtol 1e-4) and the
objective and penalty at the optimum (rtol 1e-3), not by z.
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
from flax.training import train_state

from cld_tpu.algos.latent_attack import latent_attack as jax_attack
from cld_tpu.algos.scene_dm import scene_dm_loss as jax_scene_loss
from cld_tpu.algos.scene_dm import scene_sample as jax_scene_sample
from cld_tpu.data.scene_batch import synthetic_scene_batch as jax_scene_batch
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.guidance.losses import CollisionAttackLoss as JAttack
from cld_tpu.guidance.losses import GuidanceContext as JContext
from cld_tpu.models import history_encoders as jhist
from cld_tpu.models.scene_transformer import SceneTransformerDenoiser as JDenoiser
from cld_tpu.models.vae import VaeModel as JVae
from cld_tpu.models.vae import convert_action_to_state_and_action as jax_convert
from cld_tpu.ops.diffusion import make_schedule as jax_schedule
from cld_tpu.ops.dynamics import UnicycleParams as JUnicycle
from cld_tpu.ops.normalization import TrajNormalizer as JNormalizer
from cld_tpu.policies import scene_policy as jpolicy
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu.training import scene_dm as jsdm
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.algos.latent_attack import latent_attack
from cld_tpu_torch.algos.scene_dm import scene_dm_loss, scene_sample
from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.guidance.losses import CollisionAttackLoss, GuidanceContext
from cld_tpu_torch.models import history_encoders as phist
from cld_tpu_torch.models.scene_transformer import SceneTransformerDenoiser
from cld_tpu_torch.models.vae import LSTMDecoder, convert_action_to_state_and_action, decode_actions
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS
from cld_tpu_torch.ops.normalization import TrajNormalizer
from cld_tpu_torch.policies import scene_policy
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.training import scene_dm as psdm
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(0)
HIST, HORIZON, NS, A = 4, 16, 2, 4  # history frames, plan horizon, scenes, agents per scene
WIDTH, LAYERS, COND = 32, 2, 16


def f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.tensor(np.asarray(a))


def scene_config(get, steps=5):
    cfg = get("cld_smoke").unlock()
    cfg.algo.history_num_frames = HIST
    cfg.algo.future_num_frames = HORIZON
    cfg.algo.n_diffusion_steps = steps
    return cfg.lock()


def scene_batches(seed=0, batch_size=NS):
    kw = dict(seed=seed, batch_size=batch_size, num_agents=A, hist_frames=HIST,
              horizon=HORIZON)
    return jax_scene_batch(**kw), synthetic_scene_batch(**kw, device="cpu")


def hold_grads(model, jax_grads: dict, v, rtol=1e-4):
    zp.assert_grads_close(model, tw.export_flax(model, zp.np_tree(jax_grads),
                                                v.get("batch_stats")), rtol=rtol)


# -- the history encoders ----------------------------------------------------

NORM = dict(norm_add=(1.0, -2.0, 0.5, -1.0, 0.25), norm_div=(2.0, 3.0, 4.0, 5.0, 1.5))


def _history(lead):
    avail = (RNG.uniform(size=(*lead, HIST + 1)) > 0.3).astype(np.float32)
    return [f32(*lead, HIST + 1, 2, scale=5.0), f32(*lead, HIST + 1, 1),
            RNG.uniform(0, 10, (*lead, HIST + 1)).astype(np.float32),
            RNG.uniform(1, 5, (*lead, 3)).astype(np.float32), avail]


def test_prepare_hist_in_matches_jax():
    pos, yaw, speed, extent, avail = _history((3,))
    args = (pos, yaw, speed, extent, avail, np.asarray(NORM["norm_add"]),
            np.asarray(NORM["norm_div"]))
    want = jhist.prepare_hist_in(*map(jnp.asarray, args[:5]), *args[5:])
    got = phist.prepare_hist_in(*map(t, args[:5]), *args[5:])
    zp.assert_close(got.numpy(), np.asarray(want), rtol=1e-6, floor=1e-7)
    assert got.shape == (3, (HIST + 1) * 8)
    zeroed = np.repeat(avail == 0, 8, axis=-1).reshape(3, -1)
    assert (got.numpy()[zeroed] == 0).all()


def test_history_encoders_match_jax():
    """The agent encoder, and the neighbor encoder's masked max-pool: a
    neighbor with no available step is left out, and a scene whose
    neighbors all are pools to 0; values and gradients in every parameter."""
    Q = 3
    hist = _history((2, Q))
    hist[4][0, 1] = 0.0  # scene 0: neighbor 1 never seen
    hist[4][1] = 0.0  # scene 1: no neighbor seen
    jn = jhist.NeighborHistoryEncoder(HIST + 1, out_dim=8, **NORM)
    jargs = [jnp.asarray(a) for a in hist]
    v = zp.random_variables(jn, *jargs)
    pn = tw.load_flax(phist.NeighborHistoryEncoder(HIST + 1, out_dim=8, **NORM), v)
    w = f32(2, 8)
    (_, out_j), gj = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * w), o))(jn.apply({"params": p}, *jargs)),
        has_aux=True))(v["params"])
    got = pn(*map(t, hist))
    zp.assert_close(got.detach().numpy(), np.asarray(out_j))
    assert (got[1] == 0).all()
    torch.sum(got * t(w)).backward()
    hold_grads(pn, gj, v)

    ja = jhist.AgentHistoryEncoder(HIST + 1, out_dim=8, **NORM)
    flat = [a.reshape(2 * Q, *a.shape[2:]) for a in hist]
    va = zp.random_variables(ja, *map(jnp.asarray, flat), seed=1)
    pa = tw.load_flax(phist.AgentHistoryEncoder(HIST + 1, out_dim=8, **NORM), va)
    zp.assert_close(pa(*map(t, flat)).detach().numpy(),
                    np.asarray(ja.apply(va, *map(jnp.asarray, flat))))


# -- the scene transformer ---------------------------------------------------


def test_scene_transformer_denoiser_matches_jax():
    """Time attention per agent, agent attention per timestep with padding
    agents masked as keys (a scene with every agent masked averages
    uniformly, as flax's float32-minimum fill does), the Mish MLP; padding
    agents' outputs are 0. Values and gradients in every parameter."""
    B = 3
    x, cond = f32(B, A, HORIZON, 6), f32(B, A, COND)
    time = np.array([0, 4, 9], np.int32)
    mask = np.ones((B, A), bool)
    mask[0, -1] = False
    mask[2] = False
    jm = JDenoiser(transition_dim=6, output_dim=6, width=WIDTH, num_layers=LAYERS)
    jargs = (jnp.asarray(x), jnp.asarray(cond), jnp.asarray(time), jnp.asarray(mask))
    v = zp.random_variables(jm, *jargs)
    pm = tw.load_flax(SceneTransformerDenoiser(HORIZON, COND, width=WIDTH, num_layers=LAYERS), v)
    w = f32(B, A, HORIZON, 6)
    (lj, out_j), gj = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * w), o))(jm.apply({"params": p}, *jargs)),
        has_aux=True))(v["params"])
    out = pm(t(x), t(cond), t(time).long(), t(mask))
    zp.assert_close(out.detach().numpy(), np.asarray(out_j))
    assert (out[~t(mask)] == 0).all()
    torch.sum(out * t(w)).backward()
    hold_grads(pm, gj, v)


# -- the scene model, loss, sampler and trainer ------------------------------


@pytest.fixture(scope="module")
def scene_model():
    """The JAX `SceneDMModel` with seeded variables, the port's with them
    loaded, and a scene batch of both packages."""
    jb, tb = scene_batches()
    jm = jsdm.SceneDMModel(cond_dim=COND, width=WIDTH, num_layers=LAYERS)
    x0 = jnp.zeros((NS, A, HORIZON, 6))
    v = zp.random_variables(jm, jb, x0, jnp.zeros((NS,), jnp.int32))
    cfg = scene_config(registry.get_registered_experiment_config)
    trainer = psdm.SceneDMTrainer(cfg, device="cpu")
    model = trainer.build()
    converted = tw.export_flax(model, v["params"])
    assert {k: tuple(a.shape) for k, a in converted.items()} == {
        k: tuple(p.shape) for k, p in model.state_dict().items()}
    tw.load_flax(model, v)
    return jb, tb, jm, v, trainer, model


def test_scene_gt_trajectories_match_jax():
    """Inverse dynamics differences positions twice over dt = 0.1: rtol
    1e-5, floor 1e-5."""
    jb, tb = scene_batches(seed=1)
    zp.assert_close(psdm.scene_gt_trajectories(tb).numpy(),
                    np.asarray(jsdm.scene_gt_trajectories(jb)), rtol=1e-5, floor=1e-5)


def test_scene_dm_loss_matches_jax(scene_model, monkeypatch):
    """The masked epsilon MSE at the JAX side's own timesteps and noise,
    and its gradients in every parameter (conditioning encoder included)."""
    jb, tb, jm, v, trainer, model = scene_model
    sched_j = jax_schedule(5)
    x0 = jsdm.scene_gt_trajectories(jb)
    rng = jax.random.key(4)

    def jax_side(v, jb, x0):
        def loss(p):
            cond = jm.apply({"params": p}, jb, method="encode_cond")
            dn = lambda x, c, tt, am: jm.apply({"params": p}, x, c, tt, am, method="denoise")
            return jax_scene_loss(dn, sched_j, rng, x0, cond, jb.agent_mask)

        return jax.value_and_grad(loss)(v["params"])

    drawn, (lj, gj) = zp.record_draws(monkeypatch, jax_side, v, jb, x0, keep_output=True)
    tt, noise = t(drawn["randint"][0]).long(), t(drawn["normal"][0])
    model.zero_grad()
    lp = scene_dm_loss(model.denoise, make_schedule(5, device="cpu"),
                       psdm.scene_gt_trajectories(tb), model.encode_cond(tb), tb.agent_mask,
                       tt, noise)
    lp.backward()
    zp.assert_close(float(lp.detach()), float(lj), rtol=1e-5, floor=0)
    hold_grads(model, gj, v)


def sample_noise_from_key(key, n, shape):
    """The draws of the JAX `scene_sample` under `key`: x_init and the
    per-step noise, in the order the steps take them."""
    rng, init_rng = jax.random.split(key)
    x = jax.random.normal(init_rng, shape, jnp.float32)
    steps = jax.random.split(rng, n)
    return t(x), t(jnp.stack([jax.random.normal(k, shape, jnp.float32) for k in steps]))


def test_scene_sample_matches_jax(scene_model):
    """Ten ancestral steps from the same draws, with and without a guidance
    function on the mean; padding agents are 0 after every step."""
    jb, tb, jm, v, trainer, model = scene_model
    n = 10
    sched_j, sched_p = jax_schedule(n), make_schedule(n, device="cpu")
    key = jax.random.key(7)
    x_init, noises = sample_noise_from_key(key, n, (NS, A, HORIZON, 6))

    def guide_j(mean, tt):
        return mean - 0.01 * tt[:, None, None, None] * mean

    def guide_p(mean, tt):
        return mean - 0.01 * tt[:, None, None, None] * mean

    @jax.jit
    def jax_side(v, jb):  # arguments, not constants XLA would fold at compile time
        cond = jm.apply(v, jb, method="encode_cond")
        dn = lambda x, c, tt, am: jm.apply(v, x, c, tt, am, method="denoise")
        return [jax_scene_sample(dn, sched_j, key, cond, jb.agent_mask, HORIZON, 6,
                                 guidance_fn=g)["pred_traj"] for g in (None, guide_j)]

    wants = jax_side(v, jb)
    with torch.no_grad():
        cond = model.encode_cond(tb)
        for g, want in zip((None, guide_p), wants):
            got = scene_sample(model.denoise, sched_p, cond, tb.agent_mask, x_init, noises,
                               guidance_fn=g)["pred_traj"]
            zp.assert_close(got.numpy(), np.asarray(want), rtol=1e-4, floor=1e-5)
            assert (got[~tb.agent_mask] == 0).all()


def test_scene_dm_trainer_matches_jax(scene_model, monkeypatch):
    """One `SceneDMTrainer.train_step` against the JAX trainer's from the
    same weights and the JAX step's own draws: the loss and the gradients of
    its update; the non-finite guard; `sample` from the same draws."""
    jb, tb, jm, v, trainer, model = scene_model
    jtr = jsdm.SceneDMTrainer(scene_config(jax_registry.get_registered_experiment_config))
    sink = []

    def record(grads, opt_state, params=None):
        sink.append(grads)
        return jtr.optimizer.update(grads, opt_state, params)

    jstate = train_state.TrainState.create(
        apply_fn=jtr.model.apply, params=v["params"],
        tx=optax.GradientTransformation(jtr.optimizer.init, record))
    key = jax.random.key(5)

    def jax_side(jstate, jb):
        sink.clear()
        return jtr._train_step(jstate, jb, key), sink[0]

    drawn, ((_, mj), gj) = zp.record_draws(monkeypatch, jax_side, jstate, jb, keep_output=True)
    sample_j = jax.jit(lambda jstate, jb: jtr.sample(jstate, jb, key))(jstate, jb)
    noise = (t(drawn["randint"][0]).long(), t(drawn["normal"][0]))

    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    captured = {}
    state.optimizer.register_step_pre_hook(lambda *_: captured.update(
        {k: p.grad.clone() for k, p in state.model.named_parameters()}))
    state, mp = trainer.train_step(state, tb, noise=noise)
    assert state.step == 1 and mp["skipped_nonfinite"] == 0.0 == float(mj["skipped_nonfinite"])
    zp.assert_close(float(mp["loss"]), float(mj["loss"]), rtol=1e-5, floor=0)
    for k, p in state.model.named_parameters():
        p.grad = captured[k]
    hold_grads(state.model, gj, v)

    # the sampler of the trainer, from the weights before the step
    fresh = trainer.init_state(0)
    tw.load_flax(fresh.model, v)
    got = trainer.sample(fresh, tb, noise=sample_noise_from_key(key, 5, (NS, A, HORIZON, 6)))
    zp.assert_close(got.numpy(), np.asarray(sample_j), rtol=1e-4, floor=1e-5)

    # a NaN history: the step is skipped, parameters, moments and step stay
    before = {k: p.clone() for k, p in state.model.state_dict().items()}
    moments = [m.clone() for s in state.optimizer.state.values() for m in s.values()]
    bad = tb._replace(hist_positions=tb.hist_positions * float("nan"))
    state, m = trainer.train_step(state, bad, generator=torch.Generator().manual_seed(0))
    assert m["skipped_nonfinite"] == 1.0 and state.step == 1
    for k, p in state.model.state_dict().items():
        torch.testing.assert_close(p, before[k], rtol=0, atol=0, msg=k)
    after = [m for s in state.optimizer.state.values() for m in s.values()]
    for a, b in zip(after, moments):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the scene policy --------------------------------------------------------


def test_scene_policy_closed_loop_matches_jax(scene_model):
    """`scene_batch_from_obs` on the first observation, field by field, and
    a 10-frame closed loop (2 replans) of the scene policy, 2 scenes x 4
    agents at raster 32, from the JAX episode's own per-replan draws."""
    jb, tb, jm, v, trainer, model = scene_model
    kw = dict(seed=3, num_scenes=NS, agents_per_scene=A, sim_steps=10)
    jp, tp = jscene.synthetic_scene_pack(**kw), tscene.synthetic_scene_pack(**kw, device="cpu")
    sim_kw = dict(num_simulation_steps=10, n_step_action=5, raster_size=32, hist_frames=HIST)
    cfg_j, cfg_t = jenv.SimConfig(**sim_kw), tenv.SimConfig(**sim_kw)

    obs_t = tenv.render_observation(tp, tenv.init_sim_state(tp, cfg_t), cfg_t)
    got = scene_policy.scene_batch_from_obs(obs_t, NS, A, HORIZON)
    want = jax.jit(lambda: jpolicy.scene_batch_from_obs(  # one compile, not one per op
        jenv.render_observation(jp, jenv.init_sim_state(jp, cfg_j), cfg_j), jp, NS, A,
        HORIZON))()
    for name in want._fields:
        zp.assert_close(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-5,
                        floor=1e-6, msg=name)

    jtr = jsdm.SceneDMTrainer(scene_config(jax_registry.get_registered_experiment_config))
    jstate = train_state.TrainState.create(apply_fn=jtr.model.apply, params=v["params"],
                                           tx=optax.identity())
    key = jax.random.key(9)
    _, traj_j = jax.jit(lambda jstate, r: jenv.simulate(
        jp, jpolicy.scene_dm_policy(jtr, jstate, jp, NS, A, horizon=HORIZON), r, cfg_j))(
            jstate, key)
    noises = [sample_noise_from_key(k, 5, (NS, A, HORIZON, 6))
              for k in jax.random.split(key, cfg_t.num_replans)]
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    policy = scene_policy.scene_dm_policy(trainer, state, NS, A, horizon=HORIZON)
    _, traj = tenv.simulate(tp, policy, cfg_t, replan_noises=noises)
    assert traj.shape == (10, NS * A, 4) and torch.isfinite(traj).all()
    zp.assert_close(traj.numpy(), np.asarray(traj_j), rtol=1e-4, floor=1e-5)
    # a generator draws the same way twice
    runs = [tenv.simulate(tp, policy, cfg_t, generator=torch.Generator().manual_seed(1))[1]
            for _ in range(2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)


# -- the latent attack -------------------------------------------------------


def test_latent_attack_on_a_toy_decoder_matches_jax():
    """A linear decoder and a quadratic objective: Adam's path is smooth, so
    z, the objective and the penalty agree tightly after 10 steps."""
    M = f32(3, 20)

    def decode_j(z):
        return jnp.zeros((z.shape[0], 20, 6)).at[..., 1].set(z @ M)

    def decode_p(z):
        out = torch.zeros((z.shape[0], 20, 6))
        out[..., 1] = z @ t(M)
        return out

    z0 = f32(2, 3)
    kw = dict(prior_weight=0.05, lr=0.2, steps=10)
    zj, ij = jax.jit(lambda z: jax_attack(decode_j, lambda x: jnp.mean((x[..., 1] - 3.0) ** 2),
                                          z, **kw))(jnp.asarray(z0))
    zp_, ip = latent_attack(decode_p, lambda x: torch.mean((x[..., 1] - 3.0) ** 2), t(z0), **kw)
    zp.assert_close(zp_.numpy(), np.asarray(zj), rtol=1e-5, floor=1e-6)
    for k in ("objective", "prior_penalty"):
        zp.assert_close(float(ip[k]), float(ij[k]), rtol=1e-5, floor=0, msg=k)
    assert float(ip["objective"]) < float(
        torch.mean((decode_p(t(z0))[..., 1] - 3.0) ** 2))


def test_latent_attack_through_the_vae_decoder_matches_jax():
    """The STRIVE attack of record's shape at a small size: z [4, 52, 4]
    through a VAE decoder (H=8) and the unicycle, the collision-attack rule
    of the guidance library (agent 0 onto agent 1, whose path crosses its
    own), 10 Adam steps. One
    step's gradient tightly; the objective and penalty at the optimum; the
    objective goes down."""
    jbatch = jax_synthetic(seed=0, batch_size=4, raster_size=32)
    tbatch = synthetic_batch(seed=0, batch_size=4, raster_size=32, device="cpu")
    jv = JVae(curr_state_feat_dim=8, map_feature_dim=16, cond_feat_dim=16, vae_hidden_size=8)
    vv = zp.random_variables(jv, jbatch, 0.05, rngs=("params", "sample"))
    decoder = tw.load_lstm_decoder(LSTMDecoder(4, 8, 16), vv)
    for p in decoder.parameters():
        p.requires_grad_(False)
    cond = f32(4, 16)
    curr = np.concatenate([np.asarray(jbatch.history_positions[:, -1]),
                           np.asarray(jbatch.curr_speed)[:, None],
                           np.asarray(jbatch.history_yaws[:, -1])], -1)
    # the agents' poses: the victim (1) crosses the attacker's (0) path ahead
    wfa = np.tile(np.eye(3, dtype=np.float32), (4, 1, 1))
    for i, (x, y, yaw) in enumerate([(0, 0, 0), (25, -15, np.pi / 2), (0, 30, 0), (0, 60, 0)]):
        c, s = np.cos(yaw), np.sin(yaw)
        wfa[i] = [[c, -s, x], [s, c, y], [0, 0, 1]]
    dyn_j = JUnicycle(max_steer=0.5, max_yawvel=2 * np.pi, acce_lo=-10.0, acce_hi=8.0)

    def objective_j(traj):
        ctx = JContext(*([None] * 4), world_from_agent=jnp.asarray(wfa),
                       scene_index=jnp.zeros(4, jnp.int32))
        return jnp.sum(JAttack(0, 1)(traj[:, None], ctx))

    def decode_j(z, vv):
        acts = jv.apply(vv, z, jnp.asarray(cond), method="decode")
        return jax_convert(acts, jnp.asarray(curr), dyn_j, JNormalizer(), descaled_output=True)

    def objective_p(traj):
        ctx = GuidanceContext(*([None] * 4), world_from_agent=t(wfa),
                              scene_index=torch.zeros(4, dtype=torch.long))
        return torch.sum(CollisionAttackLoss(0, 1)(traj[:, None], ctx))

    def decode_p(z):
        acts = decode_actions(decoder, z, t(cond))
        return convert_action_to_state_and_action(acts, t(curr), RECORD_DYNAMICS,
                                                  TrajNormalizer(), descaled_output=True)

    z0 = f32(4, 52, 4, scale=0.1)
    kw = dict(prior_weight=0.1, lr=0.1, steps=10)
    total_j = lambda z, vv: objective_j(decode_j(z, vv)) + 0.1 * jnp.mean(
        0.5 * jnp.sum(z.reshape(4, -1) ** 2, -1))

    @jax.jit
    def jax_side(z, vv):  # the weights an argument, not constants XLA would fold
        return jax.grad(total_j)(z, vv), jax_attack(lambda zz: decode_j(zz, vv), objective_j, z,
                                                    **kw)

    gj, (zj, ij) = jax_side(jnp.asarray(z0), vv)
    zt = t(z0).requires_grad_(True)
    total = objective_p(decode_p(zt)) + 0.1 * torch.mean(
        0.5 * torch.sum(zt.reshape(4, -1) ** 2, -1))
    total.backward()
    zp.assert_close(zt.grad.numpy(), np.asarray(gj), rtol=1e-4, floor=1e-5)
    z_opt, info = latent_attack(decode_p, objective_p, t(z0), **kw)
    for k in ("objective", "prior_penalty"):
        zp.assert_close(float(info[k]), float(ij[k]), rtol=1e-3, floor=0, msg=k)
    start = float(objective_p(decode_p(t(z0))))
    print(f"attack objective {start:.6g} -> {float(info['objective']):.6g}")
    assert float(info["objective"]) < start
    assert z_opt.shape == (4, 52, 4) and not z_opt.requires_grad


# -- the CLI -----------------------------------------------------------------


def test_train_cli_mode_scene_dm_end_to_end(tmp_path):
    """`python -m cld_tpu_torch.train --registered-name cld_smoke --mode
    scene_dm --device cpu --steps 3` in a process that imports no JAX: four
    synthetic scene batches cycled, `ckpt_final` and no `_full` file; the
    checkpoint then drives the scene policy for 10 frames."""
    out = tmp_path / "runs"
    code = f"""
import json, sys, torch
from cld_tpu_torch import train
from cld_tpu_torch.policies.scene_policy import scene_dm_policy
from cld_tpu_torch.sim.env import SimConfig, simulate
from cld_tpu_torch.sim.scene import synthetic_scene_pack
from cld_tpu_torch.training.checkpoints import restore_pytree
from cld_tpu_torch.training.scene_dm import SceneDMTrainer
from cld_tpu_torch.utils.registry import get_registered_experiment_config
state = train.main(["--registered-name", "cld_smoke", "--device", "cpu", "--mode", "scene_dm",
                    "--steps", "3", "--output", {str(out)!r}])
cfg = get_registered_experiment_config("cld_smoke")
trainer = SceneDMTrainer(cfg, device="cpu")
loaded = trainer.init_state(1)
loaded.model.load_state_dict(restore_pytree({str(out / "scene_dm" / "ckpt_final")!r})["params"])
pack = synthetic_scene_pack(seed=0, num_scenes=1, agents_per_scene=3, sim_steps=10, device="cpu")
sim = SimConfig(num_simulation_steps=10, n_step_action=5, raster_size=32,
                hist_frames=cfg.algo.history_num_frames)
policy = scene_dm_policy(trainer, loaded, 1, 3, horizon=cfg.algo.future_num_frames)
_, traj = simulate(pack, policy, sim, generator=torch.Generator().manual_seed(0))
print("TRAJ=" + json.dumps([list(traj.shape), bool(torch.isfinite(traj).all())]))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cld_tpu"))
print("FORBIDDEN_IMPORTED=" + json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="2")  # torch's threads, as this process's
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN_IMPORTED=[]" in res.stdout, res.stdout[-500:]
    assert "TRAJ=[[10, 3, 4], true]" in res.stdout, res.stdout[-500:]
    files = sorted(p.name for p in (out / "scene_dm").iterdir())
    assert files == ["ckpt_final", "metrics.jsonl"], files
    recs = [json.loads(x) for x in (out / "scene_dm" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all(np.isfinite(val) for r in recs for val in r.values())
    assert all(r["train/skipped_nonfinite"] == 0.0 for r in recs)
