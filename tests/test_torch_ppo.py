"""The PPO stage of the port against the JAX package at the `cld_smoke` sizes:
the ring buffer, one collection step, the clipped surrogate, the update
phase's bookkeeping, the test step, and learning on the toy setting of
`tests/test_ppo_learning.py`.

Log-prob is taken at t = 0, where sigma is clipped to 1e-10: a 1-ulp
difference between collection and recompute drives the ratio to exactly 0, so
an update phase cannot be compared across packages iteration by iteration.
What is compared: everything a collection writes into the buffer (the same
noise through both samplers, drawn under the JAX sampler's key schedule), the
surrogate and its statistics given the same log-probs, and learning over
2-iteration phases from the same initial weights.

Tolerances: latents and conditioning as the sampler tests hold them (atol
1e-4 over 5 denoise steps of f32 networks); the stored log-prob rtol 1e-6 (a
constant: -log sigma - log sqrt(2 pi)); rewards equal up to the jerk term
(atol 1e-4); surrogate rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.training import ppo as jax_ppo
from cld_tpu.training.dm import DMTrainer as JaxDMTrainer
from cld_tpu.training.vae import VAETrainer as JaxVAETrainer
from cld_tpu.utils.registry import get_registered_experiment_config as jax_registered
from cld_tpu_torch.algos.reward import offroad_reward
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.training import ppo
from cld_tpu_torch.training.dm import DMTrainer
from cld_tpu_torch.training.vae import build_vae_model
from cld_tpu_torch.utils import weights as tw
from cld_tpu_torch.utils.registry import get_registered_experiment_config

torch.set_num_threads(2)
T, L, COND = 52, 4, 32


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _toy_config(registered):
    """`tests/test_ppo_learning.py`'s setting: 4 samples per agent, a buffer of
    one collection, 2-iteration phases, a toy-scale rate."""
    cfg = registered("cld_smoke").unlock()
    cfg.algo.num_samp = 4
    cfg.algo.buffer_max = 64
    cfg.algo.ppo_update_times = 2
    cfg.algo.ppo_epochs = 1
    cfg.algo.ppo_mini_batch = 16
    cfg.algo.optim_params.dm.learning_rate.initial = 1e-2
    return cfg.lock()


@pytest.fixture(scope="module")
def setup():
    """The JAX trainers and the port's on the same initial weights, B=16, the
    drivable band narrowed to |y| < 1 m so that the untrained policy leaves
    it often."""
    B = 16
    ys = (np.arange(64) - 32) / 2.0  # row -> agent-frame y at 0.5 m/px
    dmap = np.broadcast_to((np.abs(ys) < 1.0).astype(np.float32)[None, :, None],
                           (B, 64, 64)).copy()
    jcfg = _toy_config(jax_registered)
    jb = jax_synthetic(seed=0, batch_size=B, raster_size=64, hist_frames=8)
    jb = jb._replace(drivable_map=jnp.asarray(dmap))
    vs = JaxVAETrainer(jcfg).init_state(jax.random.key(0), jb)
    vae_vars = {"params": vs.params, "batch_stats": vs.batch_stats}
    jdm = JaxDMTrainer(jcfg, vae_vars)
    jstate = jdm.init_state(jax.random.key(2))
    jppo = jax_ppo.PPOTrainer(jcfg, jdm)

    cfg = _toy_config(get_registered_experiment_config)
    vae = build_vae_model(cfg, "cpu")
    tw.load_vae_model(vae, _np_tree(vae_vars))
    pdm = DMTrainer(cfg, vae, device="cpu")
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, hist_frames=8, device="cpu")
    tb = tb._replace(drivable_map=torch.from_numpy(dmap))

    def fresh_state():
        state = pdm.init_state(seed=0)
        tw.load_temporal_unet(state.model, {"params": _np_tree(jstate.params)})
        return state

    return cfg, jppo, jstate, jb, ppo.PPOTrainer(cfg, pdm), fresh_state, tb


def _fresh_buf(cfg):
    a = cfg.algo
    return ppo.buffer_init(a.buffer_max, a.horizon, a.vae.latent_size, a.cond_feat_dim,
                           device="cpu")


def test_buffer_ring_semantics_equal_the_jax_buffer():
    """The values of `tests/test_training.py::test_buffer_ring_semantics`, and
    the same inserts through both buffers."""
    buf = ppo.buffer_init(capacity=8, horizon=4, latent=2, cond_dim=3, device="cpu")
    jbuf = jax_ppo.buffer_init(capacity=8, horizon=4, latent=2, cond_dim=3)
    rng = np.random.default_rng(0)
    x = torch.ones((5, 4, 2))
    buf = ppo.buffer_add(buf, x, x, torch.ones(5), torch.full((5,), 2.0), torch.ones((5, 3)))
    assert buf.size == 5 and buf.ptr == 5 and float(buf.baseline) == pytest.approx(2.0)
    buf = ppo.buffer_add(buf, 3 * x, x, torch.ones(5), torch.full((5,), 4.0), torch.ones((5, 3)))
    assert buf.size == 8 and buf.ptr == 2
    assert float(buf.baseline) == pytest.approx(0.9 * 2.0 + 0.1 * 4.0)
    assert torch.all(buf.x0[5] == 3.0) and torch.all(buf.x0[1] == 3.0)
    assert torch.all(buf.x0[2] == 1.0)

    buf = ppo.buffer_init(capacity=8, horizon=4, latent=2, cond_dim=3, device="cpu")
    for n in (3, 4, 5, 8, 1):
        rows = [rng.normal(size=s).astype(np.float32)
                for s in ((n, 4, 2), (n, 4, 2), (n,), (n,), (n, 3))]
        buf = ppo.buffer_add(buf, *(torch.from_numpy(r) for r in rows))
        jbuf = jax_ppo.buffer_add(jbuf, *(jnp.asarray(r) for r in rows))
        assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
        for name in ("x0", "x1", "log_p", "reward", "cond_feat"):
            np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                          np.asarray(getattr(jbuf, name)), err_msg=name)
        np.testing.assert_allclose(float(buf.baseline), float(jbuf.baseline), rtol=1e-6)
    with pytest.raises(ValueError, match="exceeds buffer capacity"):
        ppo.buffer_add(buf, *(torch.zeros(s) for s in ((9, 4, 2), (9, 4, 2), (9,), (9,), (9, 3))))


def test_clip_and_surrogate_match_jnp():
    """The surrogate, its statistics and its gradient given the same
    log-probs; and the clip's gradient at an exact tie with a bound, which
    `jnp.clip` splits evenly."""
    eps = 0.2
    x = np.array([0.5, 0.8, 1.0, 1.2, 1.7], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 1 - eps, 1 + eps)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    ppo._clip(xt, 1 - eps, 1 + eps).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert want.tolist() == [0.0, 0.5, 1.0, 0.5, 0.0]

    rng = np.random.default_rng(1)
    new = rng.normal(size=(32,)).astype(np.float32) * 0.3
    old = rng.normal(size=(32,)).astype(np.float32) * 0.3
    adv = rng.normal(size=(32,)).astype(np.float32)

    def jax_surrogate(lp):
        diff = lp - old
        ratio = jnp.exp(diff)
        loss = -jnp.mean(jnp.minimum(ratio * adv, jnp.clip(ratio, 1 - eps, 1 + eps) * adv))
        return loss, {"ratio_mean": ratio.mean(), "ratio_max": ratio.max(),
                      "clip_fraction": jnp.mean((jnp.abs(ratio - 1.0) > eps).astype(jnp.float32)),
                      "approx_kl": -diff.mean()}

    (jl, jstats), jg = jax.value_and_grad(jax_surrogate, has_aux=True)(jnp.asarray(new))
    lp = torch.from_numpy(new).requires_grad_(True)
    loss, stats = ppo.surrogate_loss(lp, torch.from_numpy(old), torch.from_numpy(adv), eps)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)
    assert sorted(stats) == sorted(jstats) and 0 < float(stats["clip_fraction"]) < 1
    for k in jstats:
        np.testing.assert_allclose(float(stats[k].detach()), float(jstats[k]), rtol=1e-6, err_msg=k)


def test_collect_step_fills_the_buffer_as_the_jax_trainer_does(setup):
    cfg, jppo, jstate, jb, pppo, fresh_state, tb = setup
    a = cfg.algo
    BN, n = 16 * a.num_samp, a.n_diffusion_steps
    rng = jax.random.key(5)
    # the key schedule of `DMTrainer.sample` and `sample_traj`
    _, samp_rng = jax.random.split(rng)
    step_rng, init_rng = jax.random.split(samp_rng)
    x_init = np.array(jax.random.normal(init_rng, (BN, T, L), jnp.float32))
    step_noises = np.array(jax.vmap(lambda k: jax.random.normal(k, (BN, T, L), jnp.float32))(
        jax.random.split(step_rng, n)))
    jbuf = jax_ppo.buffer_init(a.buffer_max, a.horizon, a.vae.latent_size, a.cond_feat_dim)
    jbuf, jm = jppo.collect_step(jstate, jbuf, jb, rng)
    buf, m = pppo.collect_step(fresh_state(), _fresh_buf(cfg), tb,
                               x_init=torch.from_numpy(x_init),
                               step_noises=torch.from_numpy(step_noises))
    assert (buf.size, buf.ptr) == (int(jbuf.size), int(jbuf.ptr)) == (BN, 0)
    for name in ("x0", "x1", "cond_feat"):
        np.testing.assert_allclose(getattr(buf, name).numpy(), np.asarray(getattr(jbuf, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(buf.log_p.numpy(), np.asarray(jbuf.log_p), rtol=1e-6)
    assert float(buf.log_p[0]) == pytest.approx(-np.log(1e-10) - 0.5 * np.log(2 * np.pi), rel=1e-6)
    # rewards: counts of off-road steps and near neighbours minus 0.1 mean |jerk|
    np.testing.assert_allclose(buf.reward.numpy(), np.asarray(jbuf.reward), atol=1e-4)
    np.testing.assert_allclose(float(m["reward"]), float(jm["reward"]), atol=1e-4)
    np.testing.assert_allclose(float(buf.baseline), float(jbuf.baseline), atol=1e-4)
    assert float(m["reward"]) < -1.0 and m["traj"].shape == (16, a.num_samp, T, 6)


def test_update_phase_bookkeeping(setup):
    cfg, _, _, _, pppo, fresh_state, tb = setup
    state = fresh_state()
    with pytest.raises(ValueError, match="empty replay buffer"):
        pppo.ppo_update(state, _fresh_buf(cfg))
    buf, _ = pppo.collect_step(state, _fresh_buf(cfg), tb,
                               generator=torch.Generator().manual_seed(0))
    p0 = [p.detach().clone() for p in state.model.parameters()]
    state, pm = pppo.ppo_update(state, buf, generator=torch.Generator().manual_seed(1))
    assert state.step == 2  # 1 epoch x 2 iterations
    assert sorted(pm) == ["approx_kl", "clip_fraction", "loss", "ratio_max", "ratio_mean"]
    assert all(np.isfinite(float(v)) for v in pm.values())
    assert 0.0 <= float(pm["clip_fraction"]) <= 1.0
    assert max(float((a - b.detach()).abs().max())
               for a, b in zip(p0, state.model.parameters())) > 0
    # explicit minibatch indices [n_iters, mini_batch]: one iteration per row
    idx = torch.randint(0, buf.size, (3, 16), generator=torch.Generator().manual_seed(2))
    state, _ = pppo.ppo_update(state, buf, indices=idx)
    assert state.step == 5


def test_test_step_rates_and_statistics(setup):
    cfg, jppo, jstate, jb, pppo, fresh_state, tb = setup
    rates, stats = pppo.test_step(fresh_state(), tb, generator=torch.Generator().manual_seed(3))
    jrates, jstats = jppo.test_step(jstate, jb, jax.random.key(7))
    assert sorted(rates) == sorted(jrates) and sorted(stats) == sorted(jstats)
    assert all(0.0 <= float(v) <= 1.0 for v in rates.values())
    for k, v in jstats.items():
        assert tuple(stats[k].shape) == tuple(v.shape), k
    for k in ("long_acc_gt", "lat_acc_gt", "jerk_gt"):  # no sampling in these
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4, atol=1e-3)


def test_ppo_improves_reward(setup):
    """12 collect + update cycles from the JAX package's initial weights, the
    toy reward (negative off-road count), deterministic evaluation noise: the
    mean reward improves and the off-road failure rate drops, by the margins
    `tests/test_ppo_learning.py` asks of the JAX trainer (measured here:
    -11.0 -> -7.84 and 0.7125 -> 0.5625; there -10.78 -> -7.56 and 0.7125 ->
    0.6125)."""
    cfg, _, _, _, pppo, fresh_state, tb = setup
    state = fresh_state()
    trainer = ppo.PPOTrainer(cfg, pppo.dm)
    trainer.reward_fn = lambda sa, batch, scaled, dt=0.1: offroad_reward(
        sa[..., :2], batch).reshape(-1)
    gen = lambda seed: torch.Generator().manual_seed(seed)

    def evaluate(state):
        _, m = trainer.collect_step(state, _fresh_buf(cfg), tb, generator=gen(7777))
        off = [float(trainer.test_step(state, tb, generator=gen(8880 + i))[0][
            "offroad_failure_rate"]) for i in range(5)]
        return float(m["reward"]), sum(off) / len(off)

    r_pre, off_pre = evaluate(state)
    assert r_pre < -5.0
    for cyc in range(12):
        buf, _ = trainer.collect_step(state, _fresh_buf(cfg), tb, generator=gen(100 + cyc))
        state, pm = trainer.ppo_update(state, buf, generator=gen(200 + cyc))
    r_post, off_post = evaluate(state)
    assert r_post > r_pre * 0.85, (r_pre, r_post)
    assert off_post <= off_pre - 0.04, (off_pre, off_post)
    assert state.step == 24 and np.isfinite(float(pm["loss"]))
