"""The DM stage of the port against the JAX package at the `cld_smoke` sizes
(raster 64, 12 raster channels, B=4, 5 diffusion steps): `q_sample`,
`dm_loss`, `transition_log_prob`, one step's gradients, three trainer steps,
EMA, the non-finite guard and the checkpoint round trip with resume.

The JAX side draws its randomness from keys; the tests repeat its key
schedule (`training/dm.py:124-131`, `algos/dm.py:42-48`) to read off the
timesteps, the loss noise and the encoder's reparametrization noise, and hand
them to the port.

Tolerances: losses and log-probabilities at t >= 1 rtol 1e-5; gradients rtol
1e-4 with a floor of 1e-5 of the tensor's largest component (f32 sums in two
libraries' orders); parameters after k steps within 2 * sum of the rates
(Adam moves a component by about rate * sign(g), and a component of g near
zero can take either sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos import dm as jax_dm
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.ops import diffusion as jax_diff
from cld_tpu.training import state as jax_state
from cld_tpu.training.dm import DMTrainer as JaxDMTrainer
from cld_tpu.training.vae import VAETrainer as JaxVAETrainer
from cld_tpu.utils.registry import get_registered_experiment_config as jax_registered
from cld_tpu_torch.algos import dm
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.models.vae import VaeModel
from cld_tpu_torch.ops import diffusion
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training import checkpoints as ck
from cld_tpu_torch.training import state as ts
from cld_tpu_torch.training.dm import DMTrainer
from cld_tpu_torch.training.vae import build_vae_model
from cld_tpu_torch.utils import weights as tw
from cld_tpu_torch.utils.registry import get_registered_experiment_config

torch.set_num_threads(2)
B, T, L, N_STEPS = 4, 52, 4, 5


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def setup():
    """JAX trainer + state, the port's trainer + state with the same weights,
    and the two batches."""
    jcfg = jax_registered("cld_smoke")
    jb = jax_synthetic(seed=0, batch_size=B, raster_size=64, hist_frames=8)
    vs = JaxVAETrainer(jcfg).init_state(jax.random.key(0), jb)
    vae_vars = {"params": vs.params, "batch_stats": vs.batch_stats}
    jt = JaxDMTrainer(jcfg, vae_vars)
    js = jt.init_state(jax.random.key(2))
    cfg = get_registered_experiment_config("cld_smoke")
    vae = build_vae_model(cfg, "cpu")
    tw.load_vae_model(vae, _np_tree(vae_vars))
    pt = DMTrainer(cfg, vae, device="cpu")
    ps = pt.init_state(seed=0)
    tw.load_temporal_unet(ps.model, {"params": _np_tree(js.params)})
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, hist_frames=8, device="cpu")
    return jt, js, pt, ps, jb, tb


def _jax_draws(jt, jb, rng, step):
    """What `DMTrainer._train_step` draws at `step`: (encoder noise, t, loss
    noise) as numpy, plus its loss key."""
    rng = jax.random.fold_in(rng, step)
    enc_rng, loss_rng = jax.random.split(rng)
    z, mu, logvar, _ = jt.vae.apply(jt.vae_variables, jb, method="encode",
                                    rngs={"sample": enc_rng})
    t_rng, noise_rng = jax.random.split(loss_rng)
    t = jax.random.randint(t_rng, (B,), 0, N_STEPS)
    noise = jax.random.normal(noise_rng, z.shape, jnp.float32)
    enc_noise = (z - mu) / jnp.exp(0.5 * logvar)
    return np.array(enc_noise), np.array(t), np.array(noise), loss_rng, np.array(z)


def test_schedule_buffers_and_q_sample_match():
    js, ps = jax_diff.make_schedule(100), diffusion.make_schedule(100, device="cpu")
    for name in ps._fields[1:]:
        np.testing.assert_array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    rng = np.random.default_rng(0)
    x0, noise = (rng.normal(size=(7, T, L)).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 2, 50, 98, 99, 37])
    want = np.asarray(jax_diff.q_sample(js, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)))
    got = diffusion.q_sample(ps, torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_dm_loss_and_one_step_gradients_match_jax_grad(setup):
    jt, js, pt, ps, jb, tb = setup
    _, t, noise, loss_rng, z = _jax_draws(jt, jb, jax.random.key(3), 0)
    cond = np.random.default_rng(1).normal(size=(B, 32)).astype(np.float32)

    def loss_fn(params):
        return jax_dm.dm_loss(jt.denoise_fn(params), jt.schedule, loss_rng, jnp.asarray(z),
                              jnp.asarray(cond))

    want, grads = jax.jit(jax.value_and_grad(loss_fn))(js.params)
    ps.model.zero_grad()
    got = dm.dm_loss(ps.model, pt.schedule, torch.from_numpy(z), torch.from_numpy(cond),
                     torch.from_numpy(t), torch.from_numpy(noise))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = tw.export_temporal_unet(_np_tree(grads), root="")
    got_g = {k: p.grad.numpy() for k, p in ps.model.named_parameters()}
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=k)
    ps.model.zero_grad(set_to_none=True)
    # drawn from a generator: reproducible, t below the schedule's length
    a, b = (dm.dm_loss(ps.model, pt.schedule, torch.from_numpy(z), torch.from_numpy(cond),
                       generator=torch.Generator().manual_seed(4)).detach() for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a)


def test_transition_log_prob_matches(setup):
    """Tight at t >= 1. At t = 0 sigma is clipped to 1e-10, so log-prob is a
    difference of f32 values scaled by 1e20: only finite and of the same
    magnitude there."""
    jt, js, pt, ps, _, _ = setup
    rng = np.random.default_rng(2)
    x_t, x_prev = (rng.normal(size=(B, T, L)).astype(np.float32) for _ in range(2))
    cond = rng.normal(size=(B, 32)).astype(np.float32)
    f = jax.jit(lambda t: jt.log_prob(js.params, jnp.asarray(x_t), jnp.asarray(x_prev),
                                      jnp.asarray(cond), t))
    with torch.no_grad():
        for t in ([1, 2, 3, 4], [4, 1, 1, 2], [0, 0, 0, 0]):
            want = np.asarray(f(jnp.asarray(t)))
            got = pt.log_prob(ps, *(torch.from_numpy(a) for a in (x_t, x_prev, cond)),
                              torch.tensor(t)).numpy()
            if t[0] > 0:
                np.testing.assert_allclose(got, want, rtol=1e-5)
            else:
                assert np.isfinite(got).all() and (got < -1e15).all() and (want < -1e15).all()
                np.testing.assert_allclose(np.log10(-got), np.log10(-want), atol=0.01)


def test_three_trainer_steps_against_the_jax_trainer(setup):
    """Epochs of one step (`cld_smoke`): step 0 runs at rate 0, steps 1 and 2
    at 1e-5 and 2e-5. The same draws go through both trainers."""
    jt, js, pt, _, jb, tb = setup
    ps = pt.init_state(seed=0)
    tw.load_temporal_unet(ps.model, {"params": _np_tree(js.params)})
    rng = jax.random.key(3)
    total_lr = 0.0
    for step in range(3):
        enc_noise, t, noise, _, _ = _jax_draws(jt, jb, rng, step)
        js, jm = jt.train_step(js, jb, rng)
        ps, pm = pt.train_step(ps, tb, enc_noise=torch.from_numpy(enc_noise),
                               t=torch.from_numpy(t), noise=torch.from_numpy(noise))
        np.testing.assert_allclose(pm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if step == 0 else 1e-3)
        assert pm["skipped_nonfinite"] == float(jm["skipped_nonfinite"]) == 0.0
        total_lr += pm["lr"]
    assert ps.step == int(js.step) == 3 and total_lr == pytest.approx(3e-5)
    want = tw.export_temporal_unet(_np_tree(js.params), root="")
    diffs = np.concatenate([(p.detach().numpy() - want[k]).ravel()
                            for k, p in ps.model.named_parameters()])
    assert np.abs(diffs).max() <= 2 * total_lr + 1e-7
    assert np.abs(diffs).mean() <= 0.05 * total_lr  # nearly every component agrees closely


def _with_ema(decay):
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.algo.ema_decay = decay
    return cfg.lock()


def test_ema_follows_the_parameters(setup):
    _, _, pt, _, _, tb = setup
    trainer = DMTrainer(_with_ema(0.9), pt.vae, device="cpu")
    state = trainer.init_state(seed=1)
    assert pt.init_state(seed=1).ema_params is None
    want = [np.array(p.detach()) for p in state.model.parameters()]
    gen = torch.Generator().manual_seed(0)
    for _ in range(4):
        state, _ = trainer.train_step(state, tb, generator=gen)
        new = [np.asarray(p.detach()) for p in state.model.parameters()]
        want = [np.asarray(a) for a in jax_state.ema_update(want, new, 0.9)]
    for e, w in zip(state.ema_params, want):
        np.testing.assert_allclose(e.numpy(), w, rtol=1e-6, atol=1e-8)
    assert any(float((e - p.detach()).abs().max()) > 0 for e, p in
               zip(state.ema_params, state.model.parameters()))


def _frozen(state):
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt = [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
           for s in state.optimizer.state.values()]
    ema = [e.clone() for e in state.ema_params or []]
    return sd, opt, ema


def _same(a, b):
    return (all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k]
                    for x, y in zip(a[1], b[1]) for k in x)
            and all(torch.equal(x, y) for x, y in zip(a[2], b[2])))


def test_nonfinite_loss_skips_the_update(setup):
    _, _, pt, _, _, tb = setup
    trainer = DMTrainer(_with_ema(0.9), pt.vae, device="cpu")
    state = trainer.init_state(seed=1)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, _ = trainer.train_step(state, tb, generator=gen)
    before = _frozen(state)
    image = tb.image.clone()
    image[1, 3, 3, 0] = float("nan")
    state, m = trainer.train_step(state, tb._replace(image=image), generator=gen)
    assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(float(m["loss"]))
    assert state.step == 2 and _same(before, _frozen(state))
    assert all(p.grad is None for p in state.model.parameters())
    state, m = trainer.train_step(state, tb, generator=gen)
    assert m["skipped_nonfinite"] == 0.0 and state.step == 3 and not _same(before, _frozen(state))


def test_checkpoint_round_trip_and_resume(setup, tmp_path):
    """A full-state checkpoint restores parameters, Adam's moments and step
    counts, the EMA copy, the step and the loop step; a resumed run continues
    bit for bit. A stage checkpoint restores the module."""
    _, _, pt, _, _, tb = setup
    trainer = DMTrainer(_with_ema(0.9), pt.vae, device="cpu")
    g = torch.Generator().manual_seed(0)
    draws = [(torch.randn((B, T, L), generator=g), torch.randint(0, N_STEPS, (B,), generator=g),
              torch.randn((B, T, L), generator=g)) for _ in range(5)]
    state = trainer.init_state(seed=1)
    for d in draws[:3]:
        state, _ = trainer.train_step(state, tb, *d)
    ck.save_train_state(str(tmp_path / "full"), state, loop_step=17)
    ck.save_pytree(str(tmp_path / "stage"), {"params": state.model.state_dict()})
    saved = _frozen(state)
    for d in draws[3:]:
        state, _ = trainer.train_step(state, tb, *d)

    resumed = trainer.init_state(seed=2)
    resumed, loop_step = ck.restore_train_state(str(tmp_path / "full"), resumed)
    assert loop_step == 17 and resumed.step == 3 and _same(saved, _frozen(resumed))
    assert [float(s["step"]) for s in resumed.optimizer.state.values()] == [3.0] * len(saved[1])
    for d in draws[3:]:
        resumed, m = trainer.train_step(resumed, tb, *d)
    assert resumed.step == state.step == 5 and m["lr"] == trainer.lr_schedule(4)
    assert _same(_frozen(state), _frozen(resumed))

    fresh = trainer.init_state(seed=3)
    fresh.model.load_state_dict(ck.restore_pytree(str(tmp_path / "stage"))["params"], strict=True)
    assert all(torch.equal(fresh.model.state_dict()[k], saved[0][k]) for k in saved[0])
    ck.save_train_state(str(tmp_path / "full"), resumed)  # overwrites; loop step = state's
    assert ck.restore_pytree(str(tmp_path / "full"))["loop_step"] == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["full", "stage"]


def test_unported_options_raise(setup):
    _, _, pt, _, _, _ = setup
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.algo.diffuser_model_arch = "MLPResNetwork"  # ported: the residual-MLP denoiser
    assert type(DMTrainer(cfg.lock(), pt.vae, device="cpu").init_state(0).model).__name__ == \
        "MLPResDenoiser"
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.algo.diffuser_model_arch = "TransformerNet"
    with pytest.raises(ValueError, match="unknown diffuser_model_arch"):
        DMTrainer(cfg.lock(), pt.vae, device="cpu")
    # bf16 is ported: the denoiser and the frozen VAE compute in bf16 (set back
    # on the shared VAE afterwards)
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.train.training.precision = "bf16"
    dm = DMTrainer(cfg.lock(), pt.vae, device="cpu")
    assert dm.init_state(0).model.compute_dtype == pt.vae.context_encoder.compute_dtype == \
        torch.bfloat16
    set_compute_dtype(pt.vae, torch.float32)
    assert isinstance(pt.vae, VaeModel) and not any(p.requires_grad for p in pt.vae.parameters())
    assert ts.resolve_compute_dtype(None) == torch.float32
