"""The VAE stage of the port against the JAX package at the `cld_smoke` sizes
(raster 64, 12 raster channels, B=4): one step's gradients, BatchNorm's
running statistics after a train-mode forward, the train-mode context
encoder and its gradients, the optimizer against the optax chain, the rate
and beta schedules, the trainer's steps, and its non-finite guard.

Dropout cannot be drawn alike in the two packages, so the loss's gradients
are compared with `train=False` plus the JAX side's own reparametrization
noise (read off its outputs), train-mode BatchNorm is compared on the context
encoder alone, and the dropout mask has its own test in
`tests/test_torch_vae.py`.

Tolerances: gradients rtol 1e-4 with a floor of 1e-5 of the tensor's largest
component (f32 sums over a 52-step LSTM and 20 convolution layers in two
libraries' orders; the floor covers components that cancel to near zero);
running statistics 1e-5; optimizer trajectories 1e-6 (the same f32 arithmetic
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.models import vae as jax_vae
from cld_tpu.training import state as jax_state
from cld_tpu.training.vae import VAETrainer as JaxVAETrainer
from cld_tpu.utils.registry import get_registered_experiment_config as jax_registered
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.models import vae as pv
from cld_tpu_torch.training import state as ts
from cld_tpu_torch.training.ebm import EBMTrainer
from cld_tpu_torch.training.vae import VAETrainer, raster_channels
from cld_tpu_torch.training.zoo import ZooTrainer
from cld_tpu_torch.utils import weights as tw
from cld_tpu_torch.utils.registry import get_registered_experiment_config

torch.set_num_threads(2)
SIZES = dict(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32, vae_hidden_size=16)
BETA = 0.07


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def assert_grads_close(got: dict, want: dict, floor: float = 1e-5):
    """Port gradients by state-dict key against converted JAX gradients:
    rtol 1e-4 plus `floor` of the tensor's largest component."""
    checked = 0
    for k, w in want.items():
        if k not in got or "bias_hh" in k:
            continue  # buffers; flax has one LSTM bias, exported as bias_ih
        g = got[k].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=floor * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)
        checked += 1
    for k in got:
        if "bias_hh" in k:  # the two torch biases are summed: equal gradients
            np.testing.assert_array_equal(got[k].numpy(), got[k.replace("bias_hh", "bias_ih")])
    return checked


@pytest.fixture(scope="module")
def pair():
    jb = jax_synthetic(seed=0, batch_size=4, raster_size=64, hist_frames=8)
    m = jax_vae.VaeModel(**SIZES)
    v = jax.jit(lambda r, b: m.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, jb)
    v = {"params": _np_tree(v["params"]), "batch_stats": _np_tree(v["batch_stats"])}
    port = pv.VaeModel(raster_channels=12, **SIZES)
    tw.load_vae_model(port, v)
    tb = synthetic_batch(seed=0, batch_size=4, raster_size=64, hist_frames=8, device="cpu")
    return m, v, port, jb, tb


def test_one_step_gradients_match_jax_grad(pair):
    m, v, port, jb, tb = pair
    key = jax.random.key(7)

    def loss_fn(params):
        out = m.apply({"params": params, "batch_stats": v["batch_stats"]}, jb, BETA, train=False,
                      rngs={"sample": key})
        return out["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    z, mu, logvar, _ = jax.jit(lambda: m.apply(v, jb, method="encode", rngs={"sample": key}))()
    noise = np.array((z - mu) / jnp.exp(0.5 * logvar))
    out = port(tb, BETA, train=False, noise=torch.from_numpy(noise))
    port.zero_grad()
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(loss), rtol=1e-5)
    want = tw.export_vae_checkpoint({"params": _np_tree(grads), "batch_stats": v["batch_stats"]})
    got = {f"vae.{k}": p.grad for k, p in port.named_parameters()}
    assert assert_grads_close(got, want) == len(list(port.parameters())) - 4  # 4 bias_hh
    port.zero_grad()


def test_batchnorm_running_statistics_after_a_train_forward(pair):
    """flax moves the running statistics by momentum 0.99 with the biased
    batch variance; the port's BatchNorm2d does the same (torch's own would
    store the unbiased variance at momentum 0.1)."""
    m, v, _, jb, tb = pair
    _, mutated = jax.jit(lambda: m.apply(
        v, jb, BETA, train=True, mutable=["batch_stats"],
        rngs={"sample": jax.random.key(1), "dropout": jax.random.key(2)}))()
    want = tw.export_vae_checkpoint({"params": v["params"],
                                     "batch_stats": _np_tree(mutated["batch_stats"])})
    port = pv.VaeModel(raster_channels=12, **SIZES)
    tw.load_vae_model(port, v)
    port(tb, BETA, train=True, generator=torch.Generator().manual_seed(0))
    got = port.state_dict()
    n = 0
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k[len("vae."):]].numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            n += 1
    assert n == 40  # 20 BatchNorm layers
    bn1 = "context_encoder.map_encoder.encoder_heads.map_model.bn1."
    assert float((got[bn1 + "running_var"] - 1.0).abs().max()) > 1e-4  # they did move
    assert int(got[bn1 + "num_batches_tracked"]) == 1
    with torch.no_grad():  # eval mode leaves them alone
        port(tb, BETA, train=False)
    np.testing.assert_array_equal(port.state_dict()[bn1 + "running_var"].numpy(),
                                  got[bn1 + "running_var"].numpy())


def test_train_mode_context_encoder_and_its_gradients(pair):
    """BatchNorm on batch statistics, forward and backward: the context
    encoder alone (no dropout in it), against flax with `train=True`. The
    raster is dense Gaussian noise here: on the synthetic raster (mostly
    zeros) many channels have a batch variance far under BatchNorm's epsilon,
    the backward through 1 / sqrt(var + eps) then amplifies the two
    libraries' rounding by orders of magnitude, and the comparison would hold
    the fixture's conditioning, not the arithmetic. Floor 5e-5 of each
    tensor's largest component: sums over 147,456-element tensors whose
    components cancel (measured: 1.1e-5 on one component)."""
    m, v, _, jb, tb = pair
    rng = np.random.default_rng(5)
    w = rng.normal(size=(4, 32)).astype(np.float32)
    image = rng.normal(size=tuple(tb.image.shape)).astype(np.float32)
    jb, tb = jb._replace(image=jnp.asarray(image)), tb._replace(image=torch.from_numpy(image))
    ctx_vars = {"params": v["params"]["context_encoder"],
                "batch_stats": v["batch_stats"]["context_encoder"]}
    from cld_tpu.models.context import ContextEncoder as JaxContext

    jm = JaxContext(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32)

    def f(params):
        out, _ = jm.apply({"params": params, "batch_stats": ctx_vars["batch_stats"]}, jb,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(out["cond_feat"] * w), out["cond_feat"]

    (_, cond), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(ctx_vars["params"])
    port = pv.VaeModel(raster_channels=12, **SIZES)
    tw.load_vae_model(port, v)
    enc = port.context_encoder
    got_cond = enc(tb, train=True)["cond_feat"]
    (got_cond * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got_cond.detach().numpy(), np.asarray(cond), rtol=1e-4, atol=1e-4)
    want = tw.export_context_encoder(_np_tree(grads), ctx_vars["batch_stats"], root="")
    got = {k: p.grad for k, p in enc.named_parameters()}
    assert assert_grads_close(got, want, floor=5e-5) == len(got)


def test_optimizer_matches_the_optax_chain():
    """Coupled L2 then Adam (eps outside the root), the rate read at the count
    before the update: 6 steps on one parameter vector with given gradients,
    one of them with a component at exactly 0."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(7,)).astype(np.float32)
    grads = rng.normal(size=(6, 7)).astype(np.float32)
    grads[0, 0] = 0.0
    sched = dict(base_lr=1e-2, total_epochs=6, steps_per_epoch=1)
    tx = jax_state.make_optimizer(jax_state.warmup_cosine_by_epoch(**sched), weight_decay=0.1)
    jp, opt = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    model = torch.nn.ParameterList([p])
    state = ts.TrainState(model, ts.make_optimizer(model.parameters(), 0.1),
                          ts.warmup_cosine_by_epoch(**sched))
    for k, g in enumerate(grads):
        upd, opt = tx.update(jnp.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {k}")
        assert p.grad is None
    np.testing.assert_array_equal(grads[0] * 0 + p0, p0)
    assert state.step == 6 and float(np.abs(p.detach().numpy() - p0).max()) > 1e-3


def test_schedules_match_at_epoch_boundaries():
    """Rate and beta at and around epoch boundaries; the JAX side computes in
    f32, the port in Python floats: equal to f32 rounding (rtol 1e-6)."""
    kw = dict(base_lr=1e-4, total_epochs=30, steps_per_epoch=10)
    jf, tf = jax_state.warmup_cosine_by_epoch(**kw), ts.warmup_cosine_by_epoch(**kw)
    for step in (0, 9, 10, 11, 50, 99, 100, 101, 199, 200, 299, 300, 450):
        np.testing.assert_allclose(tf(step), float(jf(jnp.asarray(step))), rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))
    assert tf(0) == tf(9) == 0.0 and tf(10) == tf(19) == pytest.approx(1e-5)
    assert tf(100) == pytest.approx(1e-4) and tf(300) == pytest.approx(0.0, abs=1e-12)
    # the record's schedule: 6 epochs of 1,000 steps under a 10-epoch warm-up
    rec = dict(base_lr=1e-4, total_epochs=6, steps_per_epoch=1000)
    jf, tf = jax_state.warmup_cosine_by_epoch(**rec), ts.warmup_cosine_by_epoch(**rec)
    for step in (0, 999, 1000, 5999):
        np.testing.assert_allclose(tf(step), float(jf(jnp.asarray(step))), rtol=1e-6)
    jb, tb = jax_state.BetaSchedule(), ts.BetaSchedule()
    for step in (0, 1, 4500, 8999, 9000, 20000):
        np.testing.assert_allclose(tb(step), float(jb(jnp.asarray(step))), rtol=1e-6)
    assert tb(0) == 0.05 and tb(9000) == tb(10**6) == 0.3


def test_resolve_compute_dtype_and_the_bf16_refusal():
    """"auto" is bf16 on a CUDA device and f32 on the CPU (the JAX package's
    auto: bf16 on its accelerator); the VAE trainer takes bf16, and so do
    the trainers outside the main paths (the zoo's `diff` stays f32, as in
    the JAX package)."""
    assert ts.resolve_compute_dtype("auto") == ts.resolve_compute_dtype("fp32") == torch.float32
    assert ts.resolve_compute_dtype("auto", "cuda") == torch.bfloat16
    assert ts.resolve_compute_dtype("fp32", "cuda") == torch.float32
    assert ts.resolve_compute_dtype("bf16-mixed") == torch.bfloat16
    with pytest.raises(ValueError, match="unknown"):
        ts.resolve_compute_dtype("fp8")
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.train.training.precision = "16-mixed"
    model = VAETrainer(cfg.lock(), device="cpu").init_state(0).model
    assert model.lstmvae.lstm_dec.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for trainer in (EBMTrainer(cfg, device="cpu"), ZooTrainer(cfg, "bc", device="cpu")):
        assert trainer.compute_dtype == torch.bfloat16
    assert ZooTrainer(cfg, "diff", device="cpu").compute_dtype == torch.float32


@pytest.fixture(scope="module")
def trainer_batch():
    cfg = get_registered_experiment_config("cld_smoke")
    assert raster_channels(cfg) == 12
    tb = synthetic_batch(seed=0, batch_size=4, raster_size=64, hist_frames=8, device="cpu")
    return cfg, VAETrainer(cfg, device="cpu"), tb


def test_trainer_steps_follow_the_schedule_and_learn(trainer_batch):
    """With epochs of one step (`cld_smoke`) the first step runs at rate 0 and
    moves nothing; later steps move the parameters by at most the sum of the
    rates (Adam's update is at most ~1 per component) and lower the loss. The
    JAX trainer reports the same rate, beta and metric names."""
    cfg, trainer, tb = trainer_batch
    state = trainer.init_state(seed=0)
    p0 = [p.detach().clone() for p in state.model.parameters()]
    gen = torch.Generator().manual_seed(1)
    state, m0 = trainer.train_step(state, tb, generator=gen)
    assert m0["lr"] == 0.0 and state.step == 1
    assert all(torch.equal(a, b) for a, b in zip(p0, state.model.parameters()))
    losses = [float(m0["loss"])]
    for _ in range(12):
        state, m = trainer.train_step(state, tb, generator=gen)
        losses.append(float(m["loss"]))
    jt = JaxVAETrainer(jax_registered("cld_smoke"))
    for step in range(13):
        np.testing.assert_allclose(trainer.lr_schedule(step), float(jt.lr_schedule(step)),
                                   rtol=1e-6)
    assert sorted(m) == ["beta", "kld", "loss", "lr", "recon", "skipped_nonfinite"]
    assert m["beta"] == pytest.approx(float(jt.beta_schedule(12)), rel=1e-6)
    moved = max(float((a - b).abs().max()) for a, b in zip(p0, state.model.parameters()))
    total_lr = sum(trainer.lr_schedule(k) for k in range(13))
    assert 0.0 < moved <= 1.1 * total_lr
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(losses[:3])
    ev = trainer.eval_step(state, tb)
    assert sorted(ev) == ["kld", "loss", "recon"] and np.isfinite(float(ev["loss"]))
    # the same seed gives the same model; another seed another
    a, b, c = (trainer.init_state(seed=s).model.state_dict() for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


def test_nonfinite_loss_skips_the_update(trainer_batch):
    """A batch with a NaN: parameters, optimizer moments, BatchNorm statistics
    and the step stay as they were, and the step after it works."""
    cfg, trainer, tb = trainer_batch
    state = trainer.init_state(seed=0)
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        state, _ = trainer.train_step(state, tb, generator=gen)

    def frozen():
        sd = {k: v.clone() for k, v in state.model.state_dict().items()}
        opt = [{k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
               for s in state.optimizer.state.values()]
        return sd, opt

    sd0, opt0 = frozen()
    image = tb.image.clone()
    image[0, 0, 0, 0] = float("nan")
    state, m = trainer.train_step(state, tb._replace(image=image), generator=gen)
    assert m["skipped_nonfinite"] == 1.0 and not np.isfinite(float(m["loss"]))
    sd1, opt1 = frozen()
    assert state.step == 2
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
               for a, b in zip(opt0, opt1) for k in a)
    assert all(p.grad is None for p in state.model.parameters())
    state, m = trainer.train_step(state, tb, generator=gen)
    assert m["skipped_nonfinite"] == 0.0 and state.step == 3
