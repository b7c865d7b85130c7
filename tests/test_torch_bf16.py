"""bf16 mixed precision of the port's main paths against the JAX package's,
at small widths on the CPU (raster 64, B = 4 or 8).

* `resolve_compute_dtype`: the JAX table, "auto" float32 on the CPU and
  bf16 on a CUDA device.
* The bf16 plain versions of the LSTM sweeps (`lstm2_core_ref`,
  `lstm2_bwd_ref` behind `Lstm2Core`) against the Pallas `_fwd_kernel` /
  `_bwd_kernel_v2` in interpret mode with bf16 inputs, as
  `tests/test_lstm_pallas.py:93-112` runs them: the four state sequences,
  and dg1 with the f32-formed weight and h0 gradients; within one bf16 ulp
  (2^-8) of max |JAX|.
* The networks at bf16 over float32 parameters, against the flax modules at
  `dtype=bfloat16` from the same weights: `VaeModel`'s loss and gradients,
  the temporal UNet's and `MLPResDenoiser`'s DM loss (a DM step's loss and
  gradients, the same timesteps and noise), PPO's surrogate (log-prob and
  ratio in f32), and a 2-step guided call (its guidance gradient, and the
  decoded trajectories). autocast and flax round at different places (flax
  keeps activations between layers in bf16, autocast keeps some norms'
  outputs in f32), so the comparison is the repo's bf16-twin rule
  (ROADMAP "bf16 twins"): a loss within rtol 2e-3 / atol 1e-2, a gradient
  at cosine > 0.999.
* The train CLI under `--precision bf16` on the CPU for vae, dm and ppo,
  and `--mode zoo --precision bf16`, which runs in bf16 too.

The JAX side is jitted with weights and batches passed as arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.algos import dm as jax_dm
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.guidance import losses as jlo
from cld_tpu.guidance import perturbation as jpt
from cld_tpu.models.dm_mlp import MLPResDenoiser as JaxMLPRes
from cld_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from cld_tpu.models.vae import VaeModel as JaxVae
from cld_tpu.ops import diffusion as jax_diff
from cld_tpu.ops import lstm_pallas as lp
from cld_tpu.training import state as jax_state
from cld_tpu.data.batch import get_current_states as jax_current
from cld_tpu.models.vae import convert_action_to_state_and_action as jax_convert
from cld_tpu.ops.dynamics import UnicycleParams as JaxDyn
from cld_tpu.ops.geometry import world_from_agent_matrix as jax_wfa
from cld_tpu.ops.normalization import TrajNormalizer as JaxNormalizer
from cld_tpu_torch import pipeline, train
from cld_tpu_torch.algos import dm as tdm
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.guidance import losses as tlo
from cld_tpu_torch.guidance import perturbation as tpt
from cld_tpu_torch.models.dm_mlp import MLPResDenoiser
from cld_tpu_torch.models.vae import VaeModel, convert_action_to_state_and_action, decode_actions
from cld_tpu_torch.ops import diffusion, lstm_kernels
from cld_tpu_torch.ops.precision import set_compute_dtype
from cld_tpu_torch.training import state as ts
from cld_tpu_torch.training.ppo import surrogate_loss
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
BF16 = torch.bfloat16
SIZES = dict(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32, vae_hidden_size=16)
B, T, L, COND, N_STEPS = 4, 52, 4, 32, 10
LOSS = dict(rtol=2e-3, atol=1e-2)  # the bf16-twin rule
COSINE = 0.999


def _np(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _port_grads(module) -> dict:
    """Parameter gradients by name. An LSTM layer's two biases are one flax
    bias (exported as bias_ih, with bias_hh 0): bias_hh is left out."""
    return {n: p.grad.numpy().ravel() for n, p in module.named_parameters()
            if ".bias_hh_l" not in n}


def _assert_twins(loss_port, loss_jax, g_port, g_jax, what):
    np.testing.assert_allclose(float(loss_port.detach()), float(loss_jax), **LOSS, err_msg=what)
    cos = _cosine(g_port, g_jax)
    assert cos > COSINE, f"{what}: gradient cosine {cos}"


# ---------------------------------------------------------------------------
# the precision table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["bf16", "bf16-mixed", "bf16-true", "16", "16-mixed",
                                       "fp32", "32", "32-true"])
def test_resolve_compute_dtype_follows_the_jax_table(precision):
    want = jax_state.resolve_compute_dtype(precision)
    got = ts.resolve_compute_dtype(precision)
    assert (got == BF16) == (want == jnp.bfloat16)
    assert ts.resolve_compute_dtype(precision, "cuda") == got


def test_auto_is_float32_on_the_cpu_and_bf16_on_the_card():
    assert jax_state.resolve_compute_dtype("auto") == jnp.float32  # JAX on the CPU
    assert ts.resolve_compute_dtype("auto") == ts.resolve_compute_dtype(None) == torch.float32
    assert ts.resolve_compute_dtype("auto", torch.device("cuda", 0)) == BF16
    models = pipeline.build_models(seed=0, device="cpu", cond_feat_dim=COND, map_feature_dim=32,
                                   curr_state_feat_dim=16, hidden_size=16, base_dim=8,
                                   n_diffusion_steps=2)
    assert models.compute_dtype == torch.float32 and models.unet.compute_dtype == torch.float32


# ---------------------------------------------------------------------------
# the LSTM sweeps' bf16 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7, 16), (2, 5, 8)])
def test_bf16_sweeps_match_the_pallas_kernels_in_interpret_mode(shape):
    Bn, Tn, H = shape
    rng = np.random.default_rng(sum(shape))
    arrs = [rng.normal(size=(Bn, Tn, 4 * H)), rng.normal(size=(Bn, H)),
            rng.normal(size=(H, 4 * H)) * 0.3, rng.normal(size=(2 * H, 4 * H)) * 0.3,
            rng.normal(size=(4 * H,)) * 0.3]
    dy = rng.normal(size=(Bn, Tn, H))
    jb = [jnp.asarray(a, jnp.float32).astype(jnp.bfloat16) for a in arrs]
    dyb = jnp.asarray(dy, jnp.float32).astype(jnp.bfloat16)

    def jax_side(jb, dyb):  # both sweeps in interpret mode, one jitted compile
        h1c1, yc2 = lp._core_fwd_impl(*jb, True)
        return h1c1, yc2, lp._core_bwd(True, (*jb, h1c1, yc2), dyb)

    h1c1, yc2, jgrads = jax.jit(jax_side)(jb, dyb)

    tb = [torch.from_numpy(_np(a)).to(BF16) for a in jb]
    y, h1s, c1s, c2s = lstm_kernels.lstm2_core_ref(*tb)
    want = {"y": yc2[..., :H], "h1": h1c1[..., :H], "c1": h1c1[..., H:], "c2": yc2[..., H:]}
    for name, got in zip(want, (y, h1s, c1s, c2s)):
        assert got.dtype == BF16
        w = _np(want[name])
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0, atol=2**-8 * np.abs(w).max(),
                                   err_msg=name)
    leaves = [a.clone().requires_grad_(True) for a in tb]
    lstm_kernels.lstm2_core(*leaves).backward(torch.from_numpy(dy.astype(np.float32)).to(BF16))
    for name, leaf, gw in zip(("dxg1 (= dg1)", "dh0", "dWh1", "dW2", "db2"), leaves, jgrads):
        assert leaf.grad.dtype == BF16
        w = _np(gw)
        np.testing.assert_allclose(leaf.grad.float().numpy(), w, rtol=0,
                                   atol=2**-8 * np.abs(w).max(), err_msg=name)


def test_lstm_wrappers_refuse_mixed_dtypes():
    H = 8
    args = [torch.zeros(2, 3, 4 * H), torch.zeros(2, H), torch.zeros(H, 4 * H),
            torch.zeros(2 * H, 4 * H), torch.zeros(4 * H)]
    with pytest.raises(TypeError, match="mixed dtypes"):
        lstm_kernels.lstm2_fwd(args[0].to(BF16), *args[1:])
    seqs = [torch.zeros(2, 3, H)] * 4
    with pytest.raises(TypeError, match="mixed dtypes"):
        lstm_kernels.lstm2_bwd(torch.zeros(2, 3, H, dtype=BF16), *args, *seqs)


# ---------------------------------------------------------------------------
# the networks at bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_pair():
    """(flax VaeModel at bf16, its f32 variables, the port's VaeModel at bf16
    from them, the JAX batch, the port's batch)."""
    jb = jax_synthetic(seed=0, batch_size=B, raster_size=64, hist_frames=8)
    m32 = JaxVae(**SIZES)
    v = jax.jit(lambda r, b: m32.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, jb)
    v = jax.tree.map(np.asarray, v)
    port = set_compute_dtype(VaeModel(raster_channels=12, **SIZES), BF16)
    tw.load_vae_model(port, v)
    tb = synthetic_batch(seed=0, batch_size=B, raster_size=64, hist_frames=8, device="cpu")
    return JaxVae(**SIZES, dtype=jnp.bfloat16), v, port, jb, tb


def test_vae_loss_and_gradients_are_bf16_twins(vae_pair):
    m, v, port, jb, tb = vae_pair

    def loss_fn(params, stats, batch):
        return m.apply({"params": params, "batch_stats": stats}, batch, 0.07)["loss"]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(v["params"], v["batch_stats"], jb)
    port.zero_grad()
    out = port(tb, 0.07)
    assert out["loss"].dtype == torch.float32 and out["recon_actions"].dtype == BF16
    out["loss"].backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in port.parameters())
    jflat = tw.export_vae_checkpoint({"params": jg, "batch_stats": v["batch_stats"]}, prefix="")
    grads = _port_grads(port)
    names = [n for n in grads if n in jflat]
    assert len(names) == len(grads)
    _assert_twins(out["loss"], jl, np.concatenate([grads[n] for n in names]),
                  np.concatenate([np.ravel(jflat[n]) for n in names]), "VaeModel")


def _dm_noise(key, n_timesteps):
    """t and the Gaussian exactly as `cld_tpu.algos.dm.dm_loss` draws them."""
    t_rng, noise_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (B,), 0, n_timesteps)
    noise = jax.random.normal(noise_rng, (B, T, L), jnp.float32)
    return t, noise


def _dm_denoisers():
    """(flax TemporalMapUnet at bf16, its f32 variables, the port's at bf16
    from them), at base dim 8."""
    j32 = JaxUnet(transition_dim=L, output_dim=L, dim=8)
    v = jax.tree.map(np.asarray, jax.jit(j32.init)(
        jax.random.key(2), jnp.zeros((B, T, L)), jnp.zeros((B, COND)), jnp.zeros((B,), jnp.int32)))
    port = pipeline.build_models(seed=0, device="cpu", cond_feat_dim=COND, base_dim=8,
                                 latent_size=L, n_diffusion_steps=N_STEPS,
                                 precision="bf16").unet.requires_grad_(True)
    tw.load_temporal_unet(port, v)
    return JaxUnet(transition_dim=L, output_dim=L, dim=8, dtype=jnp.bfloat16), v, port


@pytest.mark.parametrize("arch", ["TemporalMapUnet", "MLPResNetwork"])
def test_dm_step_loss_and_gradients_are_bf16_twins(arch):
    """The DM step's loss (epsilon MSE in f32 over a bf16 denoiser) and its
    gradients, at the same timesteps and noise."""
    rng = np.random.default_rng(3)
    z0 = rng.normal(size=(B, T, L)).astype(np.float32)
    cond = rng.normal(size=(B, COND)).astype(np.float32)
    if arch == "TemporalMapUnet":
        jbf, v, port = _dm_denoisers()
    else:
        j32, jbf = (JaxMLPRes(horizon=T, transition_dim=L, width=64, dtype=d)
                    for d in (jnp.float32, jnp.bfloat16))
        zeros = (jnp.zeros((B, T, L)), jnp.zeros((B, COND)), jnp.zeros((B,), jnp.int32))
        v = jax.tree.map(np.asarray, jax.jit(j32.init)(jax.random.key(2), *zeros))
        port = set_compute_dtype(MLPResDenoiser(T, L, COND, width=64), BF16)
        tw.load_flax(port, v)
    schedule = jax_diff.make_schedule(N_STEPS)
    key = jax.random.key(4)

    def loss_fn(params, z0, cond, key):
        return jax_dm.dm_loss(lambda x, c, t: jbf.apply({"params": params}, x, c, t), schedule,
                              key, z0, cond)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(v["params"], z0, cond, key)
    t, noise = _dm_noise(key, N_STEPS)
    port.zero_grad()
    loss = tdm.dm_loss(port, diffusion.make_schedule(N_STEPS, device="cpu"), torch.from_numpy(z0),
                       torch.from_numpy(cond), torch.from_numpy(np.array(t)).long(),
                       torch.from_numpy(np.array(noise)))
    assert loss.dtype == torch.float32
    loss.backward()
    if arch == "TemporalMapUnet":
        jflat = tw.export_temporal_unet(jax.tree.map(np.asarray, jg), root="")
    else:
        jflat = tw.export_flax(port, jax.tree.map(np.asarray, jg))
    grads = _port_grads(port)
    assert sorted(grads) == sorted(k for k in jflat if k in grads)
    _assert_twins(loss, jl, np.concatenate([grads[n] for n in sorted(grads)]),
                  np.concatenate([np.ravel(jflat[n]) for n in sorted(grads)]), arch)


def test_ppo_update_over_a_bf16_denoiser_is_a_bf16_twin():
    """One PPO iteration's clipped surrogate over a bf16 denoiser, its
    log-prob, ratio and loss in f32, as the collection leaves it: each side's
    x_{t-1} is its own posterior mean plus sigma times the same noise and its
    old log-prob its own, so the ratio is 1. Taken at the schedule's last
    timestep: at t = 0 sigma is clipped to 1e-10, where any rounding sends
    the log-prob's gradient to ~1e20 in either package."""
    jbf, v, port = _dm_denoisers()
    rng = np.random.default_rng(5)
    x_t = rng.normal(size=(B, T, L)).astype(np.float32)
    cond = rng.normal(size=(B, COND)).astype(np.float32)
    noise = rng.normal(size=(B, T, L)).astype(np.float32)
    adv = rng.normal(size=(B,)).astype(np.float32)
    t = np.full((B,), N_STEPS - 1, np.int64)
    schedule = jax_diff.make_schedule(N_STEPS)

    def jax_collect(params, x_t, cond, noise):
        eps = jbf.apply({"params": params}, x_t, cond, jnp.asarray(t, jnp.int32))
        mean, log_var = jax_diff.posterior_mean_logvar(schedule, x_t, eps.astype(jnp.float32),
                                                       jnp.asarray(t, jnp.int32))
        x_tm1 = mean + jnp.exp(0.5 * log_var) * noise
        logp = jax_dm.transition_log_prob(lambda x, c, tt: jbf.apply({"params": params}, x, c, tt),
                                          schedule, x_t, x_tm1, cond, jnp.asarray(t, jnp.int32))
        return x_tm1, logp

    def loss_fn(params, x_t, x_tm1, cond, logp_old, adv):
        logp = jax_dm.transition_log_prob(lambda x, c, tt: jbf.apply({"params": params}, x, c, tt),
                                          schedule, x_t, x_tm1, cond, jnp.asarray(t, jnp.int32))
        ratio = jnp.exp(logp - logp_old)
        surr2 = jnp.clip(ratio, 0.8, 1.2) * adv
        return -jnp.mean(jnp.minimum(ratio * adv, surr2))

    jx, jlogp = jax.jit(jax_collect)(v["params"], x_t, cond, noise)
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(v["params"], x_t, jx, cond, jlogp, adv)

    tsched = diffusion.make_schedule(N_STEPS, device="cpu")
    xt, c, tt = torch.from_numpy(x_t), torch.from_numpy(cond), torch.from_numpy(t)
    with torch.no_grad():
        eps = port(xt, c, tt).to(torch.float32)
        mean, log_var = diffusion.posterior_mean_logvar(tsched, xt, eps, tt)
        x_tm1 = mean + torch.exp(0.5 * log_var) * torch.from_numpy(noise)
        logp_old = tdm.transition_log_prob(port, tsched, xt, x_tm1, c, tt)
    port.zero_grad()
    logp = tdm.transition_log_prob(port, tsched, xt, x_tm1, c, tt)
    assert logp.dtype == torch.float32
    loss, stats = surrogate_loss(logp, logp_old, torch.from_numpy(adv), 0.2)
    assert float(stats["ratio_mean"].detach()) == 1.0
    loss.backward()
    jflat = tw.export_temporal_unet(jax.tree.map(np.asarray, jg), root="")
    grads = _port_grads(port)
    _assert_twins(loss, jl, np.concatenate([grads[n] for n in sorted(grads)]),
                  np.concatenate([np.ravel(jflat[n]) for n in sorted(grads)]), "PPO surrogate")


A, GB = 4, 8  # agents per scene, guided batch


@pytest.fixture(scope="module")
def guided_pair():
    jb = jax_synthetic(seed=0, batch_size=GB, raster_size=64)
    vae32 = JaxVae(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=COND,
                   vae_hidden_size=16, vae_latent_size=L)
    vv = jax.tree.map(np.asarray, jax.jit(lambda r, b: vae32.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, jb))
    unet32 = JaxUnet(transition_dim=L, output_dim=L, dim=8)
    uv = jax.tree.map(np.asarray, jax.jit(unet32.init)(
        jax.random.key(2), jnp.zeros((GB, T, L)), jnp.zeros((GB, COND)),
        jnp.zeros((GB,), jnp.int32)))
    models = pipeline.build_models(seed=0, device="cpu", cond_feat_dim=COND, map_feature_dim=32,
                                   curr_state_feat_dim=16, hidden_size=16, latent_size=L,
                                   base_dim=8, n_diffusion_steps=2, precision="bf16")
    tw.load_context_encoder(models.context, vv)
    tw.load_lstm_decoder(models.decoder, vv)
    tw.load_temporal_unet(models.unet, uv)
    vae = JaxVae(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=COND,
                 vae_hidden_size=16, vae_latent_size=L, dtype=jnp.bfloat16)
    unet = JaxUnet(transition_dim=L, output_dim=L, dim=8, dtype=jnp.bfloat16)
    return jb, vae, vv, unet, uv, models


def _jax_bf16_decode(vv, z, cond):
    """The JAX package's fused decoder in its bf16 configuration
    (`lstm_pallas.fused_decode_actions` under impl "pallas": parameters, z
    and cond cast to bf16), its Pallas kernels in interpret mode."""
    p = lp.extract_decoder_params(vv["params"]["lstmvae"]["lstm_dec"])
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    xg1 = z.astype(jnp.bfloat16) @ p.Wx1 + p.b1
    h0 = cond.astype(jnp.bfloat16) @ p.Wc + p.bc
    y = lp.lstm2_core(xg1, h0, p.Wh1, p.W2, p.b2, True)
    return (y @ p.Wo + p.bo).astype(jnp.float32)


def _jax_guidance(jb, vae, vv, cond=None):
    """The flagship rules' context and the JAX package's bf16 decoder (its
    CPU default, "ref", keeps the f32 parameters), conditioned on `cond`
    (default: the bf16 context encoder's)."""
    dyn = JaxDyn(0.5, 2 * np.pi, -10.0, 8.0)
    if cond is None:
        cond = vae.apply(vv, jb, method=lambda m, b: m.context_encoder(b))["cond_feat"]
    curr = jax_current(jb)

    def decode_fn(z):
        acts = _jax_bf16_decode(vv, z, cond)
        return jax_convert(acts, curr, dyn, JaxNormalizer(), descaled_output=True)[:, None]

    lane = (np.arange(GB) % A).astype(np.float32)
    pos_w = jnp.asarray(np.stack([lane * 8.0, (lane % 2) * 3.5 - 1.75], -1))
    ctx = jlo.prepack_drivable(jlo.GuidanceContext(
        drivable_map=jb.drivable_map, raster_from_agent=jb.raster_from_agent, extent=jb.extent,
        curr_speed=jb.curr_speed, world_from_agent=jax_wfa(pos_w, jnp.zeros((GB,))),
        scene_index=jnp.arange(GB) // A))
    specs = [jpt.GuidanceSpec(jlo.AgentCollisionLoss(num_disks=5, buffer_dist=0.2,
                                                     scene_block=A), 10.0),
             jpt.GuidanceSpec(jlo.MapCollisionLoss(num_points_lw=(10, 10)), 10.0)]
    return cond, decode_fn, ctx, specs


def _jax_guided_call(jb, vae, vv, unet, uv, key):
    schedule = jax_diff.make_schedule(2)
    cond, decode_fn, ctx, specs = _jax_guidance(jb, vae, vv)
    gfn = jpt.make_perturbation_guidance(
        ctx, specs, decode_fn, lr=0.3, grad_steps=1, perturb_th=None,
        sigma_schedule=jnp.exp(0.5 * schedule.posterior_log_variance_clipped))
    out = jax_dm.sample_traj(lambda x, c, t: unet.apply(uv, x, c, t), schedule, key, cond, T, L,
                             guidance_fn=gfn)
    traj = decode_fn(out["pred_traj"])
    return traj, jpt.compute_guidance_loss(traj, ctx, specs)[0]


def _jax_guidance_grad(jb, vae, vv, z, cond):
    _, decode_fn, ctx, specs = _jax_guidance(jb, vae, vv, cond)
    return jax.grad(lambda z: jpt.compute_guidance_loss(decode_fn(z), ctx, specs)[0])(z)


def test_guided_call_at_bf16_is_a_bf16_twin(guided_pair):
    """A 2-step guided call at bf16 (the flagship rules, one Adam step per
    guided step): the guidance gradient at a fixed latent through the bf16
    decoder, and the guidance cost of the decoded trajectories (the call's
    loss); the trajectories stay float32. The gradient is taken from the
    same conditioning on both sides: the flagship costs are hinges, nonzero
    here for two agents only, so a bf16 rounding of cond_feat (held by the
    VAE test) moves their support and the gradient with it (cosine 0.52
    between the JAX package's own bf16 and f32 conditioning on this
    fixture)."""
    jb, vae, vv, unet, uv, models = guided_pair
    tb = synthetic_batch(seed=0, batch_size=GB, raster_size=64, device="cpu")
    z = np.random.default_rng(3).normal(size=(GB, T, L)).astype(np.float32)
    cond_j = jax.jit(lambda v, b: vae.apply(v, b, method=lambda m, b: m.context_encoder(b)))(
        vv, jb)["cond_feat"]
    jg = jax.jit(_jax_guidance_grad, static_argnums=1)(jb, vae, vv, z, cond_j)
    specs = pipeline.flagship_guidance_specs(A)
    wfa, scene = pipeline.scene_world_poses(GB, A, "cpu")
    ctx = tlo.prepack_drivable(tlo.GuidanceContext(
        drivable_map=tb.drivable_map, raster_from_agent=tb.raster_from_agent, extent=tb.extent,
        curr_speed=tb.curr_speed, world_from_agent=wfa, scene_index=scene))
    with torch.no_grad():
        aux = models.context(tb)
    assert aux["cond_feat"].dtype == BF16
    cond = torch.from_numpy(_np(cond_j)).to(BF16)

    def decode_fn(v):
        acts = decode_actions(models.decoder, v, cond)
        assert acts.dtype == torch.float32
        return convert_action_to_state_and_action(acts, aux["curr_states"], models.dyn,
                                                  pipeline.TrajNormalizer(),
                                                  descaled_output=True)[:, None]

    g = tpt.guidance_gradient(torch.from_numpy(z), ctx, specs, decode_fn)
    assert g.dtype == torch.float32
    cos = _cosine(g.numpy(), np.asarray(jg))
    assert cos > COSINE, f"guidance gradient cosine {cos}"

    key = jax.random.key(7)
    traj_j, cost_j = jax.jit(_jax_guided_call, static_argnums=(1, 3))(jb, vae, vv, unet, uv, key)
    rng, init_rng = jax.random.split(key)
    x_init = torch.from_numpy(np.array(jax.random.normal(init_rng, (GB, T, L), jnp.float32)))
    noises = torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.normal(k, (GB, T, L), jnp.float32))(jax.random.split(rng, 2))))
    out = pipeline.guided_collect(models, tb, agents_per_scene=A, x_init=x_init,
                                  step_noises=noises)
    assert out["traj"].dtype == out["pred_traj"].dtype == torch.float32
    cost = tpt.compute_guidance_loss(out["traj"], ctx, specs)[0]
    np.testing.assert_allclose(float(cost), float(cost_j), **LOSS)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_runs_vae_dm_ppo_in_bf16_and_refuses_the_zoo(tmp_path):
    base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", str(tmp_path),
            "--precision", "bf16", "--steps", "1"]
    vae = train.main(base + ["--mode", "vae"])
    assert vae.model.lstmvae.lstm_enc.lstm.weight_ih_l0.dtype == torch.float32
    assert vae.model.context_encoder.compute_dtype == BF16 and vae.step == 1
    ckpt = ["--vae-ckpt", str(tmp_path / "vae" / "ckpt_final")]
    dm = train.main(base + ["--mode", "dm", *ckpt])
    assert dm.model.compute_dtype == BF16 and dm.step == 1
    ppo = train.main(base + ["--mode", "ppo", *ckpt])
    assert ppo.model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in ppo.model.parameters())
    zoo = train.main(base + ["--mode", "zoo", "--zoo-algo", "bc"])
    assert zoo.model.compute_dtype == zoo.model.context_encoder.compute_dtype == BF16
    assert zoo.step == 1 and all(p.dtype == torch.float32 for p in zoo.model.parameters())
