"""The port's VAE (`cld_tpu_torch.models.vae`) against the JAX package's at
the `cld_smoke` widths (raster 64, 12 raster channels, B=4): the LSTM encoder
and `traj2z`, the deterministic decoder, `VaeModel`'s forward and losses, the
ground-truth state+action, the dropout between the LSTM layers, and the
``strict=True`` load of converted variables.

The reparametrization noise cannot be drawn alike in the two packages, so it
is read off the JAX outputs, noise = (z - mean) / exp(0.5 logvar), and handed
to the port. Tolerances: rtol 1e-5 / atol 1e-5 on sequences (f32 LSTMs of 52
steps on two libraries' GEMMs, behind the ResNet's rtol 1e-4 conditioning:
the LSTM's squashing keeps the latter's share small); rtol 1e-5 on the
losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.models import vae as jax_vae
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.models import vae as pv
from cld_tpu_torch.ops import lstm_kernels
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
SEQ = dict(rtol=1e-5, atol=1e-5)
SIZES = dict(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32, vae_hidden_size=16)
BETA = 0.07


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    """(flax module, its variables with non-trivial BatchNorm statistics, the
    port's module loaded from them, the JAX batch, the port's batch)."""
    jb = jax_synthetic(seed=0, batch_size=4, raster_size=64, hist_frames=8)
    m = jax_vae.VaeModel(**SIZES)
    v = jax.jit(lambda r, b: m.init(r, b, 0.05))(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, jb)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.normal(size=a.shape) * 0.1 if p[-1].key == "mean"
                      else rng.uniform(0.5, 1.5, size=a.shape)).astype(np.float32),
        _np_tree(v["batch_stats"]))
    v = {"params": _np_tree(v["params"]), "batch_stats": stats}
    port = pv.VaeModel(raster_channels=12, **SIZES)
    tw.load_vae_model(port, v)
    tb = synthetic_batch(seed=0, batch_size=4, raster_size=64, hist_frames=8, device="cpu")
    return m, v, port, jb, tb


@pytest.fixture(scope="module")
def jax_encoded(pair):
    m, v, _, jb, _ = pair
    z, mu, logvar, aux = jax.jit(lambda v, b, k: m.apply(v, b, method="encode",
                                                         rngs={"sample": k}))(
        v, jb, jax.random.key(7))
    z, mu, logvar = (np.array(a) for a in (z, mu, logvar))
    return z, mu, logvar, (z - mu) / np.exp(0.5 * logvar), np.array(aux["cond_feat"])


def test_strict_load_covers_every_key(pair):
    _, v, port, _, _ = pair
    sd = tw.export_vae_checkpoint(v)
    assert sorted(k[len("vae."):] for k in sd) == sorted(port.state_dict())
    assert {"lstmvae.lstm_enc.lstm.weight_ih_l0", "lstmvae.mu.weight", "lstmvae.logvar.bias",
            "context_encoder.map_encoder.encoder_heads.map_model.bn1.running_var"} <= set(
                port.state_dict())
    bad = dict(v, params=dict(v["params"], lstmvae={k: a for k, a in v["params"]["lstmvae"].items()
                                                    if k != "mu"}))
    with pytest.raises((KeyError, RuntimeError)):
        tw.load_vae_model(pv.VaeModel(raster_channels=12, **SIZES), bad)


def test_ground_truth_state_and_action_matches(pair):
    _, _, _, jb, tb = pair
    want = np.asarray(jax_vae.get_state_and_action_from_batch(jb))
    got = pv.get_state_and_action_from_batch(tb).numpy()
    # speeds and accelerations are finite differences over dt = 0.1 of positions
    # up to ~60 m: a last-bit difference of cos / sin there is 1e-5 here
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5)
    assert got.shape == (4, 52, 6)


def test_encode_matches_flax_with_its_noise(pair, jax_encoded):
    _, _, port, _, tb = pair
    z, mu, logvar, noise, cond = jax_encoded
    assert np.abs(noise).max() > 1.0  # the JAX side did draw noise
    with torch.no_grad():
        gz, gmu, glv, aux = port.encode(tb, noise=torch.from_numpy(noise))
        z0 = port.encode(tb)[0]  # no noise, no generator: z = mean
    np.testing.assert_allclose(aux["cond_feat"].numpy(), cond, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gmu.numpy(), mu, **SEQ)
    np.testing.assert_allclose(glv.numpy(), logvar, **SEQ)
    np.testing.assert_allclose(gz.numpy(), z, **SEQ)
    np.testing.assert_array_equal(z0.numpy(), gmu.numpy())


def test_deterministic_decode_matches_flax_on_both_port_paths(pair, jax_encoded):
    m, v, port, _, _ = pair
    z, _, _, _, cond = jax_encoded
    want = np.asarray(jax.jit(lambda v, z, c: m.apply(v, z, c, method="decode"))(
        v, jnp.asarray(z), jnp.asarray(cond)))
    tz, tc = torch.from_numpy(z), torch.from_numpy(cond)
    dec = port.lstmvae.lstm_dec
    with torch.no_grad():
        fused = port.decode(tz, tc)  # the kernel-backed core (its plain version here)
        layered = dec.hid2act(pv._lstm_stack(dec.lstm, tz, dec.cond2hidden(tc)))
    np.testing.assert_allclose(fused.numpy(), want, **SEQ)
    np.testing.assert_allclose(layered.numpy(), want, **SEQ)


def test_forward_and_losses_match_flax(pair, jax_encoded):
    m, v, port, jb, tb = pair
    _, _, _, noise, _ = jax_encoded
    # `__call__` draws the same noise as `encode` from the same "sample" key:
    # both reach `traj2z` in the module `lstmvae`, whose path flax folds in
    want = jax.jit(lambda v, b, k: m.apply(v, b, BETA, train=False, rngs={"sample": k}))(
        v, jb, jax.random.key(7))
    with torch.no_grad():
        got = port(tb, BETA, train=False, noise=torch.from_numpy(noise))
    for k in ("loss", "recon", "kld"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["recon_actions"].numpy(), np.asarray(want["recon_actions"]),
                               **SEQ)


def test_vae_loss_matches_flax_on_given_tensors():
    rng = np.random.default_rng(3)
    gt, rec = rng.normal(size=(3, 52, 6)), rng.normal(size=(3, 52, 2))
    mu, lv = rng.normal(size=(3, 52, 4)), rng.normal(size=(3, 52, 4)) * 0.5
    a = [x.astype(np.float32) for x in (gt, rec, mu, lv)]
    want = jax_vae.vae_loss(*(jnp.asarray(x) for x in a), 0.3)
    got = pv.vae_loss(*(torch.from_numpy(x) for x in a), 0.3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_dropout_mask_sits_between_the_layers_scaled_by_the_keep_rate(pair):
    """Layer 0's output times the keep-mask over 0.8 feeds layer 1: held
    against a step-by-step LSTM written out here. Train mode without masks
    draws them from the generator, reproducibly."""
    _, _, port, _, _ = pair
    enc = port.lstmvae.lstm_enc
    g = torch.Generator().manual_seed(0)
    x, cond = torch.randn((3, 52, 6), generator=g), torch.randn((3, 32), generator=g)
    mask = pv.dropout_keep_mask((3, 52, 16), g, "cpu")
    assert 0.7 < float(mask.mean()) < 0.9 and set(mask.unique().tolist()) == {0.0, 1.0}

    def layer(n, seq, h):
        w = enc.lstm
        c, out = torch.zeros_like(h), []
        for t in range(seq.shape[1]):
            pre = (seq[:, t] @ getattr(w, f"weight_ih_l{n}").t() + getattr(w, f"bias_ih_l{n}")
                   + h @ getattr(w, f"weight_hh_l{n}").t() + getattr(w, f"bias_hh_l{n}"))
            i, f, gg, o = lstm_kernels._gate_act(pre, 16)
            c = f * c + i * gg
            h = o * torch.tanh(c)
            out.append(h)
        return torch.stack(out, 1)

    with torch.no_grad():
        h0 = enc.cond2hidden(cond)
        want = layer(1, layer(0, x, h0) * mask / 0.8, h0)
        got = enc(x, cond, mask)
        plain = enc(x, cond)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SEQ)
        np.testing.assert_allclose(plain.numpy(), layer(1, layer(0, x, h0), h0).numpy(), **SEQ)
        assert float((got - plain).abs().max()) > 1e-3
        a = port.lstmvae(x, cond, train=True, generator=torch.Generator().manual_seed(5))
        b = port.lstmvae(x, cond, train=True, generator=torch.Generator().manual_seed(5))
        c = port.lstmvae(x, cond, train=False)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert float((a[0] - c[0]).abs().max()) > 1e-3
