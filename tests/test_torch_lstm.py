"""The port's LSTM decoder core (`cld_tpu_torch.ops.lstm_kernels`) against
the JAX package's fused decoder (`cld_tpu.ops.lstm_pallas`).

On the CPU the port's wrappers take the kernels' plain versions; the JAX
side runs its jnp reference and its Pallas kernels in interpret mode, f32
storage, its reverse sweep in both of its kernels: v2, the default, and v1
(`CLD_LSTM_BWD_IMPL=v1`), which computes the same gate cotangents in another
memory layout and which the port's one reverse sweep also stands for.
Tolerances: values at rtol 1e-5 / atol 1e-6 (f32, the two sides
sum the gate products in another order); gradients at rtol 1e-4 / atol
1e-5 (the reverse sweep compounds that rounding over T steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.models.lstm import LSTMVAE
from cld_tpu.ops import lstm_pallas as jl
from cld_tpu_torch.models.vae import LSTMDecoder
from cld_tpu_torch.ops import lstm_kernels as tl
from cld_tpu_torch.utils.weights import export_lstm_vae

torch.set_num_threads(2)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _core_inputs(seed, B, T, H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    return [
        rng.normal(size=(B, T, 4 * H)).astype(np.float32),
        rng.normal(size=(B, H)).astype(np.float32) * 0.5,
        rng.uniform(-k, k, size=(H, 4 * H)).astype(np.float32),
        rng.uniform(-k, k, size=(2 * H, 4 * H)).astype(np.float32),
        rng.uniform(-k, k, size=(4 * H,)).astype(np.float32),
    ]


@pytest.mark.parametrize("B,T,H", [(3, 7, 16), (4, 13, 8)])
def test_core_values_match_jax(B, T, H):
    args = _core_inputs(0, B, T, H)
    want = jl.lstm2_core_ref(*map(jnp.asarray, args))
    got = tl.lstm2_core_ref(*map(torch.from_numpy, args))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **VAL)
    y_pallas = jl.lstm2_core(*map(jnp.asarray, args), True)
    np.testing.assert_allclose(tl.lstm2_core(*map(torch.from_numpy, args)).numpy(),
                               np.asarray(y_pallas), **VAL)


@pytest.mark.parametrize("B,T,H", [(3, 7, 16), (2, 5, 8)])
def test_core_vjp_matches_jax_in_all_five_arguments(B, T, H):
    args = _core_inputs(1, B, T, H)
    ct = np.random.default_rng(2).normal(size=(B, T, H)).astype(np.float32)

    def loss_jax(*a):
        return jnp.sum(jl.lstm2_core(*a, True) * ct)

    want = jax.grad(loss_jax, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))

    def torch_grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
        (fn(*ts) * torch.from_numpy(ct)).sum().backward()
        return [t.grad.numpy() for t in ts]

    got = torch_grads(tl.lstm2_core)
    autograd_ref = torch_grads(lambda *a: tl.lstm2_core_ref(*a)[0])
    for w, g, r in zip(want, got, autograd_ref):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD)
        np.testing.assert_allclose(g, r, **GRAD)


def test_bwd_ref_gate_cotangents_are_the_xg1_gradient():
    B, T, H = 2, 6, 8
    args = [torch.from_numpy(a) for a in _core_inputs(3, B, T, H)]
    y, h1s, c1s, c2s = tl.lstm2_core_ref(*args)
    dy = torch.from_numpy(np.random.default_rng(4).normal(size=(B, T, H)).astype(np.float32))
    dg1, dg2 = tl.lstm2_bwd_ref(dy, *args, h1s, c1s, y, c2s)
    xg1 = args[0].clone().requires_grad_(True)
    (tl.lstm2_core_ref(xg1, *args[1:])[0] * dy).sum().backward()
    np.testing.assert_allclose(dg1.numpy(), xg1.grad.numpy(), **GRAD)
    assert dg2.shape == (B, T, 4 * H)


@pytest.mark.parametrize("impl", ["v1", "v2"])
@pytest.mark.parametrize("B,T,H", [(3, 7, 16), (2, 5, 8)])
def test_bwd_ref_matches_jax_reverse_sweep_kernels(monkeypatch, impl, B, T, H):
    """`lstm2_bwd_ref` (the contract of the CUDA `lstm2_bwd_kernel`) on the
    JAX forward's own residuals and the same dy, against the JAX package's
    v1 and v2 backward kernels in interpret mode: dg1 directly, dg2 through
    the two products the JAX backward forms from it (db2, dW2)."""
    ran = []
    for name in ("_bwd_kernel", "_bwd_kernel_v2"):
        kernel = getattr(jl, name)
        monkeypatch.setattr(jl, name, lambda *a, _k=kernel, _n=name: (ran.append(_n), _k(*a))[1])
    monkeypatch.setenv("CLD_LSTM_BWD_IMPL", impl)
    args = _core_inputs(6, B, T, H)
    dy = np.random.default_rng(7).normal(size=(B, T, H)).astype(np.float32)
    _, res = jl._core_fwd(*map(jnp.asarray, args), True)
    dg1_j, _, _, dW2_j, db2_j = jl._core_bwd(True, res, jnp.asarray(dy))
    assert ran == ["_bwd_kernel" if impl == "v1" else "_bwd_kernel_v2"]

    h1c1, yc2 = (torch.from_numpy(np.array(r)) for r in res[5:])
    h1s, c1s, y, c2s = h1c1[..., :H], h1c1[..., H:], yc2[..., :H], yc2[..., H:]
    targs = [torch.from_numpy(a) for a in args]
    dg1, dg2 = tl.lstm2_bwd_ref(torch.from_numpy(dy), *targs, h1s.contiguous(),
                                c1s.contiguous(), y.contiguous(), c2s.contiguous())
    np.testing.assert_allclose(dg1.numpy(), np.asarray(dg1_j), **VAL)
    np.testing.assert_allclose(dg2.sum(dim=(0, 1)).numpy(), np.asarray(db2_j), rtol=1e-5,
                               atol=1e-5)
    h2prev = torch.cat([targs[1][:, None], y[:, :-1]], dim=1)
    in2 = torch.cat([h1s, h2prev], dim=-1).reshape(B * T, 2 * H)
    np.testing.assert_allclose((in2.T @ dg2.reshape(B * T, 4 * H)).numpy(), np.asarray(dW2_j),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def vae_pair():
    m = LSTMVAE(hidden_size=16, latent_size=4)
    v = m.init({"params": jax.random.key(0)}, jnp.zeros((2, 9, 6)), jnp.zeros((2, 32)))
    sd = export_lstm_vae(jax.tree.map(np.asarray, v["params"]), root="")
    dec = LSTMDecoder(latent_size=4, hidden_size=16, cond_dim=32)
    dec.load_state_dict({k[len("lstm_dec."):]: torch.from_numpy(a)
                         for k, a in sd.items() if k.startswith("lstm_dec.")}, strict=True)
    return {"params": {"lstmvae": v["params"]}}, dec


def test_fused_decode_actions_matches_jax(vae_pair):
    variables, dec = vae_pair
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 9, 4)).astype(np.float32)
    cond = rng.normal(size=(3, 32)).astype(np.float32)
    ct = rng.normal(size=(3, 9, 2)).astype(np.float32)

    def loss(z, c):
        return jnp.sum(jl.fused_decode_actions(variables, z, c, impl="interpret") * ct)

    want = jl.fused_decode_actions(variables, jnp.asarray(z), jnp.asarray(cond), impl="ref")
    gz, gc = jax.grad(loss, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(cond))

    zt = torch.from_numpy(z).requires_grad_(True)
    ctt = torch.from_numpy(cond).requires_grad_(True)
    got = tl.fused_decode_actions(dec, zt, ctt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), **GRAD)
    np.testing.assert_allclose(ctt.grad.numpy(), np.asarray(gc), **GRAD)


def test_decoder_params_match_jax_extraction(vae_pair):
    variables, dec = vae_pair
    want = jl.extract_decoder_params(variables["params"]["lstmvae"]["lstm_dec"])
    got = tl.extract_decoder_params(dec)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


# ---------------------------------------------------------------------------
# the CUDA kernels' weight layout, grid and hidden sizes (host side)
# ---------------------------------------------------------------------------


def _packed_fwd_matvec(packed, part, h):
    """h [B, H] through part p of the forward layout, walked as the kernel
    does: lane l of unit k sums h[e] * W[e, g*H + k] over its elements, then
    the eight lanes' partial sums add up -> [B, 4H] in gate order."""
    H = h.shape[-1]
    rows = tl._lane_elems(H)  # [8, K]
    w = packed[part].reshape(H // tl.LANES, H, tl.LANES, 4)  # [m, k, l, g]
    partial = torch.einsum("blm,mklg->bklg", h[:, rows], w)
    return partial.sum(dim=2).permute(0, 2, 1).reshape(h.shape[0], 4 * H)


def _packed_bwd_matvec(packed, part, d):
    """d [B, 4H] through part p of the reverse sweep's layout: lane l of unit
    k sums d[j] * row_k[j] over its gate columns -> [B, H]."""
    H = d.shape[-1] // 4
    cols = tl._lane_elems(4 * H)  # [8, H/2]
    w = packed[part].reshape(H // tl.LANES, H, tl.LANES, 4).permute(1, 2, 0, 3)
    partial = torch.einsum("blj,klj->bkl", d[:, cols], w.reshape(H, tl.LANES, H // 2))
    return partial.sum(dim=2)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("H", [8, 16, 64])
def test_weight_packing_is_a_permutation(kind, H):
    idx = tl.weight_index(kind, H)
    assert idx.shape == (3, H // 8, 8 * H, 4)
    assert torch.equal(idx.reshape(-1).sort().values, torch.arange(12 * H * H))
    _, _, Wh1, W2, _ = map(torch.from_numpy, _core_inputs(8, 2, 3, H))
    back = tl.unpack_weights(kind, tl.pack_weights(kind, Wh1, W2), H)
    assert torch.equal(back[0], Wh1) and torch.equal(back[1], W2)


@pytest.mark.parametrize("H", [8, 16, 64])
def test_packed_layouts_give_the_jax_reference_gates(H):
    """A plain matvec in each packed layout, against h @ Wh1, [h1, h2] @ W2
    and their transposes, and one cell step from the packed products against
    the JAX package's `lstm2_core_ref` states."""
    B, T = 3, 4
    args = _core_inputs(9, B, T, H)
    y, h1s, c1s, c2s = (torch.from_numpy(np.array(a))
                        for a in jl.lstm2_core_ref(*map(jnp.asarray, args)))
    xg1, _, Wh1, W2, b2 = map(torch.from_numpy, args)
    fwd = tl.pack_weights("fwd", Wh1, W2)
    t = 2
    h1p, h1t, h2p = h1s[:, t - 1], h1s[:, t], y[:, t - 1]
    np.testing.assert_allclose(_packed_fwd_matvec(fwd, 0, h1p), h1p @ Wh1, **VAL)
    in2 = torch.cat([h1t, h2p], -1)
    pre2 = _packed_fwd_matvec(fwd, 1, h1t) + _packed_fwd_matvec(fwd, 2, h2p)
    np.testing.assert_allclose(pre2, in2 @ W2, **VAL)
    for pre, c_prev, h_want, c_want in (
            (xg1[:, t] + _packed_fwd_matvec(fwd, 0, h1p), c1s[:, t - 1], h1t, c1s[:, t]),
            (pre2 + b2, c2s[:, t - 1], y[:, t], c2s[:, t])):
        i, f, g, o = tl._gate_act(pre, H)
        c = f * c_prev + i * g
        np.testing.assert_allclose(c, c_want, **VAL)
        np.testing.assert_allclose(o * torch.tanh(c), h_want, **VAL)

    bwd = tl.pack_weights("bwd", Wh1, W2)
    d = torch.from_numpy(np.random.default_rng(10).normal(size=(B, 4 * H)).astype(np.float32))
    np.testing.assert_allclose(_packed_bwd_matvec(bwd, 0, d), d @ W2[:H].T, **VAL)
    np.testing.assert_allclose(_packed_bwd_matvec(bwd, 1, d), d @ W2[H:].T, **VAL)
    np.testing.assert_allclose(_packed_bwd_matvec(bwd, 2, d), d @ Wh1.T, **VAL)


@pytest.mark.parametrize("B", [1, 5, 130, 132, 133, 264, 265, 512])
def test_rows_per_cta_covers_every_row_once(B):
    sms = 132
    R = tl.rows_per_cta(B, sms)
    assert R in tl.ROWS_PER_CTA
    if B <= sms:
        assert R == 1
    grid = (B + R - 1) // R
    rows = torch.arange(grid)[:, None] * R + torch.arange(R)
    rows = rows[rows < B]
    assert torch.equal(rows, torch.arange(B))
    assert grid <= sms or R == max(tl.ROWS_PER_CTA)


@pytest.mark.parametrize("H", [8, 16, 24, 64, 0, 4, 12, 63, 72, 128, 320, 321])
def test_check_hidden_names_the_kernels_range(H):
    if 1 <= H <= 320:  # every H the JAX package's kernels run both sweeps at
        tl.check_hidden(H)
    else:
        with pytest.raises(ValueError, match=r"H in \[1, 320\]"):
            tl.check_hidden(H)
