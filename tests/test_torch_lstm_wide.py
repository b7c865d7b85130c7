"""The LSTM decoder core at every hidden size the JAX kernels take (H 1-320):
the port's padding and the host side of `cld_tpu_torch/csrc/lstm_wide.cu`,
against the JAX package's `lstm2_core` run by its Pallas kernels in
interpret mode.

* `lstm2_core` (the plain versions on the CPU) against JAX's interpret run
  at H = 50, 128 and 320: values, and the VJP in all five arguments; f32
  within rtol 1e-5 (atol 1e-5 of the output's largest entry: the two sides
  sum the gate products in another order); bf16 at H = 128 within 2^-8 of
  max |JAX| (one bf16 ulp of an element near the largest).
* `fused_decode_actions` of a hidden-128 decoder (weights through
  `utils/weights.py`) against JAX's `fused_decode_actions(impl="interpret")`.
* The padding (`pad_blocks` / `unpad_blocks`, `pad_hidden`): zero units stay
  exactly zero in every state and cotangent, and the sliced sweep equals the
  unpadded one.
* The wide kernels' weight layouts: permutations with exact inverses that
  give the JAX gate products, and a walk of both sweeps through them as the
  kernels run them (per CTA of the cluster, the wavefront of the two layers,
  the all-gather of h and the reduce-scatter of the chain's partial
  products), against the plain versions.
* The f32 forward's rows a cluster (`wide_rows`: the fewest waves), and a
  walk of it thread by thread as `lstm2_wide_fwd_f32_kernel<R>` indexes its work
  (column pairs x chunks of K, partial sums in chunk order, R / 8 rows a
  cell thread, the bytes each CTA's barrier is armed for against the bytes
  its peers send), at R = 8 and 16, against the plain version.

The JAX side runs as one jitted compile per case with its arrays passed as
arguments.
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

BF16 = torch.bfloat16
F32_RTOL = 1e-5
F32_ATOL = 1e-5  # of the compared array's largest entry
BF16_TOL = 2.0 ** -8  # of max |JAX|
NAMES = ("xg1", "h0", "Wh1", "W2", "b2")


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


@jax.jit
def _jax_core_vjp(xg1, h0, Wh1, W2, b2, ct):
    """JAX's fused core in interpret mode and its VJP against ct, one compile."""
    y, vjp = jax.vjp(lambda *a: jl.lstm2_core(*a, True), xg1, h0, Wh1, W2, b2)
    return y, vjp(ct)


def _port_core_vjp(args, ct):
    leaves = [torch.from_numpy(np.asarray(a)).requires_grad_(True) for a in args]
    y = tl.lstm2_core(*leaves)
    y.backward(torch.from_numpy(np.asarray(ct)))
    return y.detach(), [a.grad for a in leaves]


def _close_f32(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("H", [50, 128, 320])
def test_core_values_and_vjp_match_jax_interpret(H):
    B, T = 3, 5
    args = _core_inputs(H, B, T, H)
    ct = np.random.default_rng(H + 1).normal(size=(B, T, H)).astype(np.float32)
    y_j, g_j = _jax_core_vjp(*map(jnp.asarray, args), jnp.asarray(ct))
    y, grads = _port_core_vjp(args, ct)
    _close_f32(y.numpy(), y_j, "y")
    for name, g, w in zip(NAMES, grads, g_j):
        _close_f32(g.numpy(), w, f"d{name}")


def test_core_bf16_matches_jax_interpret_at_hidden_128():
    B, T, H = 3, 5, 128
    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in _core_inputs(7, B, T, H)]
    ct = jnp.asarray(np.random.default_rng(8).normal(size=(B, T, H)), jnp.bfloat16)
    y_j, g_j = _jax_core_vjp(*args, ct)
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16) for a in args]
    leaves = [a.clone().requires_grad_(True) for a in tb]
    y = tl.lstm2_core(*leaves)
    y.backward(torch.from_numpy(np.array(ct.astype(jnp.float32))).to(BF16))
    for name, got, want in zip(("y",) + tuple(f"d{n}" for n in NAMES),
                               (y.detach(), *(a.grad for a in leaves)), (y_j, *g_j)):
        assert got.dtype == BF16, name
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                                   atol=BF16_TOL * np.abs(w).max(), err_msg=name)


def test_fused_decode_actions_matches_jax_at_hidden_128():
    H, L, Cd = 128, 4, 32
    m = LSTMVAE(hidden_size=H, latent_size=L)
    # seeded weights in `init`'s layout, read off `jax.eval_shape` (an eager
    # init of the LSTM VAE takes seconds): U(-1/sqrt(H), 1/sqrt(H)) each
    shapes = jax.eval_shape(lambda: m.init({"params": jax.random.key(0)}, jnp.zeros((2, 5, 6)),
                                           jnp.zeros((2, Cd))))
    rng = np.random.default_rng(4)
    v = jax.tree.map(lambda s: rng.uniform(-H ** -0.5, H ** -0.5, s.shape).astype(np.float32),
                     dict(shapes))
    sd = export_lstm_vae(v["params"], root="")
    dec = LSTMDecoder(latent_size=L, hidden_size=H, cond_dim=Cd)
    dec.load_state_dict({k[len("lstm_dec."):]: torch.from_numpy(a)
                         for k, a in sd.items() if k.startswith("lstm_dec.")}, strict=True)
    variables = {"params": {"lstmvae": v["params"]}}
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 5, L)).astype(np.float32)
    cond = rng.normal(size=(3, Cd)).astype(np.float32)
    ct = rng.normal(size=(3, 5, 2)).astype(np.float32)

    @jax.jit
    def jax_side(z, c, ct):
        acts, vjp = jax.vjp(
            lambda z, c: jl.fused_decode_actions(variables, z, c, impl="interpret"), z, c)
        return acts, vjp(ct)

    want, (gz, gc) = jax_side(jnp.asarray(z), jnp.asarray(cond), jnp.asarray(ct))
    zt = torch.from_numpy(z).requires_grad_(True)
    ctt = torch.from_numpy(cond).requires_grad_(True)
    got = tl.fused_decode_actions(dec, zt, ctt)
    (got * torch.from_numpy(ct)).sum().backward()
    _close_f32(got.detach().numpy(), want, "actions")
    _close_f32(zt.grad.numpy(), gz, "dz")
    _close_f32(ctt.grad.numpy(), gc, "dcond")


# ---------------------------------------------------------------------------
# padding to the kernels' granularity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,Hp", [(1, 8), (5, 8), (50, 56), (64, 64), (72, 80), (128, 128),
                                  (200, 208), (320, 320)])
def test_padded_hidden_is_the_kernels_granularity(H, Hp):
    assert tl.padded_hidden(H) == Hp
    assert Hp % (tl.LANES if Hp <= 64 else tl.WIDE_GRAIN) == 0
    assert Hp in tl.H_RANGE or (Hp > 64 and Hp <= tl.MAX_HIDDEN)


@pytest.mark.parametrize("H", [5, 50, 72])
def test_padding_is_exact_in_every_state_and_cotangent(H):
    """The sweeps on inputs padded with zero units: the padded units are
    exactly 0 in y, h1s, c1s, c2s, dg1 and dg2, and the real units equal the
    unpadded sweeps' (within 1e-6 relative: the matmuls' summation order may
    change with K; a zero unit adds exact zeros)."""
    B, T = 3, 4
    Hp = tl.padded_hidden(H)
    args = dict(zip(NAMES, map(torch.from_numpy, _core_inputs(11, B, T, H))))
    dy = torch.from_numpy(np.random.default_rng(12).normal(size=(B, T, H)).astype(np.float32))
    pad = {k: tl.pad_hidden(k, a, H, Hp) for k, a in args.items()}
    outs = tl.lstm2_core_ref(*args.values())
    outs_p = tl.lstm2_core_ref(*pad.values())
    seqs = dict(zip(("ys", "h1s", "c1s", "c2s"), outs))
    seqs_p = dict(zip(("ys", "h1s", "c1s", "c2s"), outs_p))
    dg = tl.lstm2_bwd_ref(dy, *args.values(), seqs["h1s"], seqs["c1s"], seqs["ys"], seqs["c2s"])
    dg_p = tl.lstm2_bwd_ref(tl.pad_hidden("dy", dy, H, Hp), *pad.values(), seqs_p["h1s"],
                            seqs_p["c1s"], seqs_p["ys"], seqs_p["c2s"])
    for name, a, ap, blocks in (*zip(seqs, outs, outs_p, [1] * 4),
                                *zip(("dg1", "dg2"), dg, dg_p, [4] * 2)):
        pad_units = ap.reshape(B, T, blocks, Hp)[..., H:]
        assert torch.equal(pad_units, torch.zeros_like(pad_units)), name
        np.testing.assert_allclose(tl.unpad_blocks(ap, -1, blocks, H, Hp).numpy(), a.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", ["xg1", "h0", "Wh1", "W2", "b2", "dy"])
def test_unpad_inverts_pad_exactly(name):
    H, Hp = 50, 56
    shapes = dict(xg1=(2, 3, 4 * H), h0=(2, H), Wh1=(H, 4 * H), W2=(2 * H, 4 * H), b2=(4 * H,),
                  dy=(2, 3, H))
    a = torch.randn(shapes[name], generator=torch.Generator().manual_seed(3))
    p = tl.pad_hidden(name, a, H, Hp)
    back = p
    for dim, blocks in reversed(tl._PAD_LAYOUT[name]):
        back = tl.unpad_blocks(back, dim, blocks, H, Hp)
    assert torch.equal(back, a)
    assert p.numel() == a.numel() // H ** len(tl._PAD_LAYOUT[name]) * Hp ** len(
        tl._PAD_LAYOUT[name])
    assert float(p.abs().sum()) == pytest.approx(float(a.abs().sum()), rel=1e-6)


# ---------------------------------------------------------------------------
# the wide kernels' weight layouts and how the kernels walk them
# ---------------------------------------------------------------------------

WIDE = [(72, torch.float32), (128, torch.float32), (128, BF16), (320, torch.float32),
        (320, BF16)]


def _padded_weights(seed, H):
    Hp = tl.padded_hidden(H)
    _, _, Wh1, W2, _ = map(torch.from_numpy, _core_inputs(seed, 2, 2, H))
    return tl.pad_hidden("Wh1", Wh1, H, Hp), tl.pad_hidden("W2", W2, H, Hp), Hp


@pytest.mark.parametrize("H,dtype", WIDE)
def test_wide_layouts_are_permutations_with_exact_inverses(H, dtype):
    Wh1, W2, Hp = _padded_weights(13, H)
    Wh1, W2 = Wh1.to(dtype), W2.to(dtype)
    C = tl.wide_cluster(Hp, dtype)
    assert C in tl.WIDE_CLUSTERS and Hp % C == 0
    for kind in ("wide_fwd", "wide_chain", "wide_gates"):
        idx = tl.weight_index(kind, Hp, cluster=C)
        assert torch.equal(idx.reshape(-1).sort().values, torch.arange(12 * Hp * Hp)), kind
        back = tl.unpack_weights(kind, tl.pack_weights(kind, Wh1, W2), Hp)
        assert torch.equal(back[0], Wh1) and torch.equal(back[1], W2), kind


def _fwd_products(packed, q, C, X1, X2):
    """CTA q's forward products from the "wide_fwd" layout: rows = the
    inputs, columns v = part * 4U + g U + u -> (layer 1's pre [B, 4U], layer
    2's [B, 4U]), each column's gates in (g, u) order."""
    H = X1.shape[-1]
    U = H // C
    w = packed.reshape(C, H, 12 * U)[q].float()
    return X1 @ w[:, :4 * U], X1 @ w[:, 4 * U:8 * U] + X2 @ w[:, 8 * U:]


def _cta_columns(q, C, H):
    """The gate columns g H + q U + u of CTA q, in its (g, u) order."""
    U = H // C
    return (torch.arange(4)[:, None] * H + q * U + torch.arange(U)).reshape(-1)


@pytest.mark.parametrize("H,dtype", WIDE)
def test_wide_layouts_give_the_jax_gate_products(H, dtype):
    """Each CTA's products through "wide_fwd", the chain's partial products
    through "wide_chain" summed over the cluster, and the gates kernel's
    through "wide_gates", against h @ Wh1, [h1, h2] @ W2 and d @ W^T from
    the JAX package's states (operands at the storage type, f32 sums)."""
    B, T = 3, 4
    Hp = tl.padded_hidden(H)
    args = _core_inputs(14, B, T, H)
    y, h1s, _, _ = (torch.from_numpy(np.array(a)) for a in jl.lstm2_core_ref(*map(jnp.asarray,
                                                                                  args)))
    Wh1, W2, _ = _padded_weights(14, H)
    Wh1, W2 = Wh1.to(dtype), W2.to(dtype)
    C = tl.wide_cluster(Hp, dtype)
    rnd = lambda a: tl.pad_hidden("h0", a, H, Hp).to(dtype).float()
    t = 2
    h1p, h1t, h2p = rnd(h1s[:, t - 1]), rnd(h1s[:, t]), rnd(y[:, t - 1])
    want1 = h1p @ Wh1.float()
    want2 = torch.cat([h1t, h2p], -1) @ W2.float()
    fwd = tl.pack_weights("wide_fwd", Wh1, W2)
    for q in range(C):
        cols = _cta_columns(q, C, Hp)
        p1, _ = _fwd_products(fwd, q, C, h1p, h2p)
        _, p2 = _fwd_products(fwd, q, C, h1t, h2p)
        np.testing.assert_allclose(p1, want1[:, cols], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p2, want2[:, cols], rtol=1e-5, atol=1e-6)

    gates = tl.pack_weights("wide_gates", Wh1, W2).reshape(3, Hp, Hp, 4).float()
    g1 = torch.einsum("bk,kug->bgu", h1p, gates[0]).reshape(B, 4 * Hp)
    g2 = (torch.einsum("bk,kug->bgu", h1t, gates[1])
          + torch.einsum("bk,kug->bgu", h2p, gates[2])).reshape(B, 4 * Hp)
    np.testing.assert_allclose(g1, want1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g2, want2, rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(15)
    d2, d1 = (torch.from_numpy(rng.normal(size=(B, 4 * Hp)).astype(np.float32)).to(dtype).float()
              for _ in range(2))
    chain = tl.pack_weights("wide_chain", Wh1, W2)
    U = Hp // C
    w = chain.reshape(C, 4 * U, 3 * Hp).float()
    parts = torch.zeros(3, B, Hp)
    for q in range(C):  # each CTA's partials for every unit, summed at the owner
        cols = _cta_columns(q, C, Hp)
        parts[0] += d2[:, cols] @ w[q][:, :Hp]
        parts[1] += d2[:, cols] @ w[q][:, Hp:2 * Hp]
        parts[2] += d1[:, cols] @ w[q][:, 2 * Hp:]
    W2f, Wh1f = W2.float(), Wh1.float()
    np.testing.assert_allclose(parts[0], d2 @ W2f[Hp:].T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(parts[1], d2 @ W2f[:Hp].T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(parts[2], d1 @ Wh1f.T, rtol=1e-5, atol=1e-5)


def _walk_fwd(xg1, h0, Wh1, W2, b2):
    """The forward as `lstm2_wide_fwd_kernel` runs it: iteration s runs
    layer 1 at step s and layer 2 at step s - 1 from the h vectors the
    cluster gathered at iteration s - 1; CTA q runs its units' cells."""
    B, T, G = xg1.shape
    H = G // 4
    C = tl.wide_cluster(H, xg1.dtype)
    U = H // C
    dt = xg1.dtype
    fwd = tl.pack_weights("wide_fwd", Wh1, W2)
    hb = {(1, 0): h0.float(), (0, 1): h0.float()}  # (parity, layer) -> [B, H]
    c = torch.zeros(2, B, H)
    outs = torch.zeros(4, B, T, H)  # y, h1, c1, c2
    for s in range(T + 1):
        cur, prv = s & 1, (s & 1) ^ 1
        new = torch.zeros(2, B, H)
        for q in range(C):
            p1, p2 = _fwd_products(fwd, q, C, hb[(prv, 0)], hb.get((prv, 1), torch.zeros(B, H)))
            units = torch.arange(q * U, (q + 1) * U)
            cols = _cta_columns(q, C, H)
            for layer, on, pre in ((0, s < T, p1), (1, s > 0, p2)):
                if not on:
                    continue
                step = s if layer == 0 else s - 1
                add = xg1[:, step, cols].float() if layer == 0 else b2[cols].float()
                i, f, g, o = (pre + add).reshape(B, 4, U).unbind(1)
                i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
                cc = f * c[layer][:, units] + i * g
                c[layer][:, units] = cc
                h = o * torch.tanh(cc)
                new[layer][:, units] = h.to(dt).float()
                outs[1 if layer == 0 else 0, :, step, q * U:(q + 1) * U] = h
                outs[2 if layer == 0 else 3, :, step, q * U:(q + 1) * U] = cc
        if s < T:
            hb[(cur, 0)] = new[0]
        if s > 0:
            hb[(cur, 1)] = new[1]
    return tuple(o.to(dt) for o in outs)


def _walk_bwd(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """The reverse sweep as `lstm2_wide_gates_kernel` + `lstm2_wide_chain_kernel`
    run it: the 12 coefficient planes from the "wide_gates" products, then
    iteration s: layer 2 at step T-1-s and layer 1 at step T-s, each CTA's
    partial products of its own units' dg for every unit, summed at the
    owner in rank order."""
    B, T, G = xg1.shape
    H = G // 4
    dt = xg1.dtype
    C = tl.wide_cluster(H, dt)
    U = H // C
    f = lambda a: a.float()
    gates, chain = tl.pack_layouts(Wh1, W2, "wide_gates", "wide_chain")
    gw = f(gates).reshape(3, H, H, 4)
    h1p = torch.cat([f(h0)[:, None], f(h1s)[:, :-1]], 1)
    h2p = torch.cat([f(h0)[:, None], f(ys)[:, :-1]], 1)
    pre1 = torch.einsum("btk,kug->btgu", h1p, gw[0]).reshape(B, T, G) + f(xg1)
    pre2 = (torch.einsum("btk,kug->btgu", f(h1s), gw[1])
            + torch.einsum("btk,kug->btgu", h2p, gw[2])).reshape(B, T, G) + f(b2)
    coef = []
    for pre, cs in ((pre2, f(c2s)), (pre1, f(c1s))):
        i, fg, g, o = torch.sigmoid(pre[..., :H]), torch.sigmoid(pre[..., H:2 * H]), \
            torch.tanh(pre[..., 2 * H:3 * H]), torch.sigmoid(pre[..., 3 * H:])
        cp = torch.cat([torch.zeros(B, 1, H), cs[:, :-1]], 1)
        tc = torch.tanh(cs)
        coef += [o * (1 - tc * tc), fg, g * i * (1 - i), cp * fg * (1 - fg), i * (1 - g * g),
                 tc * o * (1 - o)]
    w = f(chain).reshape(C, 4 * U, 3 * H)
    own = torch.zeros(C, 2, B, 4 * U)  # each CTA's dg2, dg1 in its (g, u) order
    carry = torch.zeros(2, B, H)
    dg = torch.zeros(2, B, T, G)  # dg2, dg1
    for s in range(T + 1):
        parts = torch.zeros(3, C, B, H)  # [group, source CTA]
        for q in range(C):
            parts[0, q] = own[q, 0] @ w[q][:, :H]
            parts[1, q] = own[q, 0] @ w[q][:, H:2 * H]
            parts[2, q] = own[q, 1] @ w[q][:, 2 * H:]
        for q in range(C):
            units = torch.arange(q * U, (q + 1) * U)
            cols = _cta_columns(q, C, H)
            for layer, on in ((0, s < T), (1, s > 0)):
                if not on:
                    continue
                t = T - 1 - s if layer == 0 else T - s
                if layer == 0:
                    dh = f(dy)[:, t, units] + parts[0, :, :, units].sum(0)
                else:
                    dh = parts[1, :, :, units].sum(0) + parts[2, :, :, units].sum(0)
                k = [coef[6 * layer + j][:, t, units] for j in range(6)]
                dc = dh * k[0] + carry[layer][:, units]
                carry[layer][:, units] = dc * k[1]
                d = torch.cat([dc * k[2], dc * k[3], dc * k[4], dh * k[5]], -1)
                own[q, layer] = d.to(dt).float()
                dg[layer][:, t, cols] = d
    return dg[1].to(dt), dg[0].to(dt)


@pytest.mark.parametrize("H,dtype", [(80, torch.float32), (320, torch.float32), (128, BF16)])
def test_walk_of_the_wide_sweeps_matches_the_plain_versions(H, dtype):
    B, T = 3, 4
    args = [torch.from_numpy(a).to(dtype) for a in _core_inputs(16, B, T, H)]
    dy = torch.from_numpy(np.random.default_rng(17).normal(size=(B, T, H)).astype(np.float32))
    dy = dy.to(dtype)
    want = tl.lstm2_core_ref(*args)
    got = _walk_fwd(*args)
    tol = (lambda w: dict(rtol=0, atol=2.0 ** -7 * float(w.abs().max()))) if dtype == BF16 else (
        lambda w: dict(rtol=1e-5, atol=1e-6))
    for name, g, w in zip(("y", "h1s", "c1s", "c2s"), got, want):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol(w.float()),
                                   err_msg=name)
    y, h1s, c1s, c2s = want
    want_dg = tl.lstm2_bwd_ref(dy, *args, h1s, c1s, y, c2s)
    got_dg = _walk_bwd(dy, *args, h1s, c1s, y, c2s)
    for name, g, w in zip(("dg1", "dg2"), got_dg, want_dg):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol(w.float()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the redesigned f32 forward: its rows a cluster, its schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,clusters,want", [
    (32, {8: 15, 16: 15}, 8), (120, {8: 15, 16: 15}, 8), (128, {8: 15, 16: 15}, 16),
    (512, {8: 15, 16: 15}, 8), (32, {8: 7, 16: 7}, 8), (128, {8: 7, 16: 7}, 8),
    (512, {8: 7, 16: 7}, 16), (128, {8: 15}, 8), (128, {8: 15, 16: 0}, 8),
    (1, {8: 15, 16: 15}, 8)])
def test_wide_rows_takes_the_least_waves_times_step_cost(B, clusters, want):
    """Rows a cluster: the least waves of row tiles (over the clusters the
    card holds at once: an H100 holds 15 clusters of 8 at H = 128, 7 of 16
    at 320) times a 16-row step's 1.8x cost, the fewer rows on a tie: B =
    128 at H = 128 is 8 tiles of 16, one wave, where 16 tiles of 8 took two;
    at H = 320 three waves of 8 rows beat two of 16, ten lose to five."""
    assert tl.wide_rows(B, clusters) == want


def test_wide_rows_refuses_a_card_that_holds_no_cluster():
    with pytest.raises(RuntimeError, match="cannot hold one cluster"):
        tl.wide_rows(32, {8: 0, 16: 0})


def _walk_fwd_f32(xg1, h0, Wh1, W2, b2, R, S):
    """The f32 forward as `lstm2_wide_fwd_f32_kernel<R>` indexes it at S
    chunks of K (`wide_f32_config`'s choice in csrc/lstm_wide.cu): for each
    tile of R rows and CTA q, thread t's column pair t % 6U and chunk t / 6U
    of K write partial sums red[chunk][row][column]; cell thread t < 16 U
    (unit t % U, rows (t / U % 8) R / 8 .., layer t / 8U) sums them in chunk
    order and sends its h into every CTA's buffer of the step's parity,
    whose barrier must have been armed for exactly the bytes that arrive."""
    B, T, G = xg1.shape
    H = G // 4
    C = tl.wide_cluster(H, torch.float32)
    U, NV, NP, RC = H // C, 12 * H // C, 6 * H // C, R // 8
    KC = H // S
    assert H % S == 0 and 16 * U <= 6 * U * S  # S chunks K evenly; a cell thread each
    w = tl.pack_weights("wide_fwd", Wh1, W2).reshape(C, H, NV)
    t = torch.arange(6 * U * S)
    pairs = set(zip((t % NP).tolist(), (t // NP).tolist()))
    assert pairs == {(v, ch) for v in range(NP) for ch in range(S)}  # each product once
    assert all((2 * v) // (4 * U) == (2 * v + 1) // (4 * U) for v in range(NP))  # one part a pair
    cells = torch.arange(16 * U)
    cu, cr0, ccl = cells % U, (cells // U) % 8 * RC, cells // (8 * U)
    assert len(set(zip(ccl.tolist(), cu.tolist(), cr0.tolist()))) == 16 * U  # each cell once
    outs = torch.zeros(4, B, T, H)  # y, h1, c1, c2
    step_bytes = H * R * 4
    for b0 in range(0, B, R):
        rows = torch.arange(b0, b0 + R)
        live = rows < B
        init = torch.where(live[None], h0[rows.clamp(max=B - 1)].T, 0.0)  # [H, R]
        hb = torch.zeros(C, 2, 2, H, R)  # per CTA: [parity][layer][unit][row]
        hb[:, 1, 0] = init
        hb[:, 0, 1] = init
        c = torch.zeros(C, 2, U, R)
        armed = {0: step_bytes, 1: 2 * step_bytes}  # the phases armed before the loop
        for s in range(T + 1):
            cur, prv = s & 1, (s & 1) ^ 1
            on1, on2 = s < T, s > 0
            arrived = torch.zeros(C, dtype=torch.long)
            sends = []
            for q in range(C):
                red = torch.zeros(S, R, NV)
                for ch in range(S):
                    ks = slice(ch * KC, (ch + 1) * KC)
                    for part, on in ((0, on1), (1, on2), (2, on2)):
                        if on:
                            cols = slice(part * 4 * U, (part + 1) * 4 * U)
                            red[ch, :, cols] = hb[q, prv, int(part == 2), ks].T @ w[q, ks, cols]
                for cl, on in ((0, on1), (1, on2)):
                    if not on:
                        continue
                    step = s if cl == 0 else s - 1
                    pre = torch.zeros(4, R, U)
                    for g in range(4):
                        col = cl * 4 * U + g * U + torch.arange(U)
                        for ch in range(S):  # chunk order, as the cell threads sum
                            pre[g] += red[ch][:, col]
                        if cl == 1:
                            for ch in range(S):
                                pre[g] += red[ch][:, col + 4 * U]
                        unit = g * H + q * U + torch.arange(U)
                        pre[g] += (torch.where(live[:, None], xg1[rows.clamp(max=B - 1), step][:,
                                   unit], 0.0) if cl == 0 else b2[unit])
                    i, f, gg, o = (torch.sigmoid(pre[0]), torch.sigmoid(pre[1]),
                                   torch.tanh(pre[2]), torch.sigmoid(pre[3]))
                    cc = f * c[q, cl].T + i * gg  # [R, U]
                    c[q, cl] = cc.T
                    h = o * torch.tanh(cc)
                    if s < T:
                        sends.append((cl, q, h))
                        arrived += len(cells) // 2 * RC * 4  # one layer's cell threads, each CTA
                    units = slice(q * U, (q + 1) * U)
                    outs[1 if cl == 0 else 0, rows[live], step, units] = h[live]
                    outs[2 if cl == 0 else 3, rows[live], step, units] = cc[live]
            for cl, q, h in sends:  # DSMEM bulk copies into every CTA's buffer `cur`
                hb[:, cur, cl, q * U:(q + 1) * U] = h.T
            if s < T:  # each CTA's barrier `cur` completes on exactly its armed bytes
                assert arrived.tolist() == [armed.pop(s)] * C
                if s + 2 < T:
                    armed[s + 2] = 2 * step_bytes
        assert not armed
    return outs[0], outs[1], outs[2], outs[3]


# (H, R, S): the chunks of K that `wide_f32_config` plans there (8 while 6 U
# 8 threads fit the kernel's 512, else 4)
@pytest.mark.parametrize("H,R,S", [(80, 8, 8), (80, 16, 8), (128, 8, 4), (128, 16, 4),
                                   (240, 8, 4), (320, 8, 4), (320, 16, 4)])
def test_walk_of_the_f32_wide_forward_matches_the_plain_version(H, R, S):
    B, T = 19, 4  # a ragged last tile of rows at R = 8 and 16
    args = [torch.from_numpy(a) for a in _core_inputs(18, B, T, H)]
    Hp = tl.padded_hidden(H)
    padded = [tl.pad_hidden(n, a, H, Hp) for n, a in zip(NAMES, args)]
    got = _walk_fwd_f32(*padded, R, S)
    want = tl.lstm2_core_ref(*padded)
    for name, g, w in zip(("y", "h1s", "c1s", "c2s"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
