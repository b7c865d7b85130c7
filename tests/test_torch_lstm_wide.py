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
    """The forward's layout and the reverse sweep's two of the storage type
    ("wide_gates" / "wide_chain" in f32, "wide_gates_bf16" /
    "wide_chain_bf16" in bf16): every weight once, the rest the zero that
    pads the bf16 chain's k-tiles past 4 H / C, and an exact inverse."""
    Wh1, W2, Hp = _padded_weights(13, H)
    Wh1, W2 = Wh1.to(dtype), W2.to(dtype)
    C = tl.wide_cluster(Hp, dtype)
    assert C in tl.WIDE_CLUSTERS and Hp % C == 0
    for kind in ("wide_fwd", *tl.WIDE_BWD_KINDS[dtype]):
        idx = tl.weight_index(kind, Hp, cluster=C).reshape(-1)
        real = idx[idx < 12 * Hp * Hp]
        assert torch.equal(real.sort().values, torch.arange(12 * Hp * Hp)), kind
        assert bool((idx[idx >= 12 * Hp * Hp] == 12 * Hp * Hp).all()), kind
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


def _gates_dense(packed, H, dtype):
    """cat(Wh1, W2) [3H, 4H] read back through a gates layout ([H / 16, 3H,
    64], column g 16 + m of unit tile ut: gate g of unit 16 ut +
    `gates_tile_units`[m]), as float."""
    p = packed.float().reshape(H // 16, 3 * H, 64)
    col = (torch.arange(64) // 16) * H + tl.gates_tile_units(dtype == BF16)
    out = torch.zeros(3 * H, 4 * H)
    for ut in range(H // 16):
        out[:, col + 16 * ut] = p[ut]
    return out


def _chain_dense(packed, H, C, dtype):
    """Each CTA's chain weights [C, 3, H, 4U] (group grp, unit i, the CTA's
    gate column g U + u), as float, from "wide_chain" ([C, 4U, 3H]) or from
    the mma A fragments of "wide_chain_bf16"."""
    U = H // C
    if dtype != BF16:
        return packed.float().reshape(C, 4 * U, 3, H).permute(0, 2, 3, 1)
    KT = tl.chain_k_tiles(H, C)
    frag = packed.float().reshape(C, H // 16, 3, KT, 4, 32, 2)
    m, kk = torch.broadcast_tensors(*tl.mma_a_fragment())
    dense = torch.zeros(C, H // 16, 3, 16, 16 * KT)
    for kt in range(KT):
        dense[:, :, :, m.reshape(-1), (16 * kt + kk).reshape(-1)] = frag[:, :, :, kt].reshape(
            C, H // 16, 3, -1)
    return dense.permute(0, 2, 1, 3, 4).reshape(C, 3, H, 16 * KT)[..., :4 * U]


@pytest.mark.parametrize("H,dtype", WIDE)
def test_wide_layouts_give_the_jax_gate_products(H, dtype):
    """Each CTA's products through "wide_fwd", the gates GEMM's through its
    tiles ("wide_gates" / "wide_gates_bf16") and the chain's partial products
    through "wide_chain" / "wide_chain_bf16" summed over the cluster,
    against h @ Wh1, [h1, h2] @ W2 and d @ W^T from the JAX package's states
    (operands at the storage type, f32 sums)."""
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

    gates_kind, chain_kind = tl.WIDE_BWD_KINDS[dtype]
    cat = _gates_dense(tl.pack_weights(gates_kind, Wh1, W2), Hp, dtype)
    np.testing.assert_allclose(h1p @ cat[:Hp], want1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([h1t, h2p], -1) @ cat[Hp:], want2, rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(15)
    d2, d1 = (torch.from_numpy(rng.normal(size=(B, 4 * Hp)).astype(np.float32)).to(dtype).float()
              for _ in range(2))
    w = _chain_dense(tl.pack_weights(chain_kind, Wh1, W2), Hp, C, dtype)
    parts = torch.zeros(3, B, Hp)
    for q in range(C):  # each CTA's partials for every unit, summed at the owner
        cols = _cta_columns(q, C, Hp)
        parts[0] += d2[:, cols] @ w[q, 0].T
        parts[1] += d2[:, cols] @ w[q, 1].T
        parts[2] += d1[:, cols] @ w[q, 2].T
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


GATES_PAIRS = 128  # (b, t) pairs of a gates CTA (`kGPairs`)


def _walk_gates(xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """coef [B, T, 12, H] as the gates GEMM computes it
    (`lstm2_wide_gates_f32_kernel`, in bf16 `lstm2_wide_gates_mma_kernel`):
    a CTA per (128 pairs, 16 units, layer), K summed one row at a time in
    the kernels' order (chunks of 16 / 32 rows of "wide_gates", in order),
    the pairs past B T zero; each thread or lane holds every gate of 4
    consecutive units (one 16-byte store a plane), and every (pair, unit,
    gate) of each layer is some thread's exactly once."""
    B, T, G = xg1.shape
    H, N, dt = G // 4, B * T, xg1.dtype
    bf16 = dt == BF16
    f = lambda a: a.float().reshape(N, -1)
    kind = tl.WIDE_BWD_KINDS[dt][0]
    w = tl.pack_weights(kind, Wh1, W2).float().reshape(H // 16, 3 * H, 64)
    unit = tl.gates_tile_units(bf16)
    first = (torch.arange(N) % T == 0)[:, None]
    prev = lambda a: torch.where(first, h0.float().repeat_interleave(T, 0), f(a).roll(1, 0))
    x = torch.cat([prev(h1s), f(h1s), prev(ys)], -1)  # the operand of each K row
    # who holds what: f32 thread (ug, pg): pairs pg + 32 i, columns g 16 + 4 ug
    # + e; bf16 warp w, lane (gq, tq): pairs 32 w + 16 mt + gq + 8 h, columns
    # g 16 + 8 ub + 2 tq + e of the C fragments
    if bf16:
        w_, mt, h, g, ub, gq, tq, e = torch.meshgrid(*map(torch.arange, (4, 2, 2, 4, 2, 8, 4, 2)),
                                                     indexing="ij")
        pair, col, lane = 32 * w_ + 16 * mt + gq + 8 * h, 16 * g + 8 * ub + 2 * tq + e, tq
    else:
        ug, pg, i, g, e = torch.meshgrid(*map(torch.arange, (4, 32, 4, 4, 4)), indexing="ij")
        pair, col, lane = pg + 32 * i, 16 * g + 4 * ug + e, ug
    seen = torch.zeros(GATES_PAIRS, 64, dtype=torch.long)
    seen.index_put_((pair.reshape(-1), col.reshape(-1)), torch.ones(pair.numel(), dtype=torch.long),
                    accumulate=True)
    assert bool((seen == 1).all())
    units_held = unit[col] - 4 * lane  # each holder's units: 4 lane .. 4 lane + 3
    assert int(units_held.min()) == 0 and int(units_held.max()) == 3
    kc = 32 if bf16 else 16
    coef = torch.zeros(N, 12, H)
    for n0 in range(0, N, GATES_PAIRS):
        rows = torch.arange(n0, n0 + GATES_PAIRS)
        live = rows < N
        xt = torch.where(live[:, None], x[rows.clamp(max=N - 1)], 0.0)
        for cl, (k0, k1) in enumerate(((H, 3 * H), (0, H))):  # layer 2 (planes 0-5), layer 1
            acc = torch.zeros(H // 16, GATES_PAIRS, 64)
            for c0 in range(k0, k1, kc):  # the chunks in order, their rows in order
                for k in range(c0, min(c0 + kc, k1)):
                    acc += xt[None, :, k, None] * w[:, None, k, :]
            for ut in range(H // 16):
                gcol = (torch.arange(64) // 16) * H + 16 * ut + unit
                pre = acc[ut][live] + (f(xg1)[:, gcol][rows[live]] if cl else b2.float()[gcol])
                i, fg, g_, o = (pre[:, 16 * j:16 * j + 16] for j in range(4))
                i, fg, g_, o = torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(g_), torch.sigmoid(o)
                units = 16 * ut + unit[:16]
                cs = f(c1s if cl else c2s)
                cv = cs[rows[live]][:, units]
                cp = torch.where(first[rows[live]], 0.0, cs.roll(1, 0)[rows[live]][:, units])
                tc = torch.tanh(cv)
                planes = (o * (1 - tc * tc), fg, g_ * i * (1 - i), cp * fg * (1 - fg),
                          i * (1 - g_ * g_), tc * o * (1 - o))
                for j, v in enumerate(planes):
                    coef[rows[live][:, None], 6 * cl + j, units[None, :]] = v
    return coef.reshape(B, T, 12, H)


def _plain_coef(xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """The 12 planes from the plain gate products (operands at the storage
    type, f32 sums), for the gates walk to match."""
    B, T, G = xg1.shape
    H = G // 4
    f = lambda a: a.float()
    h1p = torch.cat([f(h0)[:, None], f(h1s)[:, :-1]], 1)
    h2p = torch.cat([f(h0)[:, None], f(ys)[:, :-1]], 1)
    pre1 = h1p @ f(Wh1) + f(xg1)
    pre2 = torch.cat([f(h1s), h2p], -1) @ f(W2) + f(b2)
    out = []
    for pre, cs in ((pre2, f(c2s)), (pre1, f(c1s))):
        i, fg, g, o = (pre[..., j * H:(j + 1) * H] for j in range(4))
        i, fg, g, o = torch.sigmoid(i), torch.sigmoid(fg), torch.tanh(g), torch.sigmoid(o)
        cp = torch.cat([torch.zeros(B, 1, H), cs[:, :-1]], 1)
        tc = torch.tanh(cs)
        out += [o * (1 - tc * tc), fg, g * i * (1 - i), cp * fg * (1 - fg), i * (1 - g * g),
                tc * o * (1 - o)]
    return torch.stack(out, 2)


def _walk_chain(dy, coef, Wh1, W2, R, S=1):
    """dg1, dg2 as `lstm2_wide_chain_kernel<T, R>` computes them from coef:
    per tile of R rows, iteration s runs layer 2 at step T-1-s and layer 1
    at T-s; from s = 1 each CTA forms its partial products of the dg of s -
    1 for every unit (f32: column pairs x S chunks of K, summed in chunk
    order; bf16: warp w's units 16 w .., from the mma A fragments), stages
    them [owner][grp][R][U] and sends each owner its block into the owner's
    receive buffer [parity][source][grp][R][U], one bulk copy a peer, whose
    bytes must be exactly those the owner's barrier of that parity was armed
    with; each owner sums the C blocks in rank order and runs its cells (16
    U threads, R / 8 rows each)."""
    B, T, H = dy.shape
    dt = dy.dtype
    C = tl.wide_cluster(H, dt)
    U, K, RC = H // C, 4 * H // C, R // 8
    w = _chain_dense(tl.pack_weights(tl.WIDE_BWD_KINDS[dt][1], Wh1, W2), H, C, dt)  # [C,3,H,K]
    if dt != BF16:  # column pairs x chunks: each (pair, chunk) once, both columns in one group
        npw = -(-3 * H // 2 // 32) * 32
        t_ = torch.arange(npw * S)
        held = {(int(p), int(c)) for p, c in zip(t_ % npw, t_ // npw) if p < 3 * H // 2}
        assert held == {(p, c) for p in range(3 * H // 2) for c in range(S)}
        assert all((2 * p) // H == (2 * p + 1) // H for p in range(3 * H // 2))
        assert K % S == 0
    else:  # warp w's C fragments: units 16 w + gq (+ 8), rows 8 nt + 2 tq (+ 1), each once
        wp, h, gq, nt, tq, e = torch.meshgrid(*map(torch.arange, (H // 16, 2, 8, R // 8, 4, 2)),
                                              indexing="ij")
        cover = torch.zeros(H, R, dtype=torch.long)
        cover.index_put_(((16 * wp + gq + 8 * h).reshape(-1), (8 * nt + 2 * tq + e).reshape(-1)),
                         torch.ones(wp.numel(), dtype=torch.long), accumulate=True)
        assert bool((cover == 1).all())
    cells = torch.arange(16 * U)  # (layer, unit, first row): each cell of the CTA once
    cell_set = {(int(c // (8 * U)), int(c % U), int((c // U) % 8 * RC + j))
                for c in cells for j in range(RC)}
    assert cell_set == {(l, u, r) for l in range(2) for u in range(U) for r in range(R)}
    step_bytes = 12 * H * R
    kc = K // S
    dg = torch.zeros(2, B, T, 4 * H)  # dg2, dg1
    for b0 in range(0, B, R):
        rows = torch.arange(b0, b0 + R)
        live = rows < B
        rc = rows.clamp(max=B - 1)
        own = torch.zeros(C, 2, R, K)  # each CTA's dg2, dg1 at the storage type, (g, u) order
        carry = torch.zeros(C, 2, R, U)
        recv = torch.zeros(C, 2, C, 3, R, U)  # [owner][parity][source][grp][R][U]
        armed = {s: step_bytes for s in (1, 2) if s <= T}
        for s in range(T + 1):
            par = s & 1
            if s > 0:
                arrived = torch.zeros(C, dtype=torch.long)
                for q in range(C):
                    part = torch.zeros(3, R, H)
                    for grp in range(3):
                        x = own[q, 0 if grp < 2 else 1]
                        if dt == BF16:
                            part[grp] = x @ w[q, grp].T
                        else:
                            for ch in range(S):  # chunk order
                                ks = slice(ch * kc, (ch + 1) * kc)
                                part[grp] += x[:, ks] @ w[q, grp][:, ks].T
                    stage = part.reshape(3, R, C, U).permute(2, 0, 1, 3)  # [owner][grp][R][U]
                    for o in range(C):  # the bulk copy to owner o, onto its barrier `par`
                        recv[o, par, q] = stage[o]
                        arrived[o] += stage[o].numel() * 4
                assert arrived.tolist() == [armed.pop(s)] * C
                if s + 2 <= T:
                    armed[s + 2] = step_bytes
            for q in range(C):
                units = q * U + torch.arange(U)
                for cl, on in ((0, s < T), (1, s > 0)):
                    if not on:
                        continue
                    t = T - 1 - s if cl == 0 else T - s
                    k = [torch.where(live[:, None], coef[rc, t, 6 * cl + j][:, units].float(), 0.0)
                         for j in range(6)]
                    if cl == 0:
                        acc = torch.zeros(R, U)
                        if s > 0:
                            for p in range(C):  # rank order
                                acc = acc + recv[q, par, p, 0]
                        dh = torch.where(live[:, None], dy[rc, t][:, units].float(), 0.0) + acc
                    else:
                        a, e_ = torch.zeros(R, U), torch.zeros(R, U)
                        for p in range(C):
                            a = a + recv[q, par, p, 1]
                        for p in range(C):
                            e_ = e_ + recv[q, par, p, 2]
                        dh = a + e_
                    dc = dh * k[0] + carry[q, cl]
                    carry[q, cl] = dc * k[1]
                    d = torch.cat([dc * k[2], dc * k[3], dc * k[4], dh * k[5]], -1)  # [R, 4U]
                    own[q, cl] = d.to(dt).float()
                    cols = _cta_columns(q, C, H)
                    dg[cl][rows[live][:, None], t, cols[None, :]] = d[live]
        assert not armed
    return dg[1].to(dt), dg[0].to(dt)


# the chunks of K that `wide_chain_config` (csrc/lstm_wide.cu) plans for the f32
# chain at R = 8: the most with which the slice and the chunk sums fit
CHAIN_F32_CHUNKS = {80: 4, 128: 2, 320: 1}


def _walk_bwd(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s):
    """The reverse sweep as the gates GEMM + the chain run it (`_walk_gates`,
    then `_walk_chain` at 8 rows a cluster)."""
    coef = _walk_gates(xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)
    H = dy.shape[-1]
    return _walk_chain(dy, coef, Wh1, W2, 8, CHAIN_F32_CHUNKS[H] if dy.dtype != BF16 else 1)


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


# ---------------------------------------------------------------------------
# the redesigned reverse sweep: the gates GEMM's tiling, the chain's schedule,
# its rows a cluster
# ---------------------------------------------------------------------------


def _bwd_inputs(seed, B, T, H, dtype):
    """Padded sweep inputs in the storage type, the plain forward's states
    and a cotangent: (dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)."""
    Hp = tl.padded_hidden(H)
    args = [tl.pad_hidden(n, torch.from_numpy(a), H, Hp).to(dtype)
            for n, a in zip(NAMES, _core_inputs(seed, B, T, H))]
    dy = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=(B, T, H)).astype(np.float32))
    y, h1s, c1s, c2s = tl.lstm2_core_ref(*args)
    return (tl.pad_hidden("dy", dy, H, Hp).to(dtype), *args, h1s, c1s, y, c2s)


@pytest.mark.parametrize("H,dtype", [(80, torch.float32), (320, torch.float32), (128, BF16)])
def test_walk_of_the_wide_gates_gemm_matches_the_plain_coefficients(H, dtype):
    """The gates GEMM's tiling (`_walk_gates`: each (pair, unit, gate) held
    once, four consecutive units a thread or lane, K in the kernels' order)
    at B T = 130 pairs: two tiles of 128, the second holding 2, against the
    12 planes from the plain gate products (rtol 1e-5: other sum orders)."""
    ins = _bwd_inputs(21, 26, 5, H, dtype)
    got = _walk_gates(*ins[1:])
    want = _plain_coef(*ins[1:])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("H,R,S,dtype", [
    (80, 8, 4, torch.float32), (80, 16, 4, torch.float32), (128, 8, 2, torch.float32),
    (128, 16, 1, torch.float32), (320, 8, 1, torch.float32), (80, 8, 1, BF16),
    (128, 8, 1, BF16), (128, 16, 1, BF16), (320, 8, 1, BF16)])
def test_walk_of_the_wide_chain_matches_the_plain_version(H, R, S, dtype):
    """The chain as `lstm2_wide_chain_kernel<T, R>` schedules it
    (`_walk_chain`: the bulk copies into [parity][source][grp][R][U], the
    bytes each barrier is armed for against those its peers send, the owner's
    rank-order sums), at R = 8 and 16 with the chunks of K the f32 plan
    makes there, on a ragged last tile of rows (B = 19), against
    `lstm2_bwd_ref`: f32 within rtol 1e-5, bf16 within 2^-7 of max |plain|."""
    dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s = _bwd_inputs(22, 19, 4, H, dtype)
    coef = _plain_coef(xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)
    got = _walk_chain(dy, coef, Wh1, W2, R, S)
    want = tl.lstm2_bwd_ref(dy, xg1, h0, Wh1, W2, b2, h1s, c1s, ys, c2s)
    for name, g, w in zip(("dg1", "dg2"), got, want):
        w = w.float()
        tol = (dict(rtol=0, atol=2.0 ** -7 * float(w.abs().max())) if dtype == BF16
               else dict(rtol=1e-5, atol=1e-6))
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), **tol, err_msg=name)


@pytest.mark.parametrize("dtype,B,clusters,want", [
    (torch.float32, 32, {8: 15, 16: 14}, 8), (torch.float32, 128, {8: 15, 16: 14}, 16),
    (torch.float32, 512, {8: 15, 16: 14}, 8), (torch.float32, 128, {8: 7}, 8),
    (BF16, 32, {8: 15, 16: 15}, 8), (BF16, 128, {8: 15, 16: 15}, 16),
    (BF16, 512, {8: 15, 16: 15}, 16), (BF16, 128, {8: 7}, 8)])
def test_wide_chain_rows_take_the_least_waves_times_step_cost(dtype, B, clusters, want):
    """The chain's rows a cluster: `wide_rows` over its own `CHAIN_ROW_COST`
    (a 16-row step's cost relative to 8 rows', per storage type); at H = 320
    only R = 8 has a plan ({8: n}); a card without room for one cluster is
    refused by the chain's name."""
    assert tl.wide_rows(B, clusters, tl.CHAIN_ROW_COST[dtype], "lstm2_wide_chain_kernel") == want
    with pytest.raises(RuntimeError, match="lstm2_wide_chain_kernel"):
        tl.wide_rows(B, {8: 0}, tl.CHAIN_ROW_COST[dtype], "lstm2_wide_chain_kernel")
