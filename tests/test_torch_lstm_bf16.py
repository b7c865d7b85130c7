"""The host side of the bf16 LSTM kernels (`cld_tpu_torch/csrc/lstm_bf16.cu`):
their weight layouts, K and M padding and batch tiling, against the JAX
package's bf16 products.

The kernels run the recurrent products on `mma.m16n8k16` with the weights
as A fragments packed by `pack_weights("fwd_bf16" | "bwd_bf16")`. Here a
plain product walks each packed tile as the tensor cores read it (the A and
C fragment layouts of PTX's m16n8k16, written out below independently of
the package) and as the kernels map lanes to gates and units, and meets the
JAX package's `mm(a, w) = dot(a.astype(bf16), w, preferred_element_type=
f32)` (`cld_tpu/ops/lstm_pallas.py:184`): the operand rounded to bf16,
products exact, sums in f32. Tolerance rtol 1e-5 / atol 1e-6 (f32, other
summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu_torch.ops import lstm_kernels as tl

VAL = dict(rtol=1e-5, atol=1e-6)
HIDDEN = [8, 24, 64]  # K padded to 16 (8), to 32 (24), none (64)


def _weights(seed, H):
    rng = np.random.default_rng(seed)
    k = 1.0 / np.sqrt(H)
    Wh1 = rng.uniform(-k, k, size=(H, 4 * H)).astype(np.float32)
    W2 = rng.uniform(-k, k, size=(2 * H, 4 * H)).astype(np.float32)
    return (torch.from_numpy(Wh1).to(torch.bfloat16), torch.from_numpy(W2).to(torch.bfloat16))


def _a_tile(frag):
    """[4 registers, 32 lanes, 2 halves] -> the 16 x 16 A tile they hold
    (PTX mma.m16n8k16: register r, lane (g, t) = (lane / 4, lane % 4):
    rows g and g + 8 for odd r, columns 2t + e and + 8 for r >= 2)."""
    A = torch.zeros((16, 16), dtype=torch.float32)
    for r in range(4):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for e in range(2):
                A[g + 8 * (r % 2), 2 * t + e + 8 * (r // 2)] = frag[r, lane, e].float()
    return A


def _tiles(packed):
    return packed.reshape(-1, 4, 32, 2)


def _jax_mm(x, w):
    """The JAX package's bf16 `mm`: x rounded to bf16, f32 sums."""
    return np.asarray(jnp.dot(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))


def _fwd_products(packed, H, h1, h2):
    """The forward's per-warp products, as the kernel maps them: warp u of a
    layer, m-tile mt, C row g (+8) = gate 2 mt (+1) of unit 8u + g, C column
    = batch slot. h1, h2 [8 slots, H] -> (h1 @ Wh1, [h1, h2] @ W2), [8, 4H]."""
    KT, UB = -(-H // 16), H // 8
    tiles = _tiles(packed)
    pad = lambda x: torch.nn.functional.pad(x.to(torch.bfloat16).float(), (0, 16 * KT - H))
    xs = (pad(h1), pad(h2))

    def product(first, n_ops):
        out = torch.zeros((8, 4 * H))
        for u in range(UB):
            for mt in range(2):
                C = torch.zeros((16, 8))
                for op in range(n_ops):
                    for kt in range(KT):
                        A = _a_tile(tiles[first + (u * 2 * n_ops + mt * n_ops + op) * KT + kt])
                        C += A @ xs[op][:, 16 * kt: 16 * kt + 16].T
                for m in range(16):
                    out[:, (2 * mt + m // 8) * H + 8 * u + m % 8] = C[m]
        return out

    return product(0, 1), product(2 * UB * KT, 2)


def _bwd_products(packed, H, d):
    """The chain's per-warp products: role, m-tile j, C row m = unit 16j + m,
    C column = batch slot. d [8 slots, 4H] -> the three roles' [8, H]."""
    MT, KT = -(-H // 16), H // 4
    tiles = _tiles(packed)
    x = d.to(torch.bfloat16).float()
    outs = []
    for role in range(3):
        out = torch.zeros((8, 16 * MT))
        for j in range(MT):
            C = torch.zeros((16, 8))
            for kt in range(KT):
                C += _a_tile(tiles[(role * MT + j) * KT + kt]) @ x[:, 16 * kt: 16 * kt + 16].T
            out[:, 16 * j: 16 * j + 16] = C.T
        outs.append(out[:, :H])
    return outs


@pytest.mark.parametrize("kind", ["fwd_bf16", "bwd_bf16"])
@pytest.mark.parametrize("H", HIDDEN)
def test_bf16_weight_layouts_are_permutations(kind, H):
    """Every weight once, the rest zero padding; `unpack_weights` inverts
    `pack_weights` exactly, and the pack stays bf16 (no f32 copy)."""
    idx = tl.weight_index(kind, H)
    n = 12 * H * H
    assert idx.numel() % 256 == 0  # whole tiles of 4 registers x 32 lanes x 2
    assert torch.equal(idx[idx < n].sort().values, torch.arange(n))
    assert bool((idx[idx >= n] == n).all())
    Wh1, W2 = _weights(1, H)
    packed = tl.pack_weights(kind, Wh1, W2)
    assert packed.dtype == torch.bfloat16 and packed.shape == idx.shape
    assert bool((packed[idx == n] == 0).all())
    back = tl.unpack_weights(kind, packed, H)
    assert torch.equal(back[0], Wh1) and torch.equal(back[1], W2)


@pytest.mark.parametrize("H", HIDDEN)
def test_bf16_layouts_pad_k_and_m_with_zeros(H):
    """The forward's K (the H inputs) is padded to a multiple of 16, the
    chain's M (the H units) likewise; nothing else is padding."""
    KT, UB, MT = -(-H // 16), H // 8, -(-H // 16)
    n = 12 * H * H
    fwd = tl.weight_index("fwd_bf16", H)
    assert fwd.numel() == 6 * UB * KT * 256  # 2 + 4 tiles of each unit block
    assert int((fwd == n).sum()) == 6 * UB * KT * 256 - n
    cols = tl.mma_a_fragment()[1]  # the K column of each fragment element
    per_tile = (fwd.reshape(-1, 4, 32, 2) == n)
    kt = torch.arange(per_tile.shape[0]) % KT
    assert torch.equal(per_tile, (16 * kt[:, None, None, None] + cols[None] >= H))
    bwd = tl.weight_index("bwd_bf16", H)
    assert bwd.numel() == 3 * MT * (H // 4) * 256
    assert int((bwd == n).sum()) == 3 * (16 * MT - H) * 4 * H


@pytest.mark.parametrize("H", HIDDEN)
def test_bf16_layouts_give_the_jax_bf16_gate_products(H):
    """Each packed layout, walked as the kernels walk it, against the JAX
    package's bf16 `mm`: the forward's gate pre-activations (h1 @ Wh1,
    [h1, h2] @ W2) and the chain's dh products (dg2 @ W2[H:]^T, dg2 @
    W2[:H]^T, dg1 @ Wh1^T), over the eight batch slots of one N tile."""
    Wh1, W2 = _weights(2, H)
    rng = np.random.default_rng(3)
    h1, h2 = (torch.from_numpy(rng.uniform(-1, 1, size=(8, H)).astype(np.float32))
              for _ in range(2))
    pre1, pre2 = _fwd_products(tl.pack_weights("fwd_bf16", Wh1, W2), H, h1, h2)
    np.testing.assert_allclose(pre1.numpy(), _jax_mm(h1, Wh1), **VAL)
    np.testing.assert_allclose(pre2.numpy(), _jax_mm(torch.cat([h1, h2], -1), W2), **VAL)

    d = torch.from_numpy(rng.normal(size=(8, 4 * H)).astype(np.float32))
    dh2, dh1_w2, dh1_wh1 = _bwd_products(tl.pack_weights("bwd_bf16", Wh1, W2), H, d)
    np.testing.assert_allclose(dh2.numpy(), _jax_mm(d, W2[H:].T), **VAL)
    np.testing.assert_allclose(dh1_w2.numpy(), _jax_mm(d, W2[:H].T), **VAL)
    np.testing.assert_allclose(dh1_wh1.numpy(), _jax_mm(d, Wh1.T), **VAL)


@pytest.mark.parametrize("B", [1, 15, 16, 17, 128, 513])
def test_bf16_tiling_covers_every_row_once(B):
    """CTA c holds rows 4c .. 4c + 3, row r in N slot 2r of its mma tile
    (`lstm_bf16.cu`: lane l's cell is unit l / 4 of its warp's eight, CTA
    row l % 4, slot 2 (l % 4)): every row in exactly one CTA and slot, every
    cell of a warp's 8 units x 4 rows in exactly one lane, padding only in
    the last CTA."""
    R = tl.ROWS_PER_CTA_BF16
    assert R == 4
    lanes = torch.arange(32)
    assert torch.equal(((lanes // 4) * R + lanes % 4).sort().values, torch.arange(32))
    slots = 2 * (lanes % 4)
    assert sorted(set(slots.tolist())) == [2 * r for r in range(R)]
    grid = -(-B // R)
    rows = torch.arange(grid)[:, None] * R + torch.arange(R)[None, :]
    assert 0 <= grid * R - B < R
    rows = rows[rows < B]
    assert torch.equal(rows, torch.arange(B))
