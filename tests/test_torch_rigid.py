"""The rigid map-distance ops of the port against the JAX package's Pallas
kernels run in interpret mode: `rigid_min_ref` / `rigid_bwd_ref` and the
wrappers `rigid_min`, `rigid_min_fused`, `rigid_bwd` on CPU tensors (which
take the plain versions) against `rigid_min_pallas`,
`rigid_min_fused_pallas`, `rigid_bwd_pallas` and the jnp references.

Fixtures: random point clouds (no ties), a regular 4 x 4 grid (exact
distance ties, which do not depend on the pose) and, at the shapes where the
CUDA forward kernels' packed mask and step tiles are edge-prone (`EDGE_MIN`),
R x C lattices of the bbox grid; random on-road masks with one all-off-road
and one all-on-road step forced in (where there are two steps). Tolerances: `dist`
rtol 1e-6 (one sqrt of the same minimum; measured exact), `idx` exactly
equal (the lowest on-road row wins a tie on both sides), the backward rtol
1e-4 / atol 1e-5 (f32 sums in another order), as `tests/test_pallas.py`.
Above P = 224 the CUDA kernels tile the cache's columns and the backward
walks its chunks in a loop: `lattice_p225`, `lattice_p256`, `p256`,
`one_row_p400` and the tiling plan (`rigid_min_tiling`) cover that range.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.ops import pallas_kernels as jpk
from cld_tpu_torch.ops import native
from cld_tpu_torch.ops import rigid_kernels as rk

torch.set_num_threads(2)

SHAPES = {"b3_q13_p24": (3, 13, 24), "b5_q7_p16": (5, 7, 16), "b2_q4_p100": (2, 4, 100),
          "grid_ties_p16": (3, 9, 16)}
# where the CUDA forward kernels' bit-packed mask (32 rows a word, 7 at the
# untiled kernels' largest P of record, 224) and step tiles (2 steps; blocks
# of 16, sweeps of 64) are edge-prone, and past 224, where the cache no
# longer fits one block (225: one more mask word; 256: a 16 x 16 grid, two
# column chunks), on R x C lattices of the bbox grid (full of exact ties),
# at small B
EDGE_MIN = {"lattice_p1": (2, 3, 1), "lattice_p31_q5": (2, 5, 31), "lattice_p32": (2, 2, 32),
            "lattice_p33_q17": (1, 17, 33), "lattice_p65": (2, 3, 65),
            "lattice_max_p": (1, 3, 224), "lattice_b1_q1": (1, 1, 20),
            "lattice_q65": (1, 65, 8), "lattice_p225": (1, 3, 225), "lattice_p256": (1, 3, 256)}


def _lattice(B, P, rng):
    """[B, P, 2] R x C lattices (R the largest divisor of P up to sqrt(P)) of
    the unit bbox grid, scaled per agent, as `prepack_map_bbox` builds them."""
    R = max(r for r in range(1, int(P ** 0.5) + 1) if P % r == 0)
    lw = np.linspace(-0.5, 0.5, R), np.linspace(-0.5, 0.5, P // R)
    grid = np.stack(np.meshgrid(*lw, indexing="ij"), -1).reshape(-1, 2)
    return (grid[None] * rng.uniform(1.0, 4.0, (B, 1, 2))).astype(np.float32)


def _on_step(B, Q):
    """The step forced all on-road: (1, 1), or the last one of a smaller grid."""
    return (1, 1) if B > 1 and Q > 1 else (B - 1, Q - 1)


def _fixture(name):
    B, Q, P = {**SHAPES, **EDGE_MIN}[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("grid"):
        lin = np.arange(4) - 1.5  # spacings exact in f32, so symmetric neighbours tie
        grid = np.stack(np.meshgrid(lin, lin, indexing="ij"), -1).reshape(-1, 2)
        local = (grid[None] * rng.integers(1, 4, (B, 1, 2))).astype(np.float32)
    elif name.startswith("lattice"):
        local = _lattice(B, P, rng)
    else:
        local = rng.normal(0, 2, (B, P, 2)).astype(np.float32)
    d2 = np.sum((local[:, :, None] - local[:, None]) ** 2, -1)
    on = rng.random((B, Q, P)) > 0.4
    if B * Q > 1:
        on[0, 0] = False  # an all-off-road step: dist = sqrt(1e12), idx = 0
    on[_on_step(B, Q)] = True  # an all-on-road step: every column matches itself
    return d2, on, rng


@functools.lru_cache(maxsize=None)
def _jax_rigid_min(name):
    """The JAX package's three forms on the fixture, once per fixture."""
    d2, on, _ = _fixture(name)
    return {
        "jnp": jpk.rigid_min_ref(jnp.asarray(d2), jnp.asarray(on, jnp.float32)),
        "pallas": jpk.rigid_min_pallas(jnp.asarray(d2), jnp.asarray(on), interpret=True),
        "fused": jpk.rigid_min_fused_pallas(jnp.asarray(d2), jnp.asarray(on), interpret=True),
    }


@pytest.mark.parametrize("name", sorted(SHAPES) + sorted(EDGE_MIN))
@pytest.mark.parametrize("op", ["rigid_min_ref", "rigid_min", "rigid_min_fused"])
def test_rigid_min_matches_jax_kernels(name, op):
    d2, on, _ = _fixture(name)
    B, Q, P = on.shape
    native.reset_launch_counts()
    dist, idx = getattr(rk, op)(torch.from_numpy(d2), torch.from_numpy(on))
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}  # CPU: plain version
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    assert dist.shape == idx.shape == (B, Q, P)
    for tag, (d_j, i_j) in _jax_rigid_min(name).items():
        np.testing.assert_allclose(dist.numpy(), np.asarray(d_j), rtol=1e-6, err_msg=tag)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j), err_msg=tag)
    if B * Q > 1:
        assert np.all(dist.numpy()[0, 0] == np.float32(1e6)) and np.all(idx.numpy()[0, 0] == 0)
    np.testing.assert_array_equal(idx.numpy()[_on_step(B, Q)], np.arange(P))
    np.testing.assert_allclose(dist.numpy()[_on_step(B, Q)], 1e-6, rtol=1e-6)
    if name.startswith("grid") or (name.startswith("lattice") and B * Q > 1 and P > 1):
        masked = np.where(on[..., :, None], d2[:, None], 1e12)
        assert ((masked == masked.min(-2, keepdims=True)).sum(-2) > 1)[on.any(-1)].any()


def test_rigid_min_takes_a_uint8_mask():
    d2, on, _ = _fixture("b5_q7_p16")
    a = rk.rigid_min(torch.from_numpy(d2), torch.from_numpy(on))
    b = rk.rigid_min(torch.from_numpy(d2), torch.from_numpy(on.astype(np.uint8)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("op", ["rigid_bwd_ref", "rigid_bwd"])
def test_rigid_bwd_matches_jax_kernel(name, op):
    d2, on, rng = _fixture(name)
    B, Q, P = on.shape
    dist, idx = rk.rigid_min_ref(torch.from_numpy(d2), torch.from_numpy(on))
    pts = rng.normal(0, 5, (B, Q, P, 2)).astype(np.float32)
    g = rng.normal(0, 1, (B, Q, P)).astype(np.float32)
    # in the loss, cotangents exist only at off-road columns of steps with an
    # on-road row (an on-road column would hit its own 1e-6 self-match)
    g = np.where(on | ~on.any(-1, keepdims=True), 0.0, g).astype(np.float32)
    native.reset_launch_counts()
    got = getattr(rk, op)(torch.from_numpy(pts), idx, dist, torch.from_numpy(g))
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}
    jargs = (jnp.asarray(pts), jnp.asarray(idx.numpy()), jnp.asarray(dist.numpy()), jnp.asarray(g))
    assert float(np.abs(got.numpy()).max()) > 1e-2  # the fixture routes something
    for tag, want in (("jnp", jpk.rigid_bwd_ref(*jargs)),
                      ("pallas", jpk.rigid_bwd_pallas(*jargs, interpret=True))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5,
                                   err_msg=tag)


@pytest.mark.parametrize("op", ["rigid_min", "rigid_min_fused", "rigid_bwd"])
def test_rigid_wrappers_take_p_past_224_on_the_cpu(op):
    """P = 225 (the first P past the kernels' old limit of 224) runs each
    wrapper's plain version on CPU tensors, with no launch."""
    B, Q, P = 1, 2, 225
    rng = np.random.default_rng(225)
    local = _lattice(B, P, rng)
    d2 = torch.from_numpy(np.sum((local[:, :, None] - local[:, None]) ** 2, -1))
    on = torch.from_numpy(rng.random((B, Q, P)) > 0.4)
    native.reset_launch_counts()
    want_d, want_i = rk.rigid_min_ref(d2, on)
    if op == "rigid_bwd":
        pts = torch.from_numpy(rng.normal(0, 5, (B, Q, P, 2)).astype(np.float32))
        g = torch.from_numpy(rng.normal(0, 1, (B, Q, P)).astype(np.float32))
        assert torch.equal(rk.rigid_bwd(pts, want_i, want_d, g),
                           rk.rigid_bwd_ref(pts, want_i, want_d, g))
    else:
        dist, idx = getattr(rk, op)(d2, on)
        assert torch.equal(dist, want_d) and torch.equal(idx, want_i)
    assert native.launch_counts() == {k: 0 for k in native.KERNELS}


@pytest.mark.parametrize("P", [1, 100, 160, 161, 224, 225, 232, 233, 256, 400, 1024,
                               rk.RIGID_MAX_P])
def test_rigid_min_tiling_fits_a_block_and_covers_every_column(P):
    """The forward kernels' plan: the whole cache (pc = P) with the untiled steps
    a block while it fits, else column chunks of a multiple of 4 that cover
    the P columns once; every block within an H100's 227 KB of shared
    memory, at most 16 steps; a 32 x 32 grid (P = 1,024) is taken, past
    `RIGID_MAX_P` the plan raises. Column chunks give the whole minimum: each
    column's min and argmin run over every row."""
    qb, pc = rk.rigid_min_tiling(P)
    S = -(-P // 4) * 4
    assert qb % rk.RIGID_MIN_TILE == 0 and rk.RIGID_MIN_TILE <= qb <= 64
    if P <= 224:
        assert (qb, pc) == (64 if P <= 160 else 16, P)
    if pc >= P:
        assert pc == P and 4 * P * S + qb * rk._step_bytes(P) <= rk.SMEM_BYTES
    else:
        chunks = -(-P // pc)
        assert pc % 4 == 0 and qb <= rk.TILED_STEPS and P > 224
        assert 0 < P - (chunks - 1) * pc <= pc  # the last chunk: ragged, never empty
        assert 4 * P * pc + qb * rk._step_bytes(P) <= rk.SMEM_BYTES
        assert 24 * P <= rk.SMEM_BYTES  # the backward's running sums
    if P == rk.RIGID_MAX_P:
        with pytest.raises(ValueError, match="RIGID_MAX_P"):
            rk.rigid_min_tiling(P + 1)
    if 225 <= P <= 1024:  # chunked minima against the whole, on a lattice
        rng = np.random.default_rng(P)
        local = _lattice(1, P, rng)
        d2 = torch.from_numpy(np.sum((local[:, :, None] - local[:, None]) ** 2, -1))
        on = torch.from_numpy(rng.random((1, 2, P)) > 0.4)
        want = rk.rigid_min_ref(d2, on)
        rows = torch.arange(P, dtype=torch.int32)[:, None]
        dist, idx = [], []
        for c0 in range(0, P, pc):  # a block's columns, every row
            masked = torch.where(on[..., :, None], d2[:, None, :, c0:c0 + pc], rk.BIG_D2)
            m = masked.amin(-2)
            dist.append(torch.sqrt(m + 1e-12))
            idx.append(torch.where(masked == m[..., None, :], rows, P).amin(-2))
        assert torch.equal(torch.cat(dist, -1), want[0])
        assert torch.equal(torch.cat(idx, -1), want[1])


def test_rigid_wrappers_raise_off_cpu_and_cuda():
    m = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device="meta")
    for fn in (rk.rigid_min, rk.rigid_min_fused):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(m(2, 4, 4), m(2, 3, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        rk.rigid_bwd(m(2, 3, 4, 2), m(2, 3, 4, dtype=torch.int32), m(2, 3, 4), m(2, 3, 4))


# (B, Q, P, the row every column routes to, or None for random rows)
EDGE_BWD = {"p1": (2, 3, 1, None), "p33": (2, 3, 33, None), "p224": (2, 3, 224, None),
            "one_row_p100": (2, 3, 100, 37), "one_row_p224": (1, 2, 224, 0),
            "p256": (1, 3, 256, None), "one_row_p400": (1, 2, 400, 250)}


@pytest.mark.parametrize("name", sorted(EDGE_BWD))
def test_rigid_bwd_matches_jax_kernel_at_edge_shapes(name):
    """The shapes where the CUDA backward's grouping of a warp's columns by
    row is edge-prone: one column (one lane of one chunk), one column past a
    chunk of 32, seven chunks (the most it holds in registers, P = 224),
    eight (P = 256, its loop over chunks), and every column routed to one row
    (groups of 32 in every chunk; P = 400: the loop's last chunk ragged)."""
    B, Q, P, row = EDGE_BWD[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    pts = rng.normal(0, 5, (B, Q, P, 2)).astype(np.float32)
    idx = (rng.integers(0, P, (B, Q, P)) if row is None else np.full((B, Q, P), row)
           ).astype(np.int32)
    dist = rng.uniform(0.5, 2.0, (B, Q, P)).astype(np.float32)
    g = rng.normal(0, 1, (B, Q, P)).astype(np.float32)
    got = rk.rigid_bwd(*map(torch.from_numpy, (pts, idx, dist, g))).numpy()
    jargs = tuple(map(jnp.asarray, (pts, idx, dist, g)))
    for tag, want in (("jnp", jpk.rigid_bwd_ref(*jargs)),
                      ("pallas", jpk.rigid_bwd_pallas(*jargs, interpret=True))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=tag)
    if row is not None:  # only the one row receives anything
        assert np.abs(got[:, :, row]).max() > 1.0
        assert not np.delete(got, row, axis=2).any()


@pytest.mark.parametrize("B,Q,want", [(128, 52, 26), (32, 52, 8), (1, 52, 2), (133, 52, 26),
                                      (600, 52, 52), (600, 200, 64), (4, 1, 2)])
def test_rigid_min_steps_per_block(B, Q, want):
    """The `rigid_min` kernel's steps per block: a multiple of the step tile,
    at most 64, about two blocks per SM of an H100 (132) where the horizon
    allows."""
    got = rk.rigid_min_steps_per_block(B, Q, 132)
    assert got == want
    assert got % rk.RIGID_MIN_TILE == 0 and got <= 64
    if rk.RIGID_MIN_TILE < got < min(Q, 64):
        assert 132 <= B * -(-Q // got) <= 4 * 132  # enough blocks to fill the card, not more
