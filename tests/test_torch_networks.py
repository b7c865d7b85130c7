"""The port's networks against the JAX package's flax modules, with weights
crossing through `cld_tpu_torch.utils.weights`: the context encoder
(ResNet-18 + state MLP, raster 64, B=4) and the temporal UNet. Also: the
port's converter emits exactly `cld_tpu.utils.torch_export`'s keys and
arrays.

Tolerance: rtol 1e-4 / atol 1e-4 on the outputs (f32 convolutions through
18-20 layers on two libraries' CPU conv and GEMM kernels, which sum in
different orders; LayerNorm/GroupNorm statistics differ in their last
bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp

from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu.models.context import ContextEncoder as JaxContext
from cld_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from cld_tpu.models.vae import VaeModel
from cld_tpu.utils import torch_export as te
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
NET = dict(rtol=1e-4, atol=1e-4)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _randomize_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        name = path[-1].key
        if name == "mean":
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, _np_tree(stats))


@pytest.fixture(scope="module")
def context_pair():
    jb = jax_synthetic(seed=0, batch_size=4, raster_size=64)
    m = JaxContext(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32)
    v = jax.jit(m.init)(jax.random.key(0), jb)
    v = {"params": _np_tree(v["params"]), "batch_stats": _randomize_stats(v["batch_stats"], 1)}
    port = ContextEncoder(34, 16, 32, 32)
    sd = tw.export_context_encoder(v["params"], v["batch_stats"], root="")
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()},
                         strict=True)
    return m, v, port.eval(), jb


def test_context_encoder_matches_flax(context_pair):
    m, v, port, jb = context_pair
    want = jax.jit(lambda v, b: m.apply(v, b, train=False))(v, jb)
    tb = synthetic_batch(seed=0, batch_size=4, raster_size=64, device="cpu")
    with torch.no_grad():
        got = port(tb)
    np.testing.assert_allclose(got["cond_feat"].numpy(), np.asarray(want["cond_feat"]), **NET)
    np.testing.assert_array_equal(got["curr_states"].numpy(), np.asarray(want["curr_states"]))


@pytest.mark.parametrize("dim,mults,T", [(8, (2, 4, 8), 52), (8, (1, 2), 12)])
def test_temporal_unet_matches_flax(dim, mults, T):
    B, D, C = 3, 4, 16
    m = JaxUnet(transition_dim=D, output_dim=D, dim=dim, dim_mults=mults)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    cond = rng.normal(size=(B, C)).astype(np.float32)
    t = np.array([0, 37, 99])
    v = jax.jit(m.init)(jax.random.key(1), jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    # non-trivial GroupNorm affine parameters
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if p[-1].key in ("scale", "bias") else np.asarray(a), v)
    want = jax.jit(m.apply)(v, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t))
    port = TemporalMapUnet(D, D, C, dim, mults)
    tw.load_temporal_unet(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(cond), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **NET)


def _assert_same_dict(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_converter_matches_torch_export():
    """Both converters on the same variables: their layout is what is held,
    so the variables are seeded in the layout `init` gives (read off
    `jax.eval_shape`, `zoo_parity.random_variables`), nothing initialized."""
    jb = jax_synthetic(seed=0, batch_size=2, raster_size=64)
    vae = VaeModel(curr_state_feat_dim=16, map_feature_dim=32, cond_feat_dim=32,
                   vae_hidden_size=16)
    v = zp.random_variables(vae, jb, 0.05, rngs=("params", "sample"))
    v = {"params": _np_tree(v["params"]), "batch_stats": _randomize_stats(v["batch_stats"], 3)}
    _assert_same_dict(tw.export_vae_checkpoint(v), te.export_vae_checkpoint(v))
    unet = JaxUnet(transition_dim=4, output_dim=4, dim=8)
    uv = _np_tree(zp.random_variables(unet, jnp.zeros((2, 52, 4)), jnp.zeros((2, 32)),
                                      jnp.zeros((2,), jnp.int32), seed=2))
    _assert_same_dict(tw.export_dm_checkpoint(uv), te.export_dm_checkpoint(uv))
    _assert_same_dict(tw.export_temporal_unet(uv["params"]), te.export_temporal_unet(uv["params"]))
