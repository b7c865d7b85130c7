"""Trained checkpoints in the port: reference Lightning files
(`cld_tpu_torch.utils.torch_import`), models built from a config and loaded
from checkpoints (`pipeline.build_models_from_config`, `load_checkpoints`),
the decoder's two implementations, `--mode test` against the JAX package's
`evaluate`, and the train -> roll out -> evaluate path of the two CLIs on
the CPU at the `cld_smoke` widths.

The reference-layout file is written by the JAX package's own exporter
(`cld_tpu.utils.torch_export`) from JAX variables; the JAX side reads it
back through `cld_tpu.utils.torch_import`, the port through its own loader.

Tolerances: the networks read from one file agree within 1e-5 (context
features rtol 1e-5 + atol 1e-5; decoded actions and the UNet output atol
1e-5); `--mode test`'s statistics within rtol 1e-4 + atol 1e-3, as
`tests/test_torch_ppo.py` holds the test step's (accelerations from inverse
dynamics, jerk their difference over dt = 0.1, in f32 on two libraries;
the sampled ones after five denoise steps of f32 networks), each
batch's failure rates within one agent in the batch (1/B: a rate is a count
of thresholded trajectories), the realism deviation within 1e-3 relative
(Wasserstein distances of those statistics). Weights loaded along two routes
into the port give equal trajectories, bit for bit.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cld_tpu.data.loader import make_loader as jax_make_loader
from cld_tpu.eval.metrics import realism_deviation as jax_realism_deviation
from cld_tpu.models.temporal_unet import TemporalMapUnet as JaxUnet
from cld_tpu.models.vae import VaeModel as JaxVaeModel
from cld_tpu.training.dm import DMTrainer as JaxDMTrainer
from cld_tpu.training.ppo import PPOTrainer as JaxPPOTrainer
from cld_tpu.training.vae import VAETrainer as JaxVAETrainer
from cld_tpu.utils import torch_export as te
from cld_tpu.utils import torch_import as jti
from cld_tpu.utils.registry import get_registered_experiment_config as jax_registered
from cld_tpu_torch import pipeline, train
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.models.vae import LSTMDecoder, decode_actions
from cld_tpu_torch.training.checkpoints import restore_pytree, save_pytree
from cld_tpu_torch.training.vae import build_vae_model
from cld_tpu_torch.utils import torch_import as ti
from cld_tpu_torch.utils.config import default_config
from cld_tpu_torch.utils.registry import get_registered_experiment_config

torch.set_num_threads(2)
VAL_B, T, L = 8, 52, 4


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _smoke(registered):
    """`cld_smoke` with validation batches of 8 agents."""
    cfg = registered("cld_smoke").unlock()
    cfg.train.validation.batch_size = VAL_B
    return cfg.lock()


def _randomize_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        if path[-1].key == "mean":
            return rng.normal(size=a.shape).astype(np.float32) * 0.1
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, _np_tree(stats))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX models as the JAX `evaluate` builds them (VAE from key 0 on the
    validation stream's first batch, denoiser from key seed + 2), the VAE's
    BatchNorm statistics randomized, written by the JAX exporter as one
    Lightning-style file (`vae.` + `dm.model.` keys, and a pickled
    hyper-parameter object beside the weights, as Lightning stores)."""
    jcfg = _smoke(jax_registered)
    first = next(iter(jax_make_loader(jcfg, "val")))
    vs = JaxVAETrainer(jcfg).init_state(jax.random.key(0), first)
    vae_vars = {"params": _np_tree(vs.params), "batch_stats": _randomize_stats(vs.batch_stats, 3)}
    jdm = JaxDMTrainer(jcfg, vae_vars)
    jstate = jdm.init_state(jax.random.key(jcfg.seed + 2))
    path = tmp_path_factory.mktemp("ref") / "reference.ckpt"
    sd = {**te.export_vae_checkpoint(vae_vars),
          **te.export_dm_checkpoint({"params": _np_tree(jstate.params)})}
    te.save_state_dict_file(str(path), sd, meta={
        "epoch": 3, "hyper_parameters": argparse.Namespace(algo="cld")})
    return dict(jcfg=jcfg, jdm=jdm, jstate=jstate, path=path, sd=sd)


def test_lightning_file_needs_the_full_unpickler_and_loads_strictly(ref):
    with pytest.raises(Exception, match="[Ww]eights only"):
        torch.load(ref["path"], weights_only=True)
    sd = ti.load_state_dict_file(str(ref["path"]))
    assert sorted(sd) == sorted(ref["sd"])
    assert ti.find_resnet_root(ti.submap(sd, "vae.context_encoder")) == ti.PORT_RESNET_ROOT
    cfg = _smoke(get_registered_experiment_config)
    vae = ti.load_vae_model(build_vae_model(cfg, "cpu"), sd)
    for k, v in vae.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref["sd"][f"vae.{k}"], err_msg=k)
    # a raw RasterizedMapEncoder trunk root is re-rooted
    raw = {k.replace("encoder_heads.map_model", "map_model"): v for k, v in sd.items()}
    assert ti.find_resnet_root(ti.submap(raw, "vae.context_encoder")) == "map_encoder.map_model"
    ctx = ti.load_context_encoder(ContextEncoder(12, 16, 32, 32), raw)
    np.testing.assert_array_equal(ctx.state_dict()["process_cond_mlp._model.0.weight"].numpy(),
                                  ref["sd"]["vae.context_encoder.process_cond_mlp._model.0.weight"])
    with pytest.raises(RuntimeError, match="Missing key"):
        ti.load_temporal_unet(TemporalMapUnet(4, 4, 32, 8, (2, 4, 8)),
                              {k: v for k, v in sd.items() if "final_conv.1" not in k})
    with pytest.raises(ValueError, match="no 'dm' weights"):
        ti.module_state_dict(ti.submap(sd, "vae"), "dm")


def test_port_computes_what_the_jax_import_computes(ref):
    """The file read by both packages' importers: context features, decoded
    actions and the UNet's output, each within 1e-5."""
    jcfg = ref["jcfg"]
    sd = ti.load_state_dict_file(str(ref["path"]))
    jvae = jti.import_checkpoint_file(str(ref["path"]), "vae")
    jdm_vars = jti.import_checkpoint_file(str(ref["path"]), "dm")
    a = jcfg.algo
    m = JaxVaeModel(curr_state_feat_dim=a.curr_state_feat_dim, map_feature_dim=a.map_feature_dim,
                    cond_feat_dim=a.cond_feat_dim, vae_hidden_size=a.vae.hidden_size,
                    vae_latent_size=a.vae.latent_size)
    jb = next(iter(jax_make_loader(jcfg, "val")))
    aux = jax.jit(lambda v, b: m.apply(v, b, method="pre_vae")[0])(jvae, jb)
    ctx = ti.load_context_encoder(ContextEncoder(12, 16, 32, 32), sd)
    tb = next(train._eval_batches(_smoke(get_registered_experiment_config), "cpu"))
    with torch.no_grad():
        cond = ctx(tb)["cond_feat"]
    np.testing.assert_allclose(cond.numpy(), np.asarray(aux["cond_feat"]), rtol=1e-5, atol=1e-5)

    rng = np.random.default_rng(4)
    z = rng.normal(size=(VAL_B, T, L)).astype(np.float32)
    c = np.array(aux["cond_feat"])
    want = jax.jit(lambda v, z, c: m.apply(v, z, c, method="decode"))(jvae, z, c)
    dec = ti.load_lstm_decoder(LSTMDecoder(4, 16, 32), sd)
    with torch.no_grad():
        got = decode_actions(dec, torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    unet_j = JaxUnet(transition_dim=L, output_dim=L, dim=a.base_dim, dim_mults=tuple(a.dim_mults))
    t = np.array([0, 1, 2, 3, 4, 0, 2, 4])
    want = jax.jit(unet_j.apply)(jdm_vars, z, c, t)
    unet = ti.load_temporal_unet(TemporalMapUnet(4, 4, 32, 8, (2, 4, 8)), sd)
    with torch.no_grad():
        got = unet(torch.from_numpy(z), torch.from_numpy(c), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_import_cli_writes_the_port_format(ref, tmp_path):
    for kind, n in (("vae", None), ("dm", None)):
        out = tmp_path / kind
        ti.main(["--ckpt", str(ref["path"]), "--kind", kind, "--out", str(out)])
        params = restore_pytree(str(out))["params"]
        want = ti.module_state_dict(ti.load_state_dict_file(str(ref["path"])), kind)
        assert sorted(params) == sorted(want)
        assert all(torch.equal(params[k], want[k]) for k in want)
        assert ti.read_checkpoint(str(out), kind).keys() == want.keys()
    bare = tmp_path / "unet.pt"
    torch.save(ti.submap(ti.load_state_dict_file(str(ref["path"])), "dm.model"), bare)
    ti.main(["--ckpt", str(bare), "--kind", "unet", "--out", str(tmp_path / "unet")])
    assert restore_pytree(str(tmp_path / "unet"))["params"].keys() == want.keys()


def test_models_from_config_and_checkpoints(ref, tmp_path):
    """`build_models_from_config` takes every width from the config (the
    record's equal `build_models`' defaults, weight for weight), and
    `load_checkpoints` gives the same weights from a Lightning file and from
    the port's own files."""
    rec = pipeline.build_models_from_config(default_config().lock(), device="cpu", seed=0)
    dflt = pipeline.build_models(seed=0, device="cpu")
    for a, b in ((rec.context, dflt.context), (rec.decoder, dflt.decoder),
                 (rec.unet, dflt.unet)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    cfg = _smoke(get_registered_experiment_config)
    light = pipeline.load_checkpoints(pipeline.build_models_from_config(cfg, "cpu"),
                                      str(ref["path"]), str(ref["path"]))
    assert light.unet.time_mlp[1].weight.shape[1] == cfg.algo.base_dim
    assert light.schedule.n_timesteps == cfg.algo.n_diffusion_steps
    sd = ti.load_state_dict_file(str(ref["path"]))
    save_pytree(str(tmp_path / "vae"), {"params": ti.module_state_dict(sd, "vae")})
    save_pytree(str(tmp_path / "dm"), {"params": ti.module_state_dict(sd, "dm")})
    own = pipeline.load_checkpoints(pipeline.build_models_from_config(cfg, "cpu", seed=9),
                                    str(tmp_path / "vae"), str(tmp_path / "dm"))
    for a, b in ((light.context, own.context), (light.decoder, own.decoder),
                 (light.unet, own.unet)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_decode_impls_agree_in_value_and_gradient():
    dec = LSTMDecoder(4, 16, 32)
    g = torch.Generator().manual_seed(0)
    z = torch.randn((3, 2, T, L), generator=g, requires_grad=True)
    c = torch.randn((3, 2, 32), generator=g)
    outs = {}
    for impl in ("auto", "kernel", "module"):
        y = decode_actions(dec, z, c, impl=impl)
        (gz,) = torch.autograd.grad((y * y).sum(), z)
        outs[impl] = (y.detach(), gz)
    assert outs["auto"][0].shape == (3, 2, T, 2)
    for impl in ("auto", "module"):
        np.testing.assert_allclose(outs[impl][0].numpy(), outs["kernel"][0].numpy(), atol=1e-5)
        np.testing.assert_allclose(outs[impl][1].numpy(), outs["kernel"][1].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="decode impl"):
        decode_actions(dec, z, c, impl="pallas")


def _jax_eval_noise(jcfg, n_batches):
    """Each batch's sampler noise under the JAX `evaluate`'s key schedule:
    key(seed + 5) split per batch, `test_step`'s split, `DMTrainer.sample`'s
    split, then `sample_traj`'s init and per-step keys."""
    n = jcfg.algo.n_diffusion_steps
    rng = jax.random.key(jcfg.seed + 5)
    keys, noises = [], []
    for _ in range(n_batches):
        rng, step_rng = jax.random.split(rng)
        keys.append(step_rng)
        _, samp = jax.random.split(step_rng)
        _, samp = jax.random.split(samp)
        srng, init_rng = jax.random.split(samp)
        x_init = np.array(jax.random.normal(init_rng, (VAL_B, T, L), jnp.float32))
        steps = np.array(jax.vmap(lambda k: jax.random.normal(k, (VAL_B, T, L), jnp.float32))(
            jax.random.split(srng, n)))
        noises.append(dict(x_init=torch.from_numpy(x_init), step_noises=torch.from_numpy(steps)))
    return keys, noises


def test_mode_test_matches_the_jax_evaluate(ref, capsys):
    """`--mode test` on the Lightning file against the JAX `evaluate` loop on
    the same weights and noise: the validation stream (batch 0 is the
    loader's first, not dropped), each batch's rates and statistics, and the
    aggregated result."""
    jcfg, jdm, jstate = ref["jcfg"], ref["jdm"], ref["jstate"]
    n_batches = 3
    keys, noises = _jax_eval_noise(jcfg, n_batches)
    jppo = JaxPPOTrainer(jcfg, jdm)
    jit = iter(jax_make_loader(jcfg, "val"))
    cfg = _smoke(get_registered_experiment_config)
    ours = train._eval_batches(cfg, "cpu")
    seen = []
    orig = train.PPOTrainer.test_step

    def recording(self, dm_state, batch, **kw):
        rates, stats = orig(self, dm_state, batch, **kw)
        seen.append((batch, rates, stats))
        return rates, stats

    args = argparse.Namespace(device="cpu", steps=n_batches, vae_ckpt=str(ref["path"]),
                              dm_ckpt=str(ref["path"]))
    train.PPOTrainer.test_step = recording
    try:
        result = train.evaluate(cfg, args, noise=lambda i: noises[i])
    finally:
        train.PPOTrainer.test_step = orig
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == result
    j_rates, j_stats = [], []
    for i in range(n_batches):
        jb, tb_stream = next(jit), next(ours)
        batch, rates, stats = seen[i]
        compared = 0
        for name in jb._fields:
            w, g = getattr(jb, name), getattr(batch, name)
            if w is not None and g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
                np.testing.assert_array_equal(getattr(tb_stream, name).numpy(), np.asarray(w))
                compared += 1
        assert compared >= 9
        jr, js = jppo.test_step(jstate, jb, keys[i])
        assert sorted(rates) == sorted(jr) and sorted(stats) == sorted(js)
        for k in jr:
            assert abs(float(rates[k]) - float(jr[k])) <= 1.0 / VAL_B + 1e-7, (i, k)
        for k in js:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(js[k]), rtol=1e-4, atol=1e-3,
                                       err_msg=k)
        j_rates.append({k: float(v) for k, v in jr.items()})
        j_stats.append({k: np.asarray(v) for k, v in js.items()})
    want = {k: float(np.mean([r[k] for r in j_rates])) for k in j_rates[0]}
    want.update(jax_realism_deviation(
        {k: np.concatenate([s[k] for s in j_stats]) for k in j_stats[0]}, dt=jcfg.algo.step_time))
    assert sorted(result) == sorted(want)
    for k in want:
        if k.endswith("failure_rate"):
            assert abs(result[k] - want[k]) <= 1.0 / VAL_B, k
        else:
            assert result[k] == pytest.approx(want[k], rel=1e-3), k
