"""bf16 mixed precision of the zoo trainer against the JAX package's, on the
CPU at `train.training.precision = "bf16"` on both sides.

For each of the ten algos whose JAX factory passes the compute `dtype`
(`cld_tpu/training/zoo.py`), the port's `ZooTrainer` network at bf16 over
float32 parameters against the flax module at `dtype=bfloat16`, from the
same seeded weights (`zoo_parity.random_variables`, loaded by
`utils.weights.load_flax`) and the JAX side's own draws (bf16 where the
flax module draws in its compute dtype, widened exactly to float32): the
eval-mode loss (running BatchNorm statistics, the discrete CVAE's argmax
mode) and its gradients in every parameter, from one JAX compile per algo,
held by the "bf16 twins" rule referred to JAX's own bf16 error
(`zoo_parity.assert_bf16_twins`): the exact value is the port's float32
loss and gradients on the same weights and draws. autocast and flax round
at different places, and on these ResNet models JAX's own bf16 gradient
lies at cosine 0.990-0.9999 from its float32 one, so the absolute twin
cosine (0.999) cannot separate two bf16 computations here.

Every parameter is float32, except TransformerPred's `hist_pos_emb` and
`future_queries`, which the JAX module creates in its compute dtype; Adam's
moments and BatchNorm's statistics after a train step take the parameters'
dtypes; the map UNet's logits are float32 (its head, as the JAX module's).
`diff` stays float32 under bf16, as its JAX factory gives its
networks no `dtype`. A fully masked attention query still averages its keys
uniformly at bf16. The CVAE building blocks (`models/cvae_nets.py`) at bf16
against the flax modules at `dtype=bfloat16`, their outputs within twice
JAX's own bf16 error.

Fixture (`zoo_parity.py`): the `cld_smoke` widths, raster 40, B=3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp

from cld_tpu.models import cvae_nets as jnets
from cld_tpu.training import zoo as jax_zoo
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.models import cvae_nets as pnets
from cld_tpu_torch.models.nets import MultiHeadDotProductAttention
from cld_tpu_torch.ops.precision import autocast, set_compute_dtype
from cld_tpu_torch.training import zoo
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
BF16 = torch.bfloat16
BF16_ALGOS = ["bc", "bc_gc", "vae", "discrete_vae", "TransformerPred", "tree_vae",
              "agent_predictor", "bc_ec", "spatial_planner", "occupancy"]
STORED_BF16 = {"TransformerPred": {"hist_pos_emb", "future_queries"}}


def precision_config(get, precision="bf16"):
    cfg = get("cld_smoke").unlock()
    cfg.env.rasterizer.raster_size = zp.RASTER
    cfg.train.training.precision = precision
    return cfg.lock()


def port_noise(name, d) -> dict:
    """The JAX side's draws as the port's explicit `noise`, in float32."""
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))
    if name == "vae":
        return {"noise": f32(d["normal"][0])}
    if name == "discrete_vae" and d["uniform"]:
        return {"uniform": f32(d["uniform"][0])}
    if name == "tree_vae":
        return {"noise": f32(np.stack([np.asarray(a, np.float32) for a in d["normal"]]))}
    return {}


def port_loss_and_grads(precision, name, v, tb, noise):
    """The port's trainer at `precision` with the flax variables `v`: the
    trainer, its state, the eval-mode loss after backward."""
    trainer = zoo.ZooTrainer(precision_config(registry.get_registered_experiment_config,
                                              precision), name, device="cpu")
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    loss, _ = trainer.spec.loss_call(state.model, tb, False, noise)
    loss.backward()
    return trainer, state, loss


@pytest.mark.parametrize("name", BF16_ALGOS)
def test_zoo_algo_at_bf16_is_a_bf16_twin(name, monkeypatch):
    jb, tb = zp.batches()
    spec = jax_zoo.algo_factory(precision_config(jax_registry.get_registered_experiment_config),
                                name)
    v = zp.random_variables(spec["model"], jb, rngs=spec["init_rngs"])
    rng = jax.random.key(11)

    def jax_side(params, v, jb):
        return jax.value_and_grad(
            lambda p: spec["loss_call"](dict(v, params=p), jb, rng, False)[0])(params)

    drawn, (loss_j, grads_j) = zp.record_draws(monkeypatch, jax_side, v["params"], v, jb,
                                               keep_output=True)

    noise = port_noise(name, drawn)
    trainer, state, loss = port_loss_and_grads("bf16", name, v, tb, noise)
    model = state.model
    assert trainer.compute_dtype == BF16 and loss.dtype == torch.float32
    stored = STORED_BF16.get(name, set())
    for k, p in model.named_parameters():
        assert p.dtype == (BF16 if k in stored else torch.float32), k
    nets = [m for m in model.modules() if hasattr(m, "compute_dtype")]
    assert nets and all(m.compute_dtype == BF16 for m in nets)
    _, state32, loss32 = port_loss_and_grads("fp32", name, v, tb, noise)

    keys = [k for k, _ in model.named_parameters() if "bias_hh" not in k]
    want = tw.export_flax(model, zp.np_tree(grads_j), v.get("batch_stats"))
    zp.assert_bf16_twins(float(loss.detach()), float(loss_j), float(loss32.detach()),
                         zp.grad_vector(model, keys),
                         np.concatenate([np.asarray(want[k], np.float64).ravel() for k in keys]),
                         zp.grad_vector(state32.model, keys), name)

    if name in ("spatial_planner", "occupancy"):  # the UNet's 1x1 head is float32
        with torch.no_grad():
            assert model.unet(tb.image).dtype == torch.float32

    # a train step keeps the parameters' dtypes, in the moments and statistics too
    state.optimizer.zero_grad(set_to_none=True)
    state, metrics = trainer.train_step(state, tb, generator=torch.Generator().manual_seed(0))
    assert metrics["skipped_nonfinite"] == 0.0 and state.step == 1
    for k, p in model.named_parameters():
        assert p.dtype == (BF16 if k in stored else torch.float32), k
        for m in state.optimizer.state[p].values():
            assert not m.is_floating_point() or m.ndim == 0 or m.dtype == p.dtype, k
    assert all(b.dtype in (torch.float32, torch.int64) for b in model.buffers())


def _bf16_blocks():
    """(flax module at bf16, the port's module, numpy arguments) per CVAE
    building block; every scene of the max aggregation has a real agent."""
    rng = np.random.default_rng(6)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    traj, cond = f32(3, 7, 6), f32(3, 12)
    shapes = {"mu": (4,), "logvar": (4,)}
    mask = np.array([[True, True, False], [False, True, False], [True, False, True]])
    scene = (f32(3, 3, 5, 6), f32(3, 3, 10), mask)
    curr = np.concatenate([f32(3, 2), np.float32([[5.0], [8.0], [3.0]]), f32(3, 1) * 0.1], -1)
    bf = dict(dtype=jnp.bfloat16)
    return {
        "SplitMLP": (jnets.SplitMLP(shapes, (16,), True, **bf),
                     pnets.SplitMLP(12, shapes, (16,), True), (cond,)),
        "MIMOMLP": (jnets.MIMOMLP(shapes, (16,), **bf), pnets.MIMOMLP(54, shapes, (16,)),
                    ({"b": cond, "a": traj},)),
        "RNNTrajectoryEncoder": (jnets.RNNTrajectoryEncoder(24, **bf),
                                 pnets.RNNTrajectoryEncoder(6, 24), (traj,)),
        "PosteriorEncoder": (jnets.PosteriorEncoder(shapes, (16,), 24, **bf),
                             pnets.PosteriorEncoder(6, 12, shapes, (16,), 24), (traj, cond)),
        "ScenePosteriorEncoder_max": (
            jnets.ScenePosteriorEncoder(shapes, "max", (16,), 14, num_heads=4, **bf),
            pnets.ScenePosteriorEncoder(6, 10, shapes, "max", (16,), 14, num_heads=4), scene),
        "ScenePosteriorEncoder_mean": (
            jnets.ScenePosteriorEncoder(shapes, "mean", (16,), 14, num_heads=4, **bf),
            pnets.ScenePosteriorEncoder(6, 10, shapes, "mean", (16,), 14, num_heads=4), scene),
        "ConditionNet": (jnets.ConditionNet(9, (16,), **bf), pnets.ConditionNet(54, 9, (16,)),
                         ({"x": traj, "c": cond},)),
        "MLPTrajectoryDecoder": (jnets.MLPTrajectoryDecoder(horizon=7, layer_dims=(16,), **bf),
                                 pnets.MLPTrajectoryDecoder(12, 7, layer_dims=(16,)),
                                 (cond, curr)),
    }


def _port_args(args):
    t = lambda a: torch.tensor(a)
    return [{k: t(x) for k, x in a.items()} if isinstance(a, dict) else t(a) for a in args]


def test_cvae_building_blocks_at_bf16_match_jax():
    """Each CVAE building block at bf16 against the flax module at
    `dtype=bfloat16` from the same weights: every output within twice JAX's
    own bf16 error (the port's float32 output the exact value,
    `zoo_parity.assert_within_jax_bf16_error`)."""
    for name, (jm, pm, args) in _bf16_blocks().items():
        v = zp.random_variables(jm, *args)
        want = jax.tree.leaves(jax.jit(jm.apply)(v, *args))
        tw.load_flax(pm, v)
        with torch.no_grad():
            exact = jax.tree.leaves(pm(*_port_args(args)))
            got = jax.tree.leaves(set_compute_dtype(pm, BF16)(*_port_args(args)))
        zp.assert_within_jax_bf16_error(
            np.concatenate([g.float().numpy().ravel() for g in got]),
            np.concatenate([np.asarray(w, np.float32).ravel() for w in want]),
            np.concatenate([x.numpy().ravel() for x in exact]), name)


def test_diff_stays_float32_under_bf16():
    """`diff` computes in float32 under bf16: its loss is bit for bit the
    fp32 trainer's from the same weights and draws."""
    tb = zp.batches()[1]
    losses = []
    for precision in ("bf16", "fp32"):
        trainer = zoo.ZooTrainer(precision_config(registry.get_registered_experiment_config,
                                                  precision), "diff", device="cpu")
        assert trainer.compute_dtype == torch.float32
        model = trainer.init_state(0).model
        assert {m.compute_dtype for m in model.modules() if hasattr(m, "compute_dtype")} == {
            torch.float32}
        noise = trainer.spec.draw(tb, torch.Generator().manual_seed(0))
        losses.append(trainer.spec.loss_call(model, tb, False, noise)[0])
    assert torch.equal(*losses)


def test_fully_masked_query_averages_uniformly_at_bf16():
    """A query whose keys are all masked takes bf16's minimum as every logit
    (flax's at dtype bf16) and averages the values uniformly."""
    torch.manual_seed(0)
    attn = MultiHeadDotProductAttention(16, 4)
    x = torch.randn(2, 5, 16)
    mask = torch.ones(2, 1, 5, 5, dtype=torch.bool)
    mask[0, :, 2] = False  # query 2 of the first batch row sees no key
    with autocast(BF16, "cpu"):
        out = attn(x, x, mask=mask)
        v = attn.value(x[0]).reshape(5, 4, 4)
        want = attn.out(v.float().mean(0).reshape(1, 16).to(BF16))
    assert out.dtype == BF16
    np.testing.assert_allclose(out[0, 2].float().detach().numpy(),
                               want[0].float().detach().numpy(), rtol=0, atol=1e-2)
    assert torch.isfinite(out).all()
