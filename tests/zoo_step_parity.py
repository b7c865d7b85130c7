"""The zoo trainer's one-step check against the JAX package's, shared by
`test_torch_zoo_trainer.py` and `test_torch_zoo_trainer_steps.py` (the
eleven algos' cases split between the two files, so that neither holds one
test worker for long). The method and tolerances are set out in
`test_torch_zoo_trainer.py`."""

import jax
import numpy as np
import torch
import zoo_parity as zp

from cld_tpu.training import zoo as jax_zoo
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.training import zoo
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

ALGOS = ["bc", "bc_gc", "vae", "discrete_vae", "TransformerPred", "tree_vae",
         "agent_predictor", "bc_ec", "spatial_planner", "occupancy", "diff"]
DRAWING = {"vae", "discrete_vae", "tree_vae", "diff"}
STEP = 5  # the JAX trainer's state.step, folded into its rng


def smoke_config(get):
    cfg = get("cld_smoke").unlock()
    cfg.env.rasterizer.raster_size = zp.RASTER
    return cfg.lock()


def port_noise(name, d):
    """The JAX draws as the port's explicit `noise` of algo `name`."""
    if name == "vae":
        return {"noise": d["normal"][0]}
    if name == "discrete_vae":
        return {"uniform": d["uniform"][0]}
    if name == "tree_vae":
        return {"noise": np.stack(d["normal"])}
    if name == "diff":
        return {"t": d["randint"][0], "noise": d["normal"][0], "drop": d["bernoulli"][0]}
    return {}


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])


def train_grad_keys(model):
    return [k for k, _ in model.named_parameters() if "bias_hh" not in k
            and not k.endswith(zp.ZERO_IN_EXACT)]


def one_zoo_step_matches_jax(name, monkeypatch):
    """Loss, gradients and BatchNorm statistics of one step of algo `name`,
    in eval mode and through `ZooTrainer.train_step`, from the same weights
    and draws."""
    jcfg = smoke_config(jax_registry.get_registered_experiment_config)
    cfg = smoke_config(registry.get_registered_experiment_config)
    jb, tb = zp.batches()
    spec = jax_zoo.algo_factory(jcfg, name)
    v = zp.random_variables(spec["model"], jb, rngs=spec["init_rngs"])
    step_rng = jax.random.fold_in(jax.random.key(11), STEP)

    noise = {}
    if name in DRAWING:
        drawn = zp.record_draws(monkeypatch, lambda: spec["loss_call"](v, jb, step_rng, True))
        noise = {k: torch.as_tensor(a) for k, a in port_noise(name, drawn).items()}

    def loss_fn(params, train):
        loss, metrics, mut = spec["loss_call"](dict(v, params=params), jb, step_rng, train)
        return loss, (metrics, mut)

    @jax.jit
    def both(params):
        return (jax.value_and_grad(lambda p: loss_fn(p, True), has_aux=True)(params),
                jax.value_and_grad(lambda p: loss_fn(p, False)[0])(params))

    ((loss, (metrics, mut)), grads), (eval_loss, eval_grads) = both(v["params"])
    stats = v.get("batch_stats")

    trainer = zoo.ZooTrainer(cfg, name, device="cpu")
    # the converter's keys and shapes are the port module's state dict's
    model = trainer.spec.build()
    converted = tw.export_flax(model, v["params"], stats)
    assert {k: tuple(a.shape) for k, a in converted.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    # eval mode, every gradient tight: the JAX call draws the same values from
    # the same key (the discrete CVAE draws none)
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    loss_e, _ = trainer.spec.loss_call(state.model, tb, False, noise)
    loss_e.backward()
    zp.assert_close(float(loss_e), float(eval_loss), rtol=1e-5, floor=0)
    zp.assert_grads_close(state.model, tw.export_flax(state.model, zp.np_tree(eval_grads), stats))

    # one train step; its gradients against JAX's within twice the port's own
    # float32 error on this problem (the same step in float64)
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    captured = {}

    def capture(opt, args, kwargs):
        captured.update({k: p.grad.numpy().copy() for k, p in state.model.named_parameters()})

    state.optimizer.register_step_pre_hook(capture)
    state, got = trainer.train_step(state, tb, noise=noise)
    assert state.step == 1 and got["skipped_nonfinite"] == 0.0
    assert set(got) - {"skipped_nonfinite"} == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, err_msg=k)
    keys = train_grad_keys(state.model)
    want = _flat(tw.export_flax(state.model, zp.np_tree(grads), stats), keys)
    m64 = tw.load_flax(trainer.spec.build(), v).double()
    for mod in m64.modules():  # the time embedding is float32 by definition
        if isinstance(mod, torch.nn.Linear):
            mod.register_forward_pre_hook(lambda _, args: tuple(a.double() for a in args))
    f64 = {k: (t.double() if t.is_floating_point() else t) for k, t in noise.items()}
    trainer.spec.loss_call(m64, zp.to_double(tb), True, f64)[0].backward()
    exact = _flat({k: p.grad.numpy() for k, p in m64.named_parameters()}, keys)
    got32 = _flat(captured, keys)
    err_jax = np.linalg.norm(got32 - want) / np.linalg.norm(exact)
    err_f32 = np.linalg.norm(got32 - exact) / np.linalg.norm(exact)
    assert err_jax <= 2 * err_f32 + 1e-5, (err_jax, err_f32)

    moved = tw.export_flax(state.model, v["params"], zp.np_tree(mut) if mut is not None else {})
    sd = state.model.state_dict()
    n_bn = 0
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            zp.assert_close(sd[k].numpy(), moved[k], rtol=1e-5, floor=1e-5, msg=k)
            n_bn += 1
    assert (n_bn > 0) == (mut is not None)
