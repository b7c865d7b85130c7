"""Shared helpers of the GAN and EBM parity tests (`test_torch_gan.py`,
`test_torch_ebm.py`): the `cld_smoke` config at the fixture's raster, the
JAX modules at its widths, the train-step gradient check against the port's
own float32 error, a float64 copy of a port model, gradients by key,
BatchNorm statistics, and an optax transformation that records the
gradients it is given."""

import numpy as np
import optax
import torch
import zoo_parity as zp

from cld_tpu.models.gan import TrajectoryGAN as JGAN
from cld_tpu.models.learned_metric import PermuteEBM as JEBM

STEP = 5  # the JAX GAN trainer's state.step, folded into its rng
W = 32  # the cld_smoke map feature and cond widths


def smoke_config(get):
    cfg = get("cld_smoke").unlock()
    cfg.env.rasterizer.raster_size = zp.RASTER
    return cfg.lock()


def jax_ebm():
    return JEBM(map_feature_dim=W, traj_feature_dim=W, embedding_dim=W)


def jax_gan(arch):
    return JGAN(horizon=52, cond_feat_dim=W, generator_arch=arch)


def _flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])


def assert_train_grads(got32: dict, want: dict, exact: dict, keys):
    """The port's float32 gradients against JAX's within twice (+1e-5) the
    port's own float32 error (its distance to the float64 step)."""
    got, want, exact = _flat(got32, keys), _flat(want, keys), _flat(exact, keys)
    err_jax = np.linalg.norm(got - want) / np.linalg.norm(exact)
    err_f32 = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    print(f"train-step gradients: {err_jax:.3e} from JAX, {err_f32:.3e} from float64")
    assert err_jax <= 2 * err_f32 + 1e-5, (err_jax, err_f32)


def double_model(model):
    """A float64 copy whose Linear layers also take float32 inputs in
    float64 (the positional and time embeddings are float32 by definition)."""
    import copy

    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if isinstance(mod, torch.nn.Linear):
            mod.register_forward_pre_hook(lambda _, args: tuple(a.double() for a in args))
    return m64


def grads_by_key(model, keys=None):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()
            if p.grad is not None and (keys is None or k in keys)}


def bn_stats_close(model, want: dict):
    n = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            zp.assert_close(v.numpy(), want[k], rtol=1e-5, floor=1e-5, msg=k)
            n += 1
    assert n > 0


def recording(tx, sink: list):
    """An optax transformation that appends the gradients it is given to
    `sink` (traced values, returned from the jitted function)."""
    def update(grads, opt_state, params=None):
        sink.append(grads)
        return tx.update(grads, opt_state, params)

    return optax.GradientTransformation(tx.init, update)
