"""Shared fixtures of the zoo parity tests (`test_torch_zoo_models.py`,
`test_torch_zoo_trainer.py`): seeded flax variables without running flax's
initializers, the paired JAX / port batches, the recorder of the JAX
package's random draws, and the tolerance checks."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic
from cld_tpu_torch.data.synthetic import synthetic_batch

RASTER, B, HIST = 40, 3, 8  # raster 40: not a multiple of 32, so the map UNet crops
CHANNELS = HIST + 1 + 3


def np_tree(t):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), t)


def _leaf(path, shape, rng):
    names = [getattr(p, "key", str(p)) for p in path]
    name = names[-1]
    if names[0] == "batch_stats":
        return (rng.uniform(0.5, 1.5, shape) if name == "var"
                else rng.normal(0.0, 0.1, shape)).astype(np.float32)
    if name == "kernel":
        attn_qkv = len(shape) == 3 and names[-2] in ("query", "key", "value")
        fan_in = shape[0] if attn_qkv else math.prod(shape[:-1])
        return (rng.normal(size=shape) / math.sqrt(fan_in)).astype(np.float32)
    if name == "scale":
        return (1.0 + rng.normal(0.0, 0.1, shape)).astype(np.float32)
    if name == "bias":
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return rng.normal(0.0, 0.02, shape).astype(np.float32)  # embeddings, queries


def random_variables(module, *args, seed=0, rngs=("params",), **kwargs):
    """Seeded variables in the layout `module.init(*args)` would give (read
    off `jax.eval_shape`, which traces but computes nothing): kernels
    normal / sqrt(fan_in), biases normal(0, 0.1), norm scales 1 + normal(0,
    0.1), BatchNorm statistics mean normal(0, 0.1) and var in [0.5, 1.5]. Each
    leaf takes the dtype `init` would give it (a parameter a flax module
    creates in a bf16 compute dtype is bf16)."""
    keys = {n: jax.random.key(i) for i, n in enumerate(rngs)}
    shapes = jax.eval_shape(lambda: module.init(keys, *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(p, s.shape, rng).astype(s.dtype), dict(shapes))


def batches(seed=3, image_seed=5, batch_size=B, raster=RASTER):
    """The synthetic batch of both packages with a dense Gaussian raster:
    on the mostly-zero synthetic raster, train-mode BatchNorm divides by
    sqrt(var + eps) of near-constant channels and amplifies rounding."""
    import torch

    image = np.random.default_rng(image_seed).normal(
        size=(batch_size, raster, raster, CHANNELS)).astype(np.float32)
    jb = jax_synthetic(seed=seed, batch_size=batch_size, raster_size=raster, hist_frames=HIST)
    tb = synthetic_batch(seed=seed, batch_size=batch_size, raster_size=raster, hist_frames=HIST,
                         device="cpu")
    return jb._replace(image=jnp.asarray(image)), tb._replace(image=torch.from_numpy(image))


def to_double(batch):
    """A port batch with its floating tensors in float64."""
    import torch

    return batch._replace(**{k: v.double() for k, v in batch._asdict().items()
                             if torch.is_tensor(v) and v.is_floating_point()})


def record_draws(monkeypatch, fn, *args, keep_output=False):
    """The outputs of the `jax.random` samplers that `fn(*args)` calls, by
    sampler name in call order. `fn` is traced once under `jax.jit` with the
    samplers wrapped to keep their outputs, which the compiled function
    returns (XLA drops the rest of `fn`'s work, unless `keep_output`: then
    the result is (draws, fn's output) from the one compile). Pass weights
    and batches as `args`: closed over, they are constants that XLA folds
    through the network at compile time."""
    names = ("normal", "uniform", "randint", "bernoulli")
    seen = []

    def wrap(name, sampler):
        def wrapped(*a, **k):
            out = sampler(*a, **k)
            seen.append((name, out))
            return out
        return wrapped

    with monkeypatch.context() as m:
        for n in names:
            m.setattr(jax.random, n, wrap(n, getattr(jax.random, n)))

        @jax.jit
        def draws(*a):
            seen.clear()
            result = fn(*a)
            return [out for _, out in seen], (result if keep_output else None)

        values, result = draws(*args)
    out = {n: [] for n in names}
    for (name, _), val in zip(seen, values):
        out[name].append(np.asarray(val))
    return (out, result) if keep_output else out


def assert_close(got, want, rtol=1e-5, floor=1e-5, msg=""):
    """rtol plus an absolute floor of `floor` times the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(float(np.abs(want).max()), 1e-3), err_msg=msg)


# gradients that are zero in exact arithmetic, so rounding residue on both
# sides: a bias added to every logit of a softmax (attention keys, the
# spatial-softmax keypoint conv, the EBM's score under InfoNCE) does not
# change it
ZERO_IN_EXACT = ("key.bias", "kp_conv.bias", "score_net.bias")


def assert_grads_close(model, want: dict, rtol=1e-4, floor=1e-5) -> int:
    """Each parameter's `.grad` against the converted JAX gradient of the
    same key, at `rtol` and `floor` of the tensor's largest component. flax
    has one LSTM bias, exported as `bias_ih`: the port's `bias_hh` gradient
    must equal its `bias_ih` one. `ZERO_IN_EXACT` gradients are held at
    `floor` of the model's largest gradient component."""
    params = dict(model.named_parameters())
    scale = max(float(np.abs(want[k]).max()) for k in params if k in want)
    n = 0
    for k, p in params.items():
        g = p.grad.numpy()
        if "bias_hh" in k:
            np.testing.assert_array_equal(g, params[k.replace("bias_hh", "bias_ih")].grad.numpy())
            continue
        if k.endswith(ZERO_IN_EXACT):
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= floor * scale, k
        else:
            assert_close(g, want[k], rtol, floor, msg=k)
        n += 1
    assert n > 0
    return n


def grad_vector(model, keys) -> np.ndarray:
    """The `.grad` of `model`'s parameters `keys`, flat in float64."""
    return np.concatenate([model.get_parameter(k).grad.double().numpy().ravel() for k in keys])


def assert_bf16_twins(loss, loss_jax, loss_f32, grads, grads_jax, grads_f32, what=""):
    """The port at bf16 against the JAX package at bf16 (the "bf16 twins"
    rule, ROADMAP), referred to JAX's own bf16 error: `*_f32` is the same
    computation in float32 (the port's, which the float32 parity tests hold
    to JAX's at 1e-5), the exact value both bf16 computations round away
    from.

    - the loss within the twin tolerance (rtol 2e-3, atol 1e-2) plus twice
      JAX's own bf16 error |loss_jax - loss_f32|;
    - the gradients (flat vectors) within twice JAX's own bf16 error, as
      relative L2 distances to the float32 gradient, plus 1e-3;
    - and the port really at bf16: its gradients at least 1e-4 from float32.

    On the ResNet models at these widths JAX's own bf16 gradient lies at
    cosine 0.990-0.9999 from its float32 one on the CPU, below the absolute
    twin cosine (0.999) that shallower networks meet, so two bf16
    computations can be held only against that error."""
    tol = 2e-3 * abs(loss_jax) + 1e-2 + 2 * abs(loss_jax - loss_f32)
    assert abs(loss - loss_jax) <= tol, (what, loss, loss_jax, loss_f32)
    assert_within_jax_bf16_error(grads, grads_jax, grads_f32, f"{what} gradients")


def assert_within_jax_bf16_error(got, want, exact, what=""):
    """Flat vectors: the port's bf16 `got` within twice JAX's own bf16 error
    (`want` against the float32 `exact`), as relative L2 distances to
    `exact`, plus 1e-3; and `got` at least 1e-4 from `exact` (it is bf16)."""
    got, want, exact = (np.ravel(np.asarray(a, np.float64)) for a in (got, want, exact))
    n = np.linalg.norm(exact)
    dist = np.linalg.norm(got - want) / n
    err_jax = np.linalg.norm(want - exact) / n
    err_port = np.linalg.norm(got - exact) / n
    print(f"{what}: {dist:.3e} from JAX's bf16, JAX's own error {err_jax:.3e}, "
          f"the port's {err_port:.3e}")
    assert err_port > 1e-4, (what, err_port)
    assert dist <= 2 * err_jax + 1e-3, (what, dist, err_jax)
