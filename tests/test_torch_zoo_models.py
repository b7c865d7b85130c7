"""The model zoo's modules in the port against the JAX package's, on the same
numpy-made inputs and the same weights (seeded flax variables converted by
`utils.weights.load_flax`): the loss library, the spatial-softmax head,
ResNet-34 / 50 and the keypoint head, `MLPResDenoiser`, the CVAE building
blocks, the sampling paths of the CVAEs, the ROI features, the map UNet, the
spatial planner's supervision and decode, the occupancy metric and the
raw-action diffuser. Each zoo model's loss and gradients are held in
`test_torch_zoo_trainer.py`, through the trainer.

Tolerances: forward values rtol 1e-5, gradients rtol 1e-4, each with a floor
of 1e-5 of the tensor's largest component (f32 sums in two libraries'
orders). Modules run with `train=False` (running BatchNorm statistics);
train-mode BatchNorm, its statistics and gradients are held through the
trainer (`test_torch_zoo_trainer.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp

from cld_tpu.algos import diffuser as jdiff
from cld_tpu.models import cvae_nets as jnets
from cld_tpu.models import map_unet as junet
from cld_tpu.models import occupancy as jocc
from cld_tpu.models import roi_encoder as jroi
from cld_tpu.models import spatial_planner as jsp
from cld_tpu.models.bc import BCPlanner as JBC
from cld_tpu.models.context import ContextEncoder as JContext
from cld_tpu.models.cvae import TrajectoryCVAE as JCVAE
from cld_tpu.models.discrete_cvae import DiscreteTrajectoryCVAE as JDiscrete
from cld_tpu.models.dm_mlp import MLPResDenoiser as JMLPRes
from cld_tpu.models.nets import MLP as JMLP
from cld_tpu.models.spatial_softmax import SpatialSoftmax as JSpatialSoftmax
from cld_tpu.models.tree_vae import TreeTrajectoryVAE as JTree
from cld_tpu.ops import losses as jlosses
from cld_tpu.ops.diffusion import make_schedule as jschedule
from cld_tpu.ops.dynamics import UnicycleParams as JUnicycle
from cld_tpu_torch.algos import diffuser as pdiff
from cld_tpu_torch.models import cvae_nets as pnets
from cld_tpu_torch.models import map_unet as punet
from cld_tpu_torch.models import occupancy as pocc
from cld_tpu_torch.models import roi_encoder as proi
from cld_tpu_torch.models import spatial_planner as psp
from cld_tpu_torch.models.bc import BCPlanner
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.cvae import TrajectoryCVAE
from cld_tpu_torch.models.discrete_cvae import DiscreteTrajectoryCVAE
from cld_tpu_torch.models.dm_mlp import MLPResDenoiser
from cld_tpu_torch.models.nets import MLP
from cld_tpu_torch.models.spatial_softmax import SpatialSoftmax
from cld_tpu_torch.models.tree_vae import TreeTrajectoryVAE
from cld_tpu_torch.ops import losses as plosses
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.ops.dynamics import RECORD_DYNAMICS
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def f32(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.as_tensor(np.asarray(a))


def grads_of(fn_jax, fn_port, *arrays):
    """Value and gradients of a scalar function of numpy arrays, both
    packages: ((jax value, jax grads), (port value, port grads)); the JAX
    side as one compile."""
    jv, jg = jax.jit(jax.value_and_grad(fn_jax, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    pv = fn_port(*ts)
    pv.backward()
    return ((float(jv), [np.asarray(g) for g in jg]),
            (float(pv.detach()), [x.grad.numpy() for x in ts]))


def hold(jres, pres):
    (jv, jg), (pv, pg) = jres, pres
    zp.assert_close(pv, jv, rtol=1e-5, floor=0)
    for g, w in zip(pg, jg):
        zp.assert_close(g, w, rtol=1e-4, floor=1e-5)


def hold_module_grads(model, jax_loss, v, port_loss):
    """The loss of a module and its gradients in every parameter."""
    lj, gj = jax.jit(jax.value_and_grad(jax_loss))(v["params"])
    model.zero_grad()
    lp = port_loss()
    lp.backward()
    zp.assert_close(float(lp.detach()), float(lj), rtol=1e-5, floor=0)
    zp.assert_grads_close(model, tw.export_flax(model, zp.np_tree(gj), v.get("batch_stats")))


# -- 1. the loss library ----------------------------------------------------

B, M, T, D = 4, 3, 6, 2


def _loss_cases():
    """name -> (fn(L, c, *arrays), arrays): `L` is either package's loss
    module, `c` turns a numpy constant into that package's array type."""
    pos = (RNG.uniform(0.2, 1.0, (B, M)) / 3).astype(np.float32)
    avail = np.ones((B, T), np.float32)
    avail[1, 4:] = 0
    avail[2] = 0  # a row with nothing available
    ext = np.float32(np.full((B, 2), 4.0)), np.float32(np.full((B, M, 2), 3.0))
    return {
        "cosine_loss": (lambda L, c, a, b: L.cosine_loss(a, b), [f32(B, 3), f32(B, 3)]),
        "kld_0_1_loss": (lambda L, c, a, b: L.kld_0_1_loss(a, b),
                         [f32(B, 8), f32(B, 8, scale=0.5)]),
        "kld_gaussian_loss": (lambda L, c, a, b, d, e: L.kld_gaussian_loss(a, b, d, e),
                              [f32(B, 8), f32(B, 8, scale=0.5), f32(B, 8), f32(B, 8, scale=0.5)]),
        "kld_discrete": (lambda L, c, a, b: L.kld_discrete(_lsm(a), _lsm(b)),
                         [f32(B, 5), f32(B, 5)]),
        "log_normal": (lambda L, c, x, m, v: L.log_normal(x, m, v * v + 0.5).sum(),
                       [f32(B, D), f32(B, D), f32(B, D)]),
        "log_normal_mixture": (
            lambda L, c, x, m, v: L.log_normal_mixture(x, m, v * v + 0.5).sum(),
            [f32(B, D), f32(B, M, D), f32(B, M, D)]),
        "log_normal_mixture_weighted": (
            lambda L, c, x, m, v: L.log_normal_mixture(x, m, v * v + 0.5, w=c(pos)).sum(),
            [f32(B, D), f32(B, M, D), f32(B, M, D)]),
        "nll_gmm_loss": (lambda L, c, x, m: L.nll_gmm_loss(x, m, None, c(pos)),
                         [f32(B, T * D), f32(B, M, T * D)]),
        "nll_gmm_loss_max": (lambda L, c, x, m: L.nll_gmm_loss(x, m, None, c(pos), mode="max"),
                             [f32(B, T * D), f32(B, M, T * D)]),
        "trajectory_loss": (
            lambda L, c, p, q: L.trajectory_loss(p, q, c(avail), c(np.float32([1, 2]))),
            [f32(B, T, D), f32(B, T, D)]),
        "multimodal_trajectory_loss": (
            lambda L, c, p, q: L.multimodal_trajectory_loss(p, q, c(avail), c(pos)),
            [f32(B, M, T, D), f32(B, T, D)]),
        "goal_reaching_loss": (lambda L, c, p, q: L.goal_reaching_loss(p, q, c(avail)),
                               [f32(B, T, D), f32(B, T, D)]),
        "collision_loss": (
            lambda L, c, e, o: L.collision_loss(e, o, c(ext[0]), c(ext[1]),
                                                c(np.ones((B, M, T), np.float32))),
            [f32(B, T, 2, scale=3), f32(B, M, T, 2, scale=3)]),
        "likelihood_loss": (lambda L, c, x: L.likelihood_loss(x), [f32(B, T)]),
        "discriminator_loss": (lambda L, c, a, b: L.discriminator_loss(_sig(a), _sig(b)),
                               [f32(B), f32(B)]),
        "compute_pred_loss_mse": (lambda L, c, p, q: L.compute_pred_loss("MSE", p, q, c(avail)),
                                  [f32(B, M, T, D), f32(B, T, D)]),
        "compute_pred_loss_nll": (lambda L, c, p, q: L.compute_pred_loss("NLL", p, q, c(avail)),
                                  [f32(B, M, T, D), f32(B, T, D)]),
    }


def _lsm(x):
    return torch.log_softmax(x, -1) if torch.is_tensor(x) else jax.nn.log_softmax(x)


def _sig(x):
    return torch.sigmoid(x) if torch.is_tensor(x) else jax.nn.sigmoid(x)


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_library_matches_jax(case):
    """Every function of the loss library (both `log_normal_mixture` weight
    forms, both `nll_gmm_loss` modes, both `compute_pred_loss` types):
    value and gradients in every array argument."""
    fn, arrays = LOSS_CASES[case]
    hold(*grads_of(lambda *xs: fn(jlosses, jnp.asarray, *xs),
                   lambda *xs: fn(plosses, torch.as_tensor, *xs), *arrays))


def test_goal_reaching_loss_picks_jax_index_on_an_all_invalid_row():
    avail = np.zeros((2, 5), np.float32)
    avail[0, :3] = 1
    p, q = f32(2, 5, 2), f32(2, 5, 2)
    want = float(jlosses.goal_reaching_loss(p, q, avail))
    got = float(plosses.goal_reaching_loss(t(p), t(q), t(avail)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(plosses.goal_reaching_loss(t(p[1:]), t(q[1:]), t(avail[1:]))) == 0.0


# -- 2. the spatial-softmax head and the ResNet encoders --------------------

@pytest.mark.parametrize("num_kp,learnable", [(None, False), (8, False), (8, True)])
def test_spatial_softmax_matches_jax(num_kp, learnable):
    x = f32(2, 5, 7, 16)
    m = JSpatialSoftmax(num_kp=num_kp, temperature=0.7, learnable_temperature=learnable)
    v = zp.random_variables(m, x)
    if learnable:
        v["params"]["log_temperature"] = np.float32(np.log(0.7) + 0.1)
    p = tw.load_flax(SpatialSoftmax(16, num_kp, 0.7, learnable), v) if v else \
        SpatialSoftmax(16, num_kp, 0.7, learnable)
    xt = t(x.transpose(0, 3, 1, 2))
    zp.assert_close(p(xt).detach().numpy(), jax.jit(m.apply)(v, x))
    if v:
        hold_module_grads(p, lambda prm: jnp.sum(m.apply({"params": prm}, x) ** 2), v,
                          lambda: torch.sum(p(xt) ** 2))


@pytest.mark.parametrize("arch", ["resnet34", "resnet50", "resnet18_spatial_softmax",
                                  "resnet50_spatial_softmax"])
def test_context_encoder_archs_match_jax(arch):
    """The context encoder over each ResNet arch and head: values, and the
    gradients of the Bottleneck trunk and of the keypoint head (train-mode
    BatchNorm is held through the trainer, on ResNet-18 and the map UNet)."""
    jb, tb = zp.batches(batch_size=2, raster=32)
    m = JContext(cond_feat_dim=16, map_feature_dim=16, curr_state_feat_dim=8, map_arch=arch)
    v = zp.random_variables(m, jb)
    p = tw.load_flax(ContextEncoder(zp.CHANNELS, 8, 16, 16, map_arch=arch), v)
    zp.assert_close(p(tb)["cond_feat"].detach().numpy(),
                    jax.jit(m.apply)(v, jb)["cond_feat"])
    if arch not in ("resnet50", "resnet18_spatial_softmax"):
        return
    hold_module_grads(
        p, lambda prm: jnp.sum(m.apply({"params": prm, "batch_stats": v["batch_stats"]},
                                       jb)["cond_feat"] ** 2), v,
        lambda: torch.sum(p(tb)["cond_feat"] ** 2))


def test_trainers_take_every_arch(tmp_path):
    """`VAETrainer` takes ResNet-50 and the spatial-softmax head, `DMTrainer`
    the residual-MLP denoiser, where they refused before; an unknown arch
    still raises."""
    from cld_tpu_torch.data.synthetic import synthetic_batch
    from cld_tpu_torch.training.dm import DMTrainer
    from cld_tpu_torch.training.vae import VAETrainer
    from cld_tpu_torch.utils.registry import get_registered_experiment_config

    batch = synthetic_batch(seed=0, batch_size=2, raster_size=32, hist_frames=8, device="cpu")
    for arch in ("resnet50", "resnet18_spatial_softmax"):
        cfg = get_registered_experiment_config("cld_smoke").unlock()
        cfg.algo.map_encoder_model_arch = arch
        cfg.algo.diffuser_model_arch = "MLPResNetwork"
        tr = VAETrainer(cfg.lock(), device="cpu")
        st = tr.init_state(0)
        _, m = tr.train_step(st, batch, generator=torch.Generator().manual_seed(0))
        assert np.isfinite(float(m["loss"])) and st.step == 1
        dm = DMTrainer(cfg, st.model, device="cpu")
        dst = dm.init_state(1)
        assert isinstance(dst.model, MLPResDenoiser)
        _, m = dm.train_step(dst, batch, generator=torch.Generator().manual_seed(1))
        assert np.isfinite(float(m["loss"])) and dst.step == 1
    cfg = get_registered_experiment_config("cld_smoke").unlock()
    cfg.algo.map_encoder_model_arch = "resnet101"
    with pytest.raises(ValueError, match="unknown map encoder arch"):
        VAETrainer(cfg.lock(), device="cpu")


def test_mlp_res_denoiser_matches_jax():
    x, c, tt = f32(3, 8, 4), f32(3, 10), np.array([0, 5, 9], np.int32)
    m = JMLPRes(horizon=8, transition_dim=4, width=32, num_blocks=2)
    v = zp.random_variables(m, x, c, tt)
    p = tw.load_flax(MLPResDenoiser(8, 4, 10, width=32, num_blocks=2), v)
    zp.assert_close(p(t(x), t(c), t(tt)).detach().numpy(), jax.jit(m.apply)(v, x, c, tt))
    hold_module_grads(p, lambda prm: jnp.sum(m.apply({"params": prm}, x, c, tt) ** 2), v,
                      lambda: torch.sum(p(t(x), t(c), t(tt)) ** 2))


# -- 3. the CVAE building blocks --------------------------------------------

def _blocks():
    traj, cond = f32(3, 7, 6), f32(3, 12)
    shapes = {"mu": (4,), "logvar": (4,), "grid": (2, 3)}
    # scene 1 has no real agent: the mean's empty scene; the max needs one
    mask = np.array([[True, True, False], [False, False, False], [True, False, True]])
    scene = (f32(3, 3, 5, 6), f32(3, 3, 10), mask)
    scene_max = (scene[0], scene[1], mask | np.eye(3, dtype=bool)[1])
    curr = np.concatenate([f32(3, 2), np.float32([[5.0], [8.0], [3.0]]), f32(3, 1, scale=0.1)], -1)
    return {
        "SplitMLP": (jnets.SplitMLP(shapes, (16,), normalization=True),
                     pnets.SplitMLP(12, shapes, (16,), normalization=True), (cond,)),
        "MIMOMLP": (jnets.MIMOMLP(shapes, (16,)), pnets.MIMOMLP(12 + 42, shapes, (16,)),
                    ({"b": cond, "a": traj},)),
        "RNNTrajectoryEncoder": (jnets.RNNTrajectoryEncoder(24),
                                 pnets.RNNTrajectoryEncoder(6, 24), (traj,)),
        "PosteriorEncoder": (jnets.PosteriorEncoder(shapes, (16,), 24),
                             pnets.PosteriorEncoder(6, 12, shapes, (16,), 24), (traj, cond)),
        "ScenePosteriorEncoder_max": (
            jnets.ScenePosteriorEncoder(shapes, "max", (16,), 14, num_heads=4),
            pnets.ScenePosteriorEncoder(6, 10, shapes, "max", (16,), 14, num_heads=4),
            scene_max),
        "ScenePosteriorEncoder_mean": (
            jnets.ScenePosteriorEncoder(shapes, "mean", (16,), 14, num_heads=4),
            pnets.ScenePosteriorEncoder(6, 10, shapes, "mean", (16,), 14, num_heads=4), scene),
        "ConditionNet": (jnets.ConditionNet(9, (16,)), pnets.ConditionNet(12 + 42, 9, (16,)),
                         ({"x": traj, "c": cond},)),
        "ConditionDecoder": (jnets.ConditionDecoder(JMLP(5, (8,))),
                             pnets.ConditionDecoder(MLP(16, 5, (8,))), (f32(3, 4), cond)),
        "MLPTrajectoryDecoder": (
            jnets.MLPTrajectoryDecoder(horizon=7, layer_dims=(16,)),
            pnets.MLPTrajectoryDecoder(12, 7, layer_dims=(16,)), (cond, curr)),
        "MLPTrajectoryDecoder_states": (
            jnets.MLPTrajectoryDecoder(horizon=7, layer_dims=(16,), use_dynamics=False),
            pnets.MLPTrajectoryDecoder(12, 7, layer_dims=(16,), use_dynamics=False), (cond,)),
    }


BLOCKS = _blocks()


def _to_port(a):
    if isinstance(a, dict):
        return {k: t(x) for k, x in a.items()}
    return t(a)


def _sum_sq(out):
    leaves = jax.tree.leaves(out)
    if isinstance(leaves[0], torch.Tensor):
        return sum(torch.sum(x ** 2) for x in leaves)
    return sum(jnp.sum(x ** 2) for x in leaves)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_cvae_building_blocks_match_jax(name):
    """Values and gradients. ScenePosteriorEncoder's masked agents attend
    to no key (flax's masked logits take float32's minimum, so their row
    averages uniformly where -inf would give NaN); the mean aggregation has a
    scene with no real agent."""
    jm, pm, args = BLOCKS[name]
    v = zp.random_variables(jm, *args)
    tw.load_flax(pm, v)
    targs = [_to_port(a) for a in args]
    want, got = jax.jit(jm.apply)(v, *args), pm(*targs)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.isfinite(g.detach().numpy()).all()
        zp.assert_close(g.detach().numpy(), w)
    hold_module_grads(pm, lambda prm: _sum_sq(jm.apply({"params": prm}, *args)), v,
                      lambda: _sum_sq(pm(*targs)))


# -- 4. the zoo models' other paths -------------------------------------------

def _small():
    jb, tb = zp.batches(batch_size=2, raster=32)
    return jb, tb


def test_cvae_and_discrete_cvae_sampling_match_jax(monkeypatch):
    """`TrajectoryCVAE.sample` from the JAX side's prior draws, and the
    discrete CVAE's decode of every mode (its Gumbel path: the trainer
    test's `discrete_vae` step)."""
    jb, tb = _small()
    m = JCVAE(horizon=52, cond_feat_dim=16)
    v = zp.random_variables(m, jb, rngs=("params", "sample"))
    p = tw.load_flax(TrajectoryCVAE(zp.CHANNELS, 52, cond_feat_dim=16), v)
    rng = jax.random.key(4)
    # one compile each, the weights, batch and key as arguments (closed over,
    # XLA folds them through the network as constants)
    drawn, want = zp.record_draws(
        monkeypatch, lambda v, jb, rng: m.apply(v, jb, 3, method="sample", rngs={"sample": rng}),
        v, jb, rng, keep_output=True)
    z = drawn["normal"][0]
    zp.assert_close(p.sample(tb, 3, z=t(z)).detach().numpy(), want, floor=1e-5)

    md = JDiscrete(horizon=52, cond_feat_dim=16, num_modes=4)
    vd = zp.random_variables(md, jb, rngs=("params", "sample"))
    pd = tw.load_flax(DiscreteTrajectoryCVAE(zp.CHANNELS, 52, 4, cond_feat_dim=16), vd)
    zp.assert_close(pd.sample_modes(tb).detach().numpy(),
                    jax.jit(lambda vd, jb: md.apply(vd, jb, method="sample_modes"))(vd, jb),
                    floor=1e-5)


def test_tree_vae_sampling_and_ego_conditioning_match_jax(monkeypatch):
    jb, tb = _small()
    plan = f32(2, 52, 2)
    m = JTree(cond_feat_dim=16)
    v = zp.random_variables(m, jb, cond_traj=jnp.asarray(plan), rngs=("params", "sample"))
    p = tw.load_flax(TreeTrajectoryVAE(zp.CHANNELS, cond_feat_dim=16, ec_traj_dim=2), v)
    rng = jax.random.key(2)

    # one compile each, the weights, batch, plan and key as arguments
    def sample(v, jb, plan, rng):
        return m.apply(v, jb, 3, plan, method="sample", rngs={"sample": rng})

    def forward(v, jb, plan, rng):
        return m.apply(v, jb, cond_traj=plan, rngs={"sample": rng})

    args = (v, jb, jnp.asarray(plan), rng)
    drawn, sampled = zp.record_draws(monkeypatch, sample, *args, keep_output=True)
    z = np.stack(drawn["normal"])
    zp.assert_close(p.sample(tb, 3, t(plan), z=t(z)).detach().numpy(), sampled, floor=1e-5)
    drawn, want = zp.record_draws(monkeypatch, forward, *args, keep_output=True)
    noise = np.stack(drawn["normal"])
    got = p(tb, cond_traj=t(plan), noise=t(noise))
    for k in ("loss", "trajectories"):
        zp.assert_close(got[k].detach().numpy(), want[k], floor=1e-5, msg=k)


def test_bc_with_a_given_goal_matches_jax():
    jb, tb = _small()
    goal = np.float32([[20.0, 1.0, 0.1], [15.0, -2.0, -0.2]])
    m = JBC(horizon=52, cond_feat_dim=16, goal_conditional=True)
    v = zp.random_variables(m, jb)
    p = tw.load_flax(BCPlanner(zp.CHANNELS, 52, 16, goal_conditional=True), v)
    want = jax.jit(lambda v, jb, goal: m.apply(v, jb, goal=goal))(v, jb, jnp.asarray(goal))
    zp.assert_close(p(tb, goal=t(goal))["trajectories"].detach().numpy(), want["trajectories"],
                    floor=1e-5)


# -- 5. ROI features --------------------------------------------------------

def test_query_feature_grid_and_rotated_roi_crop_match_jax():
    grid = f32(2, 9, 11, 5)
    inside = np.stack([RNG.uniform(0.3, 9.5, (2, 30)), RNG.uniform(0.3, 7.5, (2, 30))],
                      -1).astype(np.float32)
    hold(*grads_of(lambda p, g: jnp.sum(jroi.query_feature_grid(p, g) ** 2),
                   lambda p, g: torch.sum(proi.query_feature_grid(p, g) ** 2), inside, grid))
    outside = np.float32([[[-3.0, 2.5], [40.0, 1.2], [4.2, 99.0]]] * 2)
    zp.assert_close(proi.query_feature_grid(t(outside), t(grid)).numpy(),
                    jroi.query_feature_grid(outside, grid))
    center, yaw = inside[:, :4] * 0.5 + 2.0, f32(2, 4)
    zp.assert_close(proi.rotated_roi_crop(t(grid), t(center), t(yaw), (5, 3), 6.0).numpy(),
                    jroi.rotated_roi_crop(grid, center, yaw, (5, 3), 6.0))


def test_roi_map_encoder_matches_jax():
    image = f32(2, 32, 32, zp.CHANNELS)
    centers, yaws = RNG.uniform(6, 26, (2, 5, 2)).astype(np.float32), f32(2, 5)
    m = jroi.ROIMapEncoder(agent_feature_dim=12)
    v = zp.random_variables(m, image, centers, yaws)
    p = tw.load_flax(proi.ROIMapEncoder(zp.CHANNELS, agent_feature_dim=12), v)
    args = (t(image), t(centers), t(yaws))
    zp.assert_close(p(*args).detach().numpy(), jax.jit(m.apply)(v, image, centers, yaws))
    hold_module_grads(p, lambda prm: jnp.sum(m.apply({"params": prm}, image, centers, yaws) ** 2),
                      v, lambda: torch.sum(p(*args) ** 2))


# -- 6. the map UNet, the spatial planner and the occupancy metric ----------

@pytest.mark.parametrize("arch,raster", [("resnet18", 40), ("resnet50", 40), ("resnet18", 64)])
def test_map_unet_matches_jax(arch, raster):
    """Values, and ResNet-18's gradients at raster 40, where the decoder
    crops at two skips and at the end (train-mode BatchNorm: the trainer
    test's spatial planner and occupancy steps)."""
    image = f32(2, raster, raster, zp.CHANNELS)
    m = junet.RasterizedMapUNet(arch=arch, output_channels=3)
    v = zp.random_variables(m, image)
    p = tw.load_flax(punet.RasterizedMapUNet(arch, zp.CHANNELS, 3), v)
    zp.assert_close(p(t(image)).detach().numpy(), jax.jit(m.apply)(v, image))
    if (arch, raster) == ("resnet18", 40):
        hold_module_grads(
            p, lambda prm: jnp.sum(m.apply({"params": prm, "batch_stats": v["batch_stats"]},
                                           image) ** 2),
            v, lambda: torch.sum(p(t(image)) ** 2))


def test_spatial_planner_supervision_and_decode_match_jax():
    jb, tb = _small()
    avail = np.ones((2, 52), np.float32)
    avail[0, 30:] = 0
    avail[1] = 0  # no frame available: index 0, as the JAX package's
    jb = jb._replace(target_availabilities=jnp.asarray(avail))
    tb = tb._replace(target_availabilities=t(avail))
    np.testing.assert_array_equal(psp.last_available_index(t(avail)).numpy(),
                                  jsp.last_available_index(avail))
    sup, jsup = psp.get_spatial_goal_supervision(tb), jsp.get_spatial_goal_supervision(jb)
    for k in jsup:
        np.testing.assert_array_equal(sup[k].numpy(), np.asarray(jsup[k]), err_msg=k)
    # a logit map without ties (distinct values), with and without a drivable mask
    pred = f32(2, 32, 32, 4)
    pred[..., 0] = RNG.permutation(2 * 32 * 32).reshape(2, 32, 32).astype(np.float32) / 50
    drivable = (RNG.uniform(size=(2, 32, 32)) > 0.5).astype(np.float32)
    for mask in (None, drivable):
        got = psp.decode_spatial_prediction(t(pred), tb.raster_from_agent,
                                            None if mask is None else t(mask))
        want = jsp.decode_spatial_prediction(pred, jb.raster_from_agent, mask)
        for k in want:
            zp.assert_close(got[k].numpy(), want[k], msg=k)
    hold(*grads_of(lambda x: sum(jsp.spatial_planner_losses(x, jsup).values()),
                   lambda x: sum(psp.spatial_planner_losses(x, sup).values()), pred))


def test_occupancy_supervision_losses_and_likelihood_match_jax():
    jb, tb = _small()
    pred = f32(2, 13, 32, 32)
    sup, jsup = (pocc.get_spatial_trajectory_supervision(tb, 4),
                 jocc.get_spatial_trajectory_supervision(jb, 4))
    for k in jsup:
        np.testing.assert_array_equal(sup[k].numpy(), np.asarray(jsup[k]), err_msg=k)
    hold(*grads_of(lambda x: sum(jocc.occupancy_losses(x, jsup).values()),
                   lambda x: sum(pocc.occupancy_losses(x, sup).values()), pred))
    got = pocc.occupancy_likelihood(t(pred), tb.target_positions, tb.raster_from_agent, 4)
    want = jocc.occupancy_likelihood(pred, jb.target_positions, jb.raster_from_agent, 4)
    for k in want:
        zp.assert_close(got[k].numpy(), want[k], msg=k)


# -- 7. the raw-action diffuser ---------------------------------------------

class _JaxNet:
    """A differentiable stand-in denoiser, the same function in both
    packages: x0 = tanh(traj W + cond V) scaled by the step."""

    def __init__(self, w, v):
        self.w, self.v = w, v

    def __call__(self, traj, cond, tt):
        h = traj @ self.w + (cond @ self.v)[:, None, :]
        return jnp.tanh(h) * (1.0 + tt[:, None, None] / 10.0)


class _TorchNet(_JaxNet):
    def __call__(self, traj, cond, tt):
        h = traj @ t(self.w) + (cond @ t(self.v))[:, None, :]
        return torch.tanh(h) * (1.0 + tt[:, None, None] / 10.0)


def _diffusers(n=10, feat=0):
    w, vv = f32(6 + feat, 2, scale=0.5), f32(5, 2, scale=0.5)
    dyn = JUnicycle(max_steer=0.5, max_yawvel=6.283185307179586, acce_lo=-10.0, acce_hi=8.0)
    return (jdiff.RawActionDiffuser(_JaxNet(w, vv), jschedule(n), dyn),
            pdiff.RawActionDiffuser(_TorchNet(w, vv), make_schedule(n, device="cpu"),
                                    RECORD_DYNAMICS))


def _curr(bn):
    return np.concatenate([f32(bn, 2), RNG.uniform(2, 9, (bn, 1)).astype(np.float32),
                           f32(bn, 1, scale=0.1)], -1)


def test_diffuser_loss_matches_jax(monkeypatch):
    jd, pd = _diffusers()
    gt, curr, cond = f32(4, 8, 6, scale=0.5), _curr(4), f32(4, 5)
    rng = jax.random.key(9)
    drawn = zp.record_draws(monkeypatch, lambda rng, gt, curr, cond: jd.loss(rng, gt, curr, cond,
                                                                            0.5),
                            rng, gt, curr, cond)
    draws = dict(t=t(drawn["randint"][0]), noise=t(drawn["normal"][0]),
                 drop=t(drawn["bernoulli"][0]))
    assert 0 < int(draws["drop"].sum()) < 4  # both branches of the dropout
    hold(*grads_of(lambda c: jd.loss(rng, gt, curr, c, 0.5),
                   lambda c: pd.loss(t(gt), t(curr), c, cond_drop_prob=0.5, **draws), cond))


@pytest.mark.parametrize("guide_clean", [True, False])
def test_diffuser_sample_matches_jax(guide_clean):
    """Sampling with classifier-free guidance, a stationary agent, map
    features and a guidance function; the JAX side's noise from its own key
    schedule (one split for x_init, one key per step)."""
    jd, pd = _diffusers(n=6, feat=3)
    curr, cond = _curr(2), f32(2, 5)
    speed = np.float32([0.2, 5.0])
    grid, gfa = f32(4, 9, 9, 3), np.tile(np.float32([[0.5, 0, 4], [0, 0.5, 4], [0, 0, 1]]),
                                         (4, 1, 1))
    rng = jax.random.key(3)
    rng2, init_rng = jax.random.split(rng)
    x_init = np.asarray(jax.random.normal(init_rng, (4, 7, 2)))
    steps = np.stack([np.asarray(jax.random.normal(k, (4, 7, 2)))
                      for k in jax.random.split(rng2, 6)])

    def jguide(x, tt):
        return x - 0.1 * jnp.sin(x)

    def pguide(x, tt):
        return x - 0.1 * torch.sin(x)

    kw = dict(num_samp=2, class_free_guide_w=0.5, guide_clean=guide_clean)
    want = jd.sample(rng, curr, cond, 7, guidance_fn=jguide,
                     stationary_mask=jdiff.stationary_mask_from_speed(speed),
                     map_grid=grid[:2], grid_from_agent=gfa[:2], **kw)
    got = pd.sample(t(curr), t(cond), 7, guidance_fn=pguide,
                    stationary_mask=pdiff.stationary_mask_from_speed(t(speed)),
                    map_grid=t(grid[:2]), grid_from_agent=t(gfa[:2]), x_init=t(x_init),
                    step_noises=t(steps), **kw)
    for k in want:
        zp.assert_close(got[k].numpy(), want[k], floor=1e-5, msg=k)


def test_diffuser_helpers_match_jax():
    s, js = make_schedule(10, device="cpu"), jschedule(10)
    x, x0, tt = f32(3, 4, 2), f32(3, 4, 2), np.array([0, 4, 9])
    zp.assert_close(pdiff.predict_noise_from_start(s, t(x), t(tt), t(x0)).numpy(),
                    jdiff.predict_noise_from_start(js, x, tt, x0))
    for g, w in zip(pdiff.q_posterior(s, t(x0), t(x), t(tt)), jdiff.q_posterior(js, x0, x, tt)):
        zp.assert_close(g.numpy(), w)
    speed = np.float32([0.0, 0.49, -0.6, 3.0])
    np.testing.assert_array_equal(pdiff.stationary_mask_from_speed(t(speed)).numpy(),
                                  jdiff.stationary_mask_from_speed(speed))
