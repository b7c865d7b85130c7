"""The policy composers (`eval/composers.py`), the rollout CLI's
`--composer` / `--composer-ckpt` / `--render`, and rendering
(`viz/render.py`), against the JAX package.

The world is the JAX composer test's: `cld_smoke`, one scene of 2 agents,
raster 64, 20 frames. Both sides act on one observation (the JAX
renderer's). One composer per family is held against the JAX one, from the
same weights (seeded flax variables, carried to the port with
`utils.weights.load_flax` and into the port's composer as a `ckpt_final`
file; the JAX composer restores them) and the JAX side's own draws; the other
composers are aliases, held against their targets. The 24 JAX composers are
not rebuilt here (their own test does that).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp
from flax.training import train_state

import cld_tpu.policies.contingency as jcontingency
import cld_tpu.training.checkpoints as jckpt
from cld_tpu.algos import diffuser as jdiffuser
from cld_tpu.data.scene_batch import synthetic_scene_batch as jax_scene_batch
from cld_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from cld_tpu.eval import composers as jcomp
from cld_tpu.models.bc import BCPlanner as JBC
from cld_tpu.models.context import ContextEncoder as JContext
from cld_tpu.models.cvae import TrajectoryCVAE as JCVAE
from cld_tpu.models.discrete_cvae import DiscreteTrajectoryCVAE as JDCVAE
from cld_tpu.models.gan import TrajectoryGAN as JGAN
from cld_tpu.models.temporal_unet import TemporalMapUnet as JUnet
from cld_tpu.sim import env as jenv
from cld_tpu.sim import scene as jscene
from cld_tpu.training import scene_dm as jsdm
from cld_tpu.utils import registry as jax_registry
from cld_tpu.viz import render as jrender
from cld_tpu_torch import rollout
from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.data.synthetic import synthetic_batch
from cld_tpu_torch.eval import composers
from cld_tpu_torch.models.bc import BCPlanner
from cld_tpu_torch.models.context import ContextEncoder
from cld_tpu_torch.models.cvae import TrajectoryCVAE
from cld_tpu_torch.models.discrete_cvae import DiscreteTrajectoryCVAE
from cld_tpu_torch.models.gan import TrajectoryGAN
from cld_tpu_torch.models.temporal_unet import TemporalMapUnet
from cld_tpu_torch.policies.planner import LatticePlannerConfig, lattice_planner_policy
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.training.checkpoints import save_pytree
from cld_tpu_torch.training.scene_dm import SceneDMTrainer
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils.weights import load_flax
from cld_tpu_torch.viz import render

torch.set_num_threads(2)
STEPS = 20
SIM = dict(num_simulation_steps=STEPS, n_step_action=5, raster_size=64)


@pytest.fixture(scope="module")
def world():
    """(JAX cfg, pack, sim config, observation; the port's the same), the
    port's observation the JAX one's arrays."""
    cfg_j = jax_registry.get_registered_experiment_config("cld_smoke")
    cfg_t = registry.get_registered_experiment_config("cld_smoke")
    kw = dict(seed=0, num_scenes=1, agents_per_scene=2, sim_steps=STEPS)
    pack_j = jscene.synthetic_scene_pack(**kw)
    pack_t = tscene.synthetic_scene_pack(**kw, device="cpu")
    sim_j = jenv.SimConfig(**SIM, hist_frames=cfg_j.algo.history_num_frames)
    sim_t = tenv.SimConfig(**SIM, hist_frames=cfg_t.algo.history_num_frames)
    obs_j = jax.jit(lambda: jenv.render_observation(pack_j, jenv.init_sim_state(pack_j, sim_j),
                                                    sim_j))()
    obs_t = TrafficBatch(**{k: None if v is None else torch.from_numpy(np.array(v))
                            for k, v in obs_j._asdict().items()})
    return cfg_j, pack_j, sim_j, obs_j, cfg_t, pack_t, sim_t, obs_t


def gen(seed):
    return torch.Generator().manual_seed(seed)


def build(name, world, ckpts=None, seed=1):
    cfg_t, pack_t, sim_t = world[4:7]
    return composers.get_composer(name)(cfg_t, pack_t, sim_t, ckpts=ckpts, generator=gen(seed),
                                        device="cpu")


def test_registry_matches_the_jax_one():
    assert sorted(composers.COMPOSER_REGISTRY) == sorted(jcomp.COMPOSER_REGISTRY)
    assert len(composers.COMPOSER_REGISTRY) == 24
    with pytest.raises(KeyError, match="NoSuchComposer"):
        composers.get_composer("NoSuchComposer")


@pytest.mark.parametrize("name", sorted(jcomp.COMPOSER_REGISTRY))
def test_every_composer_builds_and_acts(name, world):
    """Each composer's action for the 2 agents: positions [2, T, 2] and yaws,
    finite; controls finite where there are any. GroundTruth and
    GroundTruthNaN have none, as in the JAX package."""
    obs = world[7]
    act = build(name, world)(obs, gen(2))
    assert act.positions.ndim == 3 and act.positions.shape[0] == 2
    assert act.positions.shape[-1] == 2 and act.yaws.shape == act.positions.shape[:2] + (1,)
    assert torch.isfinite(act.positions).all() and torch.isfinite(act.yaws).all()
    if name in ("GroundTruth", "GroundTruthNaN"):
        assert act.controls is None
    else:
        assert act.controls.shape == act.positions.shape
        assert torch.isfinite(act.controls).all()


ALIASES = [("HierarchicalSample", "Hierarchical"), ("HierarchicalSampleNew", "Hierarchical"),
           ("HAASplineSampling", "HierAgentAware"), ("GuidedHAAMPC", "HierAgentAwareMPC"),
           ("TreeContingency", "AgentAwareEC"), ("STRIVE", "TrafficSim"),
           ("HierAgentAwareCVAE", "TrafficSimplan"), ("GroundTruthNaN", "GroundTruth")]


@pytest.mark.parametrize("alias,target", ALIASES)
def test_aliases_act_as_their_targets(alias, target, world):
    """From the same seeds an alias returns its target's action, bit for
    bit; HierAgentAware is the lattice planner itself."""
    obs = world[7]
    a, b = build(alias, world)(obs, gen(2)), build(target, world)(obs, gen(2))
    for x, y in zip(a, b):
        assert (x is None and y is None) or torch.equal(x, y)
    if target == "HierAgentAware":
        cfg_t, sim_t = world[4], world[6]
        lattice = lattice_planner_policy(LatticePlannerConfig(
            horizon=cfg_t.algo.horizon, dt=sim_t.dt, dyn=sim_t.dyn))(obs, None)
        assert all(torch.equal(x, y) for x, y in zip(b, lattice))


# -- against the JAX composers ----------------------------------------------------


def _diffuser_draws(key, n, shape):
    """`RawActionDiffuser.sample`'s draws under `key` (one split for x_init,
    one key per step) and `scene_sample`'s (the same schedule)."""
    rng, init_rng = jax.random.split(key)
    x = jax.random.normal(init_rng, shape, jnp.float32)
    steps = [jax.random.normal(k, shape, jnp.float32) for k in jax.random.split(rng, n)]
    return torch.from_numpy(np.array(x)), torch.from_numpy(np.stack(steps))


def _carry(port_module, variables, path):
    """Load flax variables into the port module and write them as a trainer's
    `ckpt_final` would."""
    load_flax(port_module, variables)
    save_pytree(str(path), {"params": port_module.state_dict()})
    return str(path)


FAMILIES = ["GroundTruthNaN", "BC", "TrafficSimplan", "TPPplan", "GANplan", "Diffuser",
            "DSPolicy", "SceneDiffuser"]


@pytest.mark.parametrize("name", FAMILIES)
def test_composer_family_matches_jax(name, world, tmp_path, monkeypatch):
    """One composer per family against the JAX one: GroundTruthNaN's NaN
    pattern exactly (none: the ground truth has no controls) and both
    simulators refuse it; BC within 1e-5; TrafficSimplan, TPPplan and GANplan
    the same selected sample and actions within 1e-5; Diffuser, DSPolicy and
    SceneDiffuser within 1e-4 (relative, plus that of the largest entry)."""
    cfg_j, pack_j, sim_j, obs_j, cfg_t, pack_t, sim_t, obs_t = world
    algo = cfg_j.algo
    key = jax.random.key(7)
    restored = {}
    monkeypatch.setattr(jckpt, "restore_pytree", lambda path, like=None: restored[path])
    picks = {"jax": [], "port": []}
    if name.endswith("plan"):
        ego = jcontingency.ego_sample_planning
        monkeypatch.setattr(jcontingency, "ego_sample_planning",
                            lambda *a, **k: picks["jax"].append(ego(*a, **k)) or picks["jax"][-1])
        select = composers.select_sample
        monkeypatch.setattr(composers, "select_sample",
                            lambda *a: picks["port"].append(select(*a)) or picks["port"][-1])
    dims_j = dict(horizon=algo.horizon, dt=algo.step_time, cond_feat_dim=algo.cond_feat_dim,
                  map_arch=algo.map_encoder_model_arch)
    dims_t = dict(dims_j, raster_channels=obs_t.image.shape[-1])
    ckpts = {}
    sampled = dict(rngs=("params", "sample"), train=False)
    if name == "BC":
        v = zp.random_variables(JBC(**dims_j), obs_j)
        ckpts["policy"] = _carry(BCPlanner(**dims_t), v, tmp_path / "policy")
    elif name == "TrafficSimplan":
        v = zp.random_variables(JCVAE(**dims_j), obs_j, **sampled)
        ckpts["policy"] = _carry(TrajectoryCVAE(**dims_t), v, tmp_path / "policy")
    elif name == "TPPplan":
        v = zp.random_variables(JDCVAE(**dims_j), obs_j, **sampled)
        ckpts["policy"] = _carry(DiscreteTrajectoryCVAE(**dims_t), v, tmp_path / "policy")
    elif name == "GANplan":
        v = zp.random_variables(JGAN(**dims_j), obs_j, **sampled)
        ckpts["policy"] = _carry(TrajectoryGAN(**dims_t), v, tmp_path / "policy")
    elif name in ("Diffuser", "DSPolicy"):
        enc = JContext(curr_state_feat_dim=algo.curr_state_feat_dim,
                       map_feature_dim=algo.map_feature_dim, cond_feat_dim=algo.cond_feat_dim,
                       map_arch=algo.map_encoder_model_arch)
        v = zp.random_variables(enc, obs_j)
        ckpts["encoder"] = _carry(ContextEncoder(
            obs_t.image.shape[-1], algo.curr_state_feat_dim, algo.map_feature_dim,
            algo.cond_feat_dim, algo.map_encoder_model_arch), v, tmp_path / "encoder")
        restored["encoder"] = v
        net = JUnet(transition_dim=6, output_dim=2, dim=algo.base_dim, dim_mults=(2, 4, 8))
        v = zp.random_variables(net, jnp.zeros((1, algo.horizon, 6)),
                                jnp.zeros((1, algo.cond_feat_dim)), jnp.zeros((1,), jnp.int32))
        ckpts["policy"] = _carry(TemporalMapUnet(6, 2, algo.cond_feat_dim, algo.base_dim,
                                                 (2, 4, 8)), v, tmp_path / "policy")
    elif name == "SceneDiffuser":
        jtr = jsdm.SceneDMTrainer(cfg_j)
        sample = jax_scene_batch(seed=0, batch_size=1, num_agents=2,
                                 hist_frames=algo.history_num_frames,
                                 horizon=algo.future_num_frames)
        v = zp.random_variables(jtr.model, sample, jnp.zeros((1, 2, algo.future_num_frames, 6)),
                                jnp.zeros((1,), jnp.int32))
        v = {"params": v["params"]}
        monkeypatch.setattr(jsdm.SceneDMTrainer, "init_state", lambda self, rng, batch:
                            train_state.TrainState.create(apply_fn=self.model.apply,
                                                          params=v["params"], tx=self.optimizer))
        ckpts["policy"] = _carry(SceneDMTrainer(cfg_t, device="cpu").build(), v,
                                 tmp_path / "policy")
    if "policy" in ckpts:
        restored["policy"] = v
    # the JAX composers' checkpoint path without their init compiles: a
    # checkpointed model's variables are the restored ones
    monkeypatch.setattr(jcomp, "_init_or_restore", lambda model, obs, rng, ckpt, rngs=None,
                        **kw: restored[ckpt])

    def jax_composer():
        return jcomp.get_composer(name)(cfg_j, pack_j, sim_j, ckpts={k: k for k in ckpts},
                                        rng=jax.random.key(0))

    def jax_side(variables, o, k):
        """Built and run in one compile, the weights arguments (closed over,
        XLA would fold them as constants); the selection's index comes out
        with the action."""
        restored.update(variables)
        return jax_composer()(o, k), picks["jax"][-1] if picks["jax"] else None

    variables = dict(restored)
    if name in ("TrafficSimplan", "GANplan"):  # flax's "sample" stream: record its draws
        drawn, (want, jidx) = zp.record_draws(monkeypatch, jax_side, variables, obs_j, key,
                                              keep_output=True)
        normals = drawn["normal"]
    else:
        (want, jidx), normals = jax.jit(jax_side)(variables, obs_j, key), []
    policy = build(name, world, ckpts=ckpts, seed=0)

    if name == "GroundTruthNaN":
        got = policy(obs_t, gen(2))
        assert want.controls is None and got.controls is None
        np.testing.assert_array_equal(np.isnan(got.positions.numpy()),
                                      np.isnan(np.asarray(want.positions)))
        np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
        with pytest.raises(TypeError):
            jenv.simulate(pack_j, jax_composer(), key, sim_j)
        with pytest.raises(TypeError, match="no controls"):
            tenv.simulate(pack_t, policy, sim_t)
        return
    if name in ("TrafficSimplan", "GANplan"):
        assert len(normals) == 1 and normals[0].shape[0] == 2 * 4
        draws = torch.from_numpy(np.array(normals[0]))
    elif name in ("Diffuser", "DSPolicy"):
        draws = _diffuser_draws(key, algo.n_diffusion_steps, (2, algo.horizon, 2))
    elif name == "SceneDiffuser":
        draws = _diffuser_draws(key, algo.n_diffusion_steps, (1, 2, algo.future_num_frames, 6))
    else:
        assert normals == []
        draws = gen(2)
    got = policy(obs_t, draws)
    rtol = 1e-4 if name in ("Diffuser", "DSPolicy", "SceneDiffuser") else 1e-5
    for field in ("positions", "yaws", "controls"):
        zp.assert_close(getattr(got, field).numpy(), np.asarray(getattr(want, field)), rtol=rtol,
                        floor=rtol, msg=field)
    if name.endswith("plan"):
        assert len(picks["jax"]) == len(picks["port"]) == 1
        np.testing.assert_array_equal(picks["port"][0].numpy(), np.asarray(jidx))


# -- the rollout CLI --------------------------------------------------------------


def _cli(tmp_path, out, *extra):
    argv = ["--registered-name", "cld_smoke", "--device", "cpu", "--num-scenes", "1",
            "--agents-per-scene", "2", "--num-sim-steps", "10", "--raster-size", "64",
            "--output", str(tmp_path / out), *extra]
    rep = rollout.main(argv)
    with np.load(tmp_path / out / "trajectories.npz") as f:
        return rep, f["trajectories"]


def test_rollout_cli_composer_checkpoint_round_trip_and_render(tmp_path):
    """`--composer BC`: weights fresh from `--seed`; the same weights saved
    with `save_pytree` and given as `--composer-ckpt` give the same log, and
    other weights another log; with `--agents-policy` the composer still
    drives every agent (as in the JAX CLI); `--render` writes each scene's
    PNG and a GIF of 10 // 5 frames."""
    from PIL import Image

    rep, fresh = _cli(tmp_path, "fresh", "--composer", "BC", "--seed", "3")
    assert rep["composer"] == "BC" and np.isfinite(fresh).all() and fresh.shape == (10, 2, 4)
    run = rollout.build(rollout.parse_args(["--registered-name", "cld_smoke", "--device", "cpu",
                                            "--raster-size", "64", "--agents-per-scene", "2"]))
    obs = tenv.render_observation(run.pack, tenv.init_sim_state(run.pack, run.sim_cfg),
                                  run.sim_cfg)
    for seed, name in ((3, "same"), (4, "other")):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = BCPlanner(raster_channels=obs.image.shape[-1], horizon=run.cfg.algo.horizon,
                              dt=run.cfg.algo.step_time, cond_feat_dim=run.cfg.algo.cond_feat_dim,
                              map_arch=run.cfg.algo.map_encoder_model_arch)
        save_pytree(str(tmp_path / f"{name}.ckpt"), {"params": model.state_dict()})
    _, same = _cli(tmp_path, "same", "--composer", "BC", "--seed", "3", "--composer-ckpt",
                   str(tmp_path / "same.ckpt"))
    np.testing.assert_array_equal(same, fresh)
    _, other = _cli(tmp_path, "other", "--composer", "BC", "--seed", "3", "--composer-ckpt",
                    str(tmp_path / "other.ckpt"))
    assert np.abs(other - fresh).max() > 1e-3
    rep, split = _cli(tmp_path, "split", "--composer", "BC", "--seed", "3", "--agents-policy",
                      "lattice", "--render", "--save-every-n-frames", "5")
    np.testing.assert_array_equal(split, fresh)
    assert (tmp_path / "split" / "scene_000.png").stat().st_size > 0
    with Image.open(tmp_path / "split" / "scene_000.gif") as gif:
        assert gif.n_frames == 10 // 5


# -- rendering --------------------------------------------------------------------


def _lines(fig):
    return [line.get_xydata() for ax in fig.axes for line in ax.lines]


def test_renders_plot_the_jax_line_data(world, tmp_path):
    """`render_scene_rollout` and `render_batch_prediction` draw the JAX
    package's lines (xy within 1e-5) from the same log, batch and
    prediction; the GIF has T // stride frames."""
    import matplotlib.pyplot as plt
    from PIL import Image

    pack_j, pack_t = world[1], world[5]
    traj = np.random.default_rng(0).normal(size=(STEPS, 2, 4)).astype(np.float32) * 10
    for upto in (None, 7):
        want = jrender.render_scene_rollout(pack_j, traj, upto_step=upto, figsize=3.0)
        got = render.render_scene_rollout(pack_t, torch.from_numpy(traj), upto_step=upto,
                                          figsize=3.0)
        wl, gl = _lines(want), _lines(got)
        assert len(gl) == len(wl) == 4
        for g, w in zip(gl, wl):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        plt.close("all")
    jb = jax_synthetic_batch(seed=2, batch_size=3, raster_size=64, hist_frames=8)
    tb = synthetic_batch(seed=2, batch_size=3, raster_size=64, hist_frames=8, device="cpu")
    pred = np.asarray(jb.target_positions) + 0.5
    want = jrender.render_batch_prediction(jb, pred, indices=(0, 2))
    got = render.render_batch_prediction(tb, torch.from_numpy(pred), indices=(0, 2),
                                         out_path=str(tmp_path / "pred.png"))
    wl, gl = _lines(want), _lines(got)
    assert len(gl) == len(wl) == 4
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert (tmp_path / "pred.png").stat().st_size > 0
    plt.close("all")
    path = render.save_rollout_gif(pack_t, traj, str(tmp_path / "r.gif"), stride=6, figsize=2.0)
    with Image.open(path) as gif:
        assert gif.n_frames == STEPS // 6


@pytest.mark.parametrize("missing,named", [("matplotlib", "matplotlib"), ("PIL", "Pillow")])
def test_render_names_a_missing_package(missing, named, world, tmp_path, monkeypatch):
    """Without matplotlib (or Pillow, for the GIF) a render raises an
    ImportError that names the package and `--render`."""
    monkeypatch.setitem(sys.modules, missing, None)  # `import <missing>` raises ImportError
    traj = torch.zeros((STEPS, 2, 4))
    with pytest.raises(ImportError) as err:
        if missing == "PIL":
            render.save_rollout_gif(world[5], traj, str(tmp_path / "r.gif"))
        else:
            render.render_scene_rollout(world[5], traj)
    assert named in str(err.value) and "--render" in str(err.value)
