"""bf16 mixed precision of the GAN, the EBM and the scene diffusion model
against the JAX package's, on the CPU at `train.training.precision =
"bf16"` on both sides, and the composers' precision.

* `SpatialSoftmax` in a bf16 autocast region against the flax module at
  `dtype=bfloat16` on the same bf16 features: float32 keypoints within
  2^-7 (the softmax is bf16 on both sides).
* Both GAN generators (the LSGAN losses d_loss + 3 g_loss), the EBM
  (InfoNCE over the score matrix) and the scene model's loss, each from the
  same seeded weights (`zoo_parity.random_variables`, `utils.weights.load_flax`)
  and the JAX side's own draws (bf16 where flax draws in its compute dtype,
  widened exactly to float32), held by the "bf16 twins" rule referred to
  JAX's own bf16 error (`zoo_parity.assert_bf16_twins`, the exact value
  being the port's float32 on the same weights and draws). The f32
  invariants: the discriminator's logits and the losses are float32, the
  EBM's scores bf16 and InfoNCE float32.
* The scene model: only the denoiser computes in bf16, and its
  `time_pos_emb` is stored in bf16 as the JAX module's is (loaded and
  exported bit for bit); every other parameter, and the conditioning
  encoder's output, is float32. One `SceneDMTrainer` step against the JAX
  trainer's from the same weights and draws: the bf16 `time_pos_emb` and
  its Adam moments after the step.
* The composers: under a bf16 config the 23 composers other than
  `SceneDiffuser` build float32 networks, also from a checkpoint trained
  under bf16; `SceneDiffuser`'s denoiser is bf16.
* `train.main --precision bf16 --device cpu` for `--mode zoo --zoo-algo
  bc`, `gan`, `ebm` and `scene_dm`.

Fixture (`zoo_parity.py`): the `cld_smoke` widths, raster 40, B=3; the
scene model at `test_torch_scene_dm.py`'s widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import zoo_parity as zp
from flax.training import train_state

from cld_tpu.data.scene_batch import synthetic_scene_batch as jax_scene_batch
from cld_tpu.models.gan import TrajectoryGAN as JGAN
from cld_tpu.models.learned_metric import PermuteEBM as JEBM
from cld_tpu.models.learned_metric import ebm_infonce_loss as jax_infonce
from cld_tpu.models.spatial_softmax import SpatialSoftmax as JSpatialSoftmax
from cld_tpu.training import scene_dm as jsdm
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch import train
from cld_tpu_torch.algos.scene_dm import scene_dm_loss
from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
from cld_tpu_torch.eval import composers
from cld_tpu_torch.models.learned_metric import ebm_infonce_loss
from cld_tpu_torch.models.spatial_softmax import SpatialSoftmax
from cld_tpu_torch.ops.diffusion import make_schedule
from cld_tpu_torch.ops.precision import autocast
from cld_tpu_torch.sim import env as tenv
from cld_tpu_torch.sim import scene as tscene
from cld_tpu_torch.training import scene_dm as psdm
from cld_tpu_torch.training.ebm import EBMTrainer
from cld_tpu_torch.training.gan import GANTrainer
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
BF16 = torch.bfloat16
W = 32  # the cld_smoke map feature and cond widths
HIST, HORIZON, NS, A = 4, 16, 2, 4  # the scene model's history, horizon, scenes, agents
SCENE = dict(cond_dim=16, width=32, num_layers=2)
STEP = 5  # the scene trainer's step count before its update: a nonzero rate


def config(get, precision="bf16", **algo):
    cfg = get("cld_smoke").unlock()
    cfg.env.rasterizer.raster_size = zp.RASTER
    cfg.train.training.precision = precision
    for k, val in algo.items():
        setattr(cfg.algo, k, val)
    return cfg.lock()


def scene_config(get, precision="bf16"):
    return config(get, precision, history_num_frames=HIST, future_num_frames=HORIZON,
                  n_diffusion_steps=5, scene_cond_dim=SCENE["cond_dim"],
                  scene_width=SCENE["width"], scene_layers=SCENE["num_layers"])


def f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def flat(grads: dict, keys) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])


def grad_keys(model):
    return [k for k, _ in model.named_parameters() if "bias_hh" not in k]


@pytest.mark.parametrize("num_kp", [None, 8])
def test_spatial_softmax_at_bf16_matches_jax(num_kp):
    x = np.random.default_rng(0).normal(size=(2, 6, 7, 16)).astype(np.float32) * 3
    jm = JSpatialSoftmax(num_kp=num_kp, dtype=jnp.bfloat16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    v = zp.random_variables(jm, xb)
    want = jax.jit(jm.apply)(v, xb)
    port = SpatialSoftmax(16, num_kp)
    if num_kp is not None:
        tw.load_flax(port, v)
    with autocast(BF16, "cpu"):
        got = port(f32(xb).to(BF16).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2**-7)


# -- the GAN and the EBM -------------------------------------------------------


@pytest.mark.parametrize("arch", ["mlp", "transformer"])
def test_gan_at_bf16_is_a_bf16_twin(arch, monkeypatch):
    """d_loss + 3 g_loss from the JAX side's bf16 noise draw; the
    discriminator's logits and both losses are float32."""
    jb, tb = zp.batches()
    jm = JGAN(horizon=52, cond_feat_dim=W, generator_arch=arch, dtype=jnp.bfloat16)
    v = zp.random_variables(jm, jb, rngs=("params", "sample"))

    def jax_side(params, v, jb):
        def loss(p):
            out = jm.apply(dict(v, params=p), jb, rngs={"sample": jax.random.key(3)})
            return out["d_loss"] + 3.0 * out["g_loss"]

        return jax.value_and_grad(loss)(params)

    drawn, (lj, gj) = zp.record_draws(monkeypatch, jax_side, v["params"], v, jb,
                                      keep_output=True)
    assert drawn["normal"][0].dtype == jnp.bfloat16
    z = f32(drawn["normal"][0])
    out = {}
    for precision in ("bf16", "fp32"):
        trainer = GANTrainer(config(registry.get_registered_experiment_config, precision,
                                    gan_generator_arch=arch), device="cpu")
        model = tw.load_flax(trainer.init_state(0).model, v)
        res = model(tb, z)
        loss = res["d_loss"] + 3.0 * res["g_loss"]
        loss.backward()
        out[precision] = (model, res, loss)
    model, res, loss = out["bf16"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert {m.compute_dtype for m in model.modules() if hasattr(m, "compute_dtype")} == {BF16}
    assert all(res[k].dtype == torch.float32 for k in ("d_loss", "g_loss", "d_real_mean"))
    keys = grad_keys(model)
    zp.assert_bf16_twins(float(loss.detach()), float(lj), float(out["fp32"][2].detach()),
                         zp.grad_vector(model, keys),
                         flat(tw.export_flax(model, zp.np_tree(gj), v["batch_stats"]), keys),
                         zp.grad_vector(out["fp32"][0], keys), f"GAN {arch}")


def test_ebm_at_bf16_is_a_bf16_twin():
    """InfoNCE over the bf16 score matrix, in float32; the matched-pair
    scores come out bf16, as the JAX module's."""
    jb, tb = zp.batches()
    jm = JEBM(map_feature_dim=W, traj_feature_dim=W, embedding_dim=W, dtype=jnp.bfloat16)
    v = zp.random_variables(jm, jb)

    @jax.jit
    def jax_side(params, v, jb):
        loss = jax.value_and_grad(lambda p: jax_infonce(jm.apply(dict(v, params=p), jb)["scores"]))
        return loss(params), jm.apply(v, jb, method="get_scores")

    (lj, gj), scores_j = jax_side(v["params"], v, jb)
    assert scores_j.dtype == jnp.bfloat16
    out = {}
    for precision in ("bf16", "fp32"):
        trainer = EBMTrainer(config(registry.get_registered_experiment_config, precision),
                             device="cpu")
        model = tw.load_flax(trainer.init_state(0).model, v)
        scores = model(tb)["scores"]
        loss = ebm_infonce_loss(scores)
        loss.backward()
        out[precision] = (model, scores, loss)
    model, scores, loss = out["bf16"]
    assert scores.dtype == BF16 and loss.dtype == torch.float32
    assert model.get_scores(tb).dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    keys = grad_keys(model)
    zp.assert_bf16_twins(float(loss.detach()), float(lj), float(out["fp32"][2].detach()),
                         zp.grad_vector(model, keys),
                         flat(tw.export_flax(model, zp.np_tree(gj), v["batch_stats"]), keys),
                         zp.grad_vector(out["fp32"][0], keys), "EBM")


# -- the scene diffusion model --------------------------------------------------


@pytest.fixture(scope="module")
def scene_pair():
    """Scene batches of both packages, the JAX `SceneDMModel` at bf16 with
    seeded variables (its `time_pos_emb` leaf bf16), and the port's bf16
    trainer."""
    kw = dict(seed=0, batch_size=NS, num_agents=A, hist_frames=HIST, horizon=HORIZON)
    jb, tb = jax_scene_batch(**kw), synthetic_scene_batch(**kw, device="cpu")
    jm = jsdm.SceneDMModel(**SCENE, dtype=jnp.bfloat16)
    v = zp.random_variables(jm, jb, jnp.zeros((NS, A, HORIZON, 6)), jnp.zeros((NS,), jnp.int32))
    trainer = psdm.SceneDMTrainer(scene_config(registry.get_registered_experiment_config),
                                  device="cpu")
    return jb, tb, jm, v, trainer


def test_scene_model_stores_time_pos_emb_in_bf16_bit_for_bit(scene_pair):
    """Only the denoiser is bf16, and of its parameters only `time_pos_emb`
    is stored in bf16; the flax leaf loads and exports with its bits."""
    jb, tb, jm, v, trainer = scene_pair
    leaf = v["params"]["denoiser"]["time_pos_emb"]
    assert leaf.dtype == jnp.bfloat16
    model = trainer.init_state(0).model
    assert model.denoiser.compute_dtype == BF16 and trainer.compute_dtype == BF16
    assert not any(hasattr(m, "compute_dtype") for m in model.cond_encoder.modules())
    tw.load_flax(model, v)
    for k, p in model.named_parameters():
        assert p.dtype == (BF16 if k == "denoiser.time_pos_emb" else torch.float32), k
    got = model.denoiser.time_pos_emb.detach()
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(leaf).view(np.uint16))
    exported = tw.export_flax(model, v["params"])["denoiser.time_pos_emb"]
    assert exported.dtype == leaf.dtype and np.array_equal(exported.view(np.uint16),
                                                           np.asarray(leaf).view(np.uint16))
    with torch.no_grad():
        cond = model.encode_cond(tb)
        eps = model.denoise(torch.zeros(NS, A, HORIZON, 6), cond, torch.zeros(NS).long(),
                            tb.agent_mask)
    assert cond.dtype == torch.float32 and eps.dtype == BF16


def test_scene_dm_step_at_bf16_matches_jax(scene_pair, monkeypatch):
    """One trainer step at step `STEP` (a nonzero rate) from the same weights
    and the JAX step's own draws, from one JAX compile: the masked epsilon
    MSE and its gradients (read off the JAX optimizer) as bf16 twins; then
    `time_pos_emb` after the update, bf16 with bf16 Adam moments. Adam's
    first update moves an element by the rate times the sign of its
    gradient, rounded to bf16: the two packages agree bit for bit on at
    least 98% of the elements, and the others lie within one ulp of the
    element (a rounding) plus twice the rate (a gradient of rounding size
    whose sign differs)."""
    jb, tb, jm, v, trainer = scene_pair
    jtr = jsdm.SceneDMTrainer(scene_config(jax_registry.get_registered_experiment_config))
    sink = []
    tx = jtr.optimizer

    def record(grads, opt_state, params=None):
        sink.append(grads)
        return tx.update(grads, opt_state, params)

    jstate = train_state.TrainState.create(apply_fn=jtr.model.apply, params=v["params"],
                                           tx=optax.GradientTransformation(tx.init, record))
    # the rate schedule's own count (the last state of the chain) at STEP; Adam's at 0
    opt = list(jstate.opt_state)
    opt[-1] = opt[-1]._replace(count=jnp.asarray(STEP, jnp.int32))
    jstate = jstate.replace(step=STEP, opt_state=tuple(opt))

    def jax_side(jstate, jb):
        sink.clear()
        return jtr._train_step(jstate, jb, jax.random.key(5)), sink[0]

    drawn, ((new_j, mj), gj) = zp.record_draws(monkeypatch, jax_side, jstate, jb,
                                               keep_output=True)
    noise = (f32(drawn["randint"][0]).long(), f32(drawn["normal"][0]))
    out = {}
    for precision, tr in (("bf16", trainer), ("fp32", psdm.SceneDMTrainer(
            scene_config(registry.get_registered_experiment_config, "fp32"), device="cpu"))):
        model = tw.load_flax(tr.init_state(0).model, v)
        loss = scene_dm_loss(model.denoise, make_schedule(5, device="cpu"),
                             psdm.scene_gt_trajectories(tb), model.encode_cond(tb),
                             tb.agent_mask, *noise)
        loss.backward()
        out[precision] = (model, loss)
    model, loss = out["bf16"]
    keys = grad_keys(model)
    zp.assert_bf16_twins(float(loss.detach()), float(mj["loss"]), float(out["fp32"][1].detach()),
                         zp.grad_vector(model, keys),
                         flat(tw.export_flax(model, zp.np_tree(gj)), keys),
                         zp.grad_vector(out["fp32"][0], keys), "scene DM")

    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    state.step = STEP
    state, mp = trainer.train_step(state, tb, noise=noise)
    assert float(mp["loss"]) == float(loss.detach())
    p = state.model.denoiser.time_pos_emb
    moments = state.optimizer.state[p]
    assert p.dtype == moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == BF16
    mu = optax.tree_utils.tree_get(new_j.opt_state, "mu")["denoiser"]["time_pos_emb"]
    assert mu.dtype == jnp.bfloat16
    want = np.asarray(new_j.params["denoiser"]["time_pos_emb"], np.float32)
    before = np.asarray(v["params"]["denoiser"]["time_pos_emb"], np.float32)
    got = p.detach().float().numpy()
    assert (got != before).mean() > 0.5  # the step moved the parameter
    ulp = np.spacing(np.abs(before).astype(np.float32)) * 2**16  # bf16's ulp at each element
    lr = trainer.lr_schedule(STEP)
    differ = got != want
    assert np.all(np.abs(got - want) <= (2 * lr + ulp) * 1.01)
    assert differ.mean() < 0.02, differ.mean()


# -- the composers and the CLI --------------------------------------------------


def test_composers_stay_float32_under_bf16_but_the_scene_diffuser(monkeypatch, tmp_path):
    """Under a bf16 config, and with a checkpoint trained under bf16, every
    network a composer builds computes in float32; the SceneDiffuser's
    denoiser (built by its trainer) computes in bf16."""
    base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", str(tmp_path),
            "--precision", "bf16", "--steps", "1"]
    state = train.main(base + ["--mode", "zoo", "--zoo-algo", "bc"])
    assert state.model.context_encoder.compute_dtype == BF16
    cfg = registry.get_registered_experiment_config("cld_smoke").unlock()
    cfg.train.training.precision = "bf16"
    cfg = cfg.lock()
    pack = tscene.synthetic_scene_pack(seed=0, num_scenes=1, agents_per_scene=2, sim_steps=20,
                                      device="cpu")
    sim = tenv.SimConfig(num_simulation_steps=20, n_step_action=5, raster_size=64,
                         hist_frames=cfg.algo.history_num_frames)
    built = []
    init = composers._init_or_restore
    monkeypatch.setattr(composers, "_init_or_restore",
                        lambda *a, **k: built.append(init(*a, **k)) or built[-1])
    scene_states = []
    scene_init = psdm.SceneDMTrainer.init_state
    monkeypatch.setattr(psdm.SceneDMTrainer, "init_state",
                        lambda self, seed=0: scene_states.append(scene_init(self, seed))
                        or scene_states[-1])
    names = sorted(composers.COMPOSER_REGISTRY)
    assert len(names) == 24
    for name in names:
        ckpts = {"policy": str(tmp_path / "zoo_bc" / "ckpt_final")} if name == "BC" else None
        composers.get_composer(name)(cfg, pack, sim, ckpts=ckpts,
                                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert built and len(scene_states) == 1
    for model in built:
        assert all(m.compute_dtype == torch.float32 for m in model.modules()
                   if hasattr(m, "compute_dtype")), type(model).__name__
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert scene_states[0].model.denoiser.compute_dtype == BF16


def test_train_cli_runs_the_zoo_gan_ebm_and_scene_dm_in_bf16(tmp_path):
    """One step of each mode at `--precision bf16` on the CPU: the networks
    in bf16, every parameter float32 but the scene model's time_pos_emb,
    finite losses in each stage's metrics."""
    base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", str(tmp_path),
            "--precision", "bf16", "--steps", "1"]
    for mode in (["--mode", "zoo", "--zoo-algo", "bc"], ["--mode", "gan"], ["--mode", "ebm"],
                 ["--mode", "scene_dm"]):
        state = train.main(base + mode)
        nets = [m for m in state.model.modules() if hasattr(m, "compute_dtype")]
        assert nets and all(m.compute_dtype == BF16 for m in nets), mode
        assert state.step == 1
        for k, p in state.model.named_parameters():
            assert p.dtype == (BF16 if k == "denoiser.time_pos_emb" else torch.float32), k
            assert torch.isfinite(p).all(), k
