"""The trajectory GAN of the port against the JAX package's:
`TrajectoryGAN` with both generators and `GANTrainer`, each from the same
weights (seeded flax variables converted by `utils.weights.load_flax`,
strict) on the same numpy-made inputs; then `--mode gan|ebm` and the rollout
CLI's `--ebm-ckpt` end to end on the CPU.

Fixture (`zoo_parity.py`, `gan_ebm_parity.py`): the `cld_smoke` widths (map
feature and cond 32, 12 raster channels), raster 40, B=3, the synthetic
batch with a dense Gaussian raster. The GAN's noise is read off the JAX
side's own draws (`zoo_parity.record_draws`) and passed to the port.

Tolerances: in eval mode (running BatchNorm statistics) values at rtol
1e-5 and gradients at rtol 1e-4, each with a floor of 1e-5 of the tensor's
largest component. A train step (BatchNorm on the batch's statistics)
as in `test_torch_zoo_trainer.py`: losses and metrics at rtol 1e-4,
BatchNorm's running statistics at 1e-5, and the gradients of each update
within twice (+1e-5) the port's own float32 error on the same step, its
relative L2 distance to the step in float64 (train-mode BatchNorm on three
samples per channel is ill-conditioned in float32).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zoo_parity as zp
from gan_ebm_parity import (
    STEP,
    assert_train_grads,
    bn_stats_close,
    double_model,
    grads_by_key,
    jax_gan,
    recording,
    smoke_config,
)

from cld_tpu.training import gan as jgan
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.training import gan
from cld_tpu_torch.training.checkpoints import restore_pytree
from cld_tpu_torch.utils import registry
from cld_tpu_torch.utils import weights as tw

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", params=["mlp", "transformer"])
def gan_fixture(request):
    """Both generators: the batches, seeded GAN variables, and from one JAX
    compile the model in eval mode (the losses, trajectories and means, and
    the gradients of d_loss + 3 g_loss) and one JAX trainer step at step
    `STEP` (its new state and metrics, and each update's gradients read off
    its optimizers), with the noise each drew."""
    arch = request.param
    jb, tb = zp.batches()
    jm = jax_gan(arch)
    v = zp.random_variables(jm, jb, rngs=("params", "sample"))
    jcfg = smoke_config(jax_registry.get_registered_experiment_config).unlock()
    jcfg.algo.gan_generator_arch = arch
    jtr = jgan.GANTrainer(jcfg.lock())
    g_sub, d_sub = jgan._split_params(v["params"])
    jstate = jgan.GANTrainState(params=v["params"], batch_stats=v["batch_stats"],
                                g_opt_state=jtr.g_opt.init(g_sub),
                                d_opt_state=jtr.d_opt.init(d_sub), step=jnp.int32(STEP))
    sink = []
    jtr.d_opt, jtr.g_opt = recording(jtr.d_opt, sink), recording(jtr.g_opt, sink)

    def jax_side(v, jb, jstate):
        def loss(p):
            out = jm.apply(dict(v, params=p), jb, rngs={"sample": jax.random.key(3)})
            return out["d_loss"] + 3.0 * out["g_loss"], out

        evaluated = jax.grad(loss, has_aux=True)(v["params"])
        sink.clear()
        return evaluated, (jtr._train_step(jstate, jb, jax.random.key(12)), list(sink))

    drawn, (evaluated, stepped) = zp.record_draws(pytest.MonkeyPatch(), jax_side, v, jb, jstate,
                                                  keep_output=True)
    # the eval call's draw, then the step's discriminator and generator draws
    assert len(drawn["normal"]) == 3 and drawn["normal"][0].shape == (zp.B, 16)
    return dict(arch=arch, jb=jb, tb=tb, v=v, d_sub=d_sub, evaluated=evaluated,
                stepped=stepped, eval_z=drawn["normal"][0], step_z=drawn["normal"][1:])


def port_gan(arch, v):
    """The port's trainer and a state holding the JAX weights."""
    cfg = smoke_config(registry.get_registered_experiment_config).unlock()
    cfg.algo.gan_generator_arch = arch
    trainer = gan.GANTrainer(cfg.lock(), device="cpu")
    state = trainer.init_state(0)
    tw.load_flax(state.model, v)
    return trainer, state


def test_trajectory_gan_matches_jax_in_eval_mode(gan_fixture):
    """Both views of the LSGAN losses, the trajectories and the
    discriminator means from the JAX side's own noise draw, and the
    gradients of d_loss + 3 g_loss in every parameter (one backward through
    both views); `generate` with two samples per agent."""
    f = gan_fixture
    tb, v, (grads, want) = f["tb"], f["v"], f["evaluated"]
    _, state = port_gan(f["arch"], v)
    model = state.model
    assert set(model.state_dict()) == set(tw.export_flax(model, v["params"], v["batch_stats"]))
    zt = torch.tensor(f["eval_z"])
    got = model(tb, zt)
    for k in ("d_loss", "g_loss", "trajectories", "d_real_mean", "d_fake_mean"):
        zp.assert_close(got[k].detach().numpy(), np.asarray(want[k]), msg=k)
    (got["d_loss"] + 3.0 * got["g_loss"]).backward()
    zp.assert_grads_close(model, tw.export_flax(model, zp.np_tree(grads), v["batch_stats"]))
    # num_samp samples per agent: agent b takes rows b * num_samp ... of z
    with torch.no_grad():
        traj, _ = model.generate(tb, torch.repeat_interleave(zt, 2, dim=0), num_samp=2)
    assert traj.shape == (zp.B, 2, 52, 6)
    torch.testing.assert_close(traj[:, 1], got["trajectories"].detach(), rtol=0, atol=0)


def test_gan_train_step_matches_jax(gan_fixture):
    """One `GANTrainer.train_step` against the JAX trainer's, from the same
    weights and the JAX step's two noise draws: the metrics; the
    discriminator update's gradients (generator side frozen) at the old
    weights; the generator update's gradients through the updated
    discriminator (each package's own); BatchNorm statistics that are the
    generator pass's, from the statistics before the step (the
    discriminator pass's are dropped); and each side's update touching only
    its own parameters."""
    f = gan_fixture
    tb, v = f["tb"], f["v"]
    (new_j, mj), (gd, gg) = f["stepped"]
    trainer, state = port_gan(f["arch"], v)
    model = state.model
    m64 = double_model(model)
    seen = {}
    state.d_optimizer.register_step_pre_hook(lambda *_: seen.update(
        d=grads_by_key(model), before_d={k: t.clone() for k, t in model.state_dict().items()}))
    state.g_optimizer.register_step_pre_hook(lambda *_: seen.update(
        g=grads_by_key(model), before_g={k: t.clone() for k, t in model.state_dict().items()}))
    z_d, z_g = (torch.tensor(a) for a in f["step_z"])
    state, mp = trainer.train_step(state, tb, noise=(z_d, z_g))
    assert state.step == 1
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    bn_stats_close(model, tw.export_flax(model, v["params"], zp.np_tree(new_j.batch_stats)))

    # the discriminator update: only the discriminator has a gradient
    assert all(k.startswith("discriminator.") for k in seen["d"])
    m64(zp.to_double(tb), z_d.double(), train=True)["d_loss"].backward()
    bs = v["batch_stats"]
    want_d = tw.export_flax(model, zp.np_tree(dict(v["params"], **gd)), bs)
    d_keys = sorted(seen["d"])
    assert_train_grads(seen["d"], want_d, grads_by_key(m64, d_keys), d_keys)

    # the generator update: the port's through its updated discriminator,
    # JAX's through its own (the two differ only where Adam's first step
    # divides a gradient of rounding size by itself)
    sd_g = seen["before_g"]
    assert not any(k.startswith("discriminator.") for k in seen["g"])
    m64 = double_model(model)
    m64.load_state_dict({k: t.double() if t.is_floating_point() else t
                         for k, t in sd_g.items()})
    for p in m64.discriminator.parameters():
        p.requires_grad_(False)
    m64(zp.to_double(tb), z_g.double(), train=True)["g_loss"].backward()
    g_keys = sorted(k for k in seen["g"] if "bias_hh" not in k
                    and not k.endswith(zp.ZERO_IN_EXACT))
    want_g = tw.export_flax(model, zp.np_tree(dict(gg, **f["d_sub"])), bs)
    assert_train_grads(seen["g"], want_g, grads_by_key(m64, g_keys), g_keys)

    # each update moved its side only
    sd = model.state_dict()
    for k, t in sd.items():
        if not k.endswith(("weight", "bias")):
            continue
        d_side = k.startswith("discriminator.")
        assert torch.equal(seen["before_g"][k], seen["before_d"][k]) != d_side, k
        assert torch.equal(t, seen["before_g"][k]) == d_side, k


# -- the CLIs ----------------------------------------------------------------


def test_train_cli_gan_and_ebm_and_rollout_ebm_ckpt_end_to_end(tmp_path):
    """`python -m cld_tpu_torch.train --device cpu` on `cld_smoke`: `--mode
    gan` with both generators (`ckpt_final`, no `_full` file), `--mode ebm`
    2 steps then `--resume` to 3, then the rollout CLI with `--ebm-ckpt` on
    that `ckpt_final` reporting `ebm_score_mean` / `ebm_score_min`, in one
    process that imports no JAX."""
    out = tmp_path / "runs"
    code = f"""
import json, sys
from cld_tpu_torch import rollout, train
base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", {str(out)!r}]
train.main(base + ["--mode", "gan", "--steps", "2"])
cfg = {str(tmp_path / "tgan.json")!r}
json.dump({{"algo": {{"gan_generator_arch": "transformer"}}}}, open(cfg, "w"))
train.main(base + ["--mode", "gan", "--steps", "1", "--config", cfg,
                   "--output", {str(out / "tgan")!r}])
train.main(base + ["--mode", "ebm", "--steps", "2"])
train.main(base + ["--mode", "ebm", "--steps", "3",
                   "--resume", {str(out / "ebm" / "ckpt_final_full")!r}])
rep = rollout.main(["--registered-name", "cld_smoke", "--device", "cpu", "--num-sim-steps",
                    "20", "--agents-per-scene", "2", "--raster-size", "64",
                    "--ebm-ckpt", {str(out / "ebm" / "ckpt_final")!r},
                    "--output", {str(tmp_path / "roll")!r}])
print("EBM=" + json.dumps([rep["ebm_score_mean"], rep["ebm_score_min"]]))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cld_tpu"))
print("FORBIDDEN_IMPORTED=" + json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="2")  # torch's threads, as this process's
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FORBIDDEN_IMPORTED=[]" in res.stdout, res.stdout[-500:]
    assert "resumed full train state" in res.stdout and "at step 2" in res.stdout
    for stage, files in (("gan", ["ckpt_final", "metrics.jsonl"]),
                         ("tgan/gan", ["ckpt_final", "metrics.jsonl"]),
                         ("ebm", ["ckpt_final", "ckpt_final_full", "metrics.jsonl"])):
        assert sorted(p.name for p in (out / stage).iterdir()) == files, stage
        recs = [json.loads(x) for x in (out / stage / "metrics.jsonl").read_text().splitlines()]
        assert all(np.isfinite(val) for r in recs for val in r.values())
    recs = [json.loads(x) for x in (out / "gan" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert set(recs[0]) == {"step", "train/d_loss", "train/g_loss", "train/d_real_mean",
                            "train/d_fake_mean"}
    sd = restore_pytree(str(out / "tgan" / "gan" / "ckpt_final"))["params"]
    assert "generator.attn0.query.weight" in sd
    recs = [json.loads(x) for x in (out / "ebm" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2] and "train/infonce_acc" in recs[0]
    ebm = json.loads(res.stdout.split("EBM=")[1].splitlines()[0])
    assert np.isfinite(ebm).all() and ebm[1] <= ebm[0]
    with pytest.raises(SystemExit, match="no full-state checkpoint"):
        from cld_tpu_torch import train

        train.main(["--registered-name", "cld_smoke", "--device", "cpu", "--mode", "gan",
                    "--resume", str(out / "ebm" / "ckpt_final_full"), "--output",
                    str(tmp_path / "x")])
