"""The zoo trainer of the port against the JAX package's: one `ZooTrainer`
step of each of the eleven algos from the same weights and the same draws,
the non-finite guard, the registry's zoo rows and dataset presets, the train
CLI's `--mode zoo` end to end, and a zoo checkpoint's round trip.

Fixture (`zoo_parity.py`): the `cld_smoke` widths (cond 32, 12 raster
channels), raster 40, B=3, the synthetic batch with a dense Gaussian raster,
seeded flax variables converted by `utils.weights.load_flax`. The JAX side's
draws are read off its own key schedule (`fold_in(rng, step)`, the
trainer's): the outputs of its `jax.random` calls in the same loss call
(`zoo_parity.record_draws`) are the port's explicit `noise`.

Each algo's loss and gradients are held twice, from one JAX compile:
- in eval mode (`train=False`: running BatchNorm statistics, the discrete
  CVAE's argmax mode), the loss at rtol 1e-5 and every gradient at rtol 1e-4
  with a floor of 1e-5 of its largest component;
- through the port's `train_step` against the JAX trainer's train-mode
  `loss_call`: the loss and metrics at rtol 1e-4, BatchNorm's running
  statistics after the step at 1e-5, and the gradients within twice the
  port's own float32 error on the same problem: the relative L2 distance of
  all gradients to JAX's at most 2x (+1e-5) their distance to the same step
  in float64. Train-mode BatchNorm on a few samples per channel makes these
  gradients ill-conditioned in float32 (measured: the port's float32 step
  4.4e-2 from its float64 one for `bc` on this fixture; ReLU inputs that
  batch statistics centre at 0 flip sign under rounding), so a fixed bound
  would measure the fixture, not the function; the eval-mode check holds
  the function tightly.

Attention key biases have a zero gradient in exact arithmetic (softmax is
invariant to a shift of all logits), so both sides' are rounding residue:
they are held at 1e-5 of the model's largest gradient component
(`zoo_parity.ZERO_IN_EXACT`).
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
import zoo_step_parity as zsp

from cld_tpu.training import zoo as jax_zoo
from cld_tpu.utils import registry as jax_registry
from cld_tpu_torch.training import zoo
from cld_tpu_torch.training.checkpoints import restore_pytree
from cld_tpu_torch.utils import registry

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ALGOS = zsp.ALGOS
smoke_config = zsp.smoke_config
@pytest.mark.parametrize("name", zsp.ALGOS[:6])
def test_one_zoo_step_matches_jax(name, monkeypatch):
    """Loss, gradients and BatchNorm statistics of one step, in eval mode and
    through `ZooTrainer.train_step`, from the same weights and draws
    (`zoo_step_parity.one_zoo_step_matches_jax`; the other five algos' cases,
    and the guard's, are in `test_torch_zoo_trainer_steps.py`)."""
    zsp.one_zoo_step_matches_jax(name, monkeypatch)


def test_jax_guard_semantics_on_a_nonfinite_loss():
    """The JAX trainer keeps the whole state on a NaN loss: the rule the
    port's guard follows."""
    jcfg = smoke_config(jax_registry.get_registered_experiment_config)
    jb, _ = zp.batches()
    trainer = jax_zoo.ZooTrainer(jcfg, "TransformerPred")
    state = trainer.init_state(jax.random.key(0), jb)
    bad = jb._replace(history_positions=jb.history_positions * jnp.nan)
    new, m = trainer.train_step(state, bad, jax.random.key(1))
    assert not np.isfinite(float(m["loss"]))
    assert int(new.step) == int(state.step)
    for a, b in zip(jax.tree.leaves(new.params), jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eval_step_runs_without_training_mode():
    cfg = smoke_config(registry.get_registered_experiment_config)
    _, tb = zp.batches()
    for name in ("discrete_vae", "diff"):
        trainer = zoo.ZooTrainer(cfg, name, device="cpu")
        state = trainer.init_state(0)
        a, b = trainer.eval_step(state, tb), trainer.eval_step(state, tb)
        assert np.isfinite(float(a["loss"])) and float(a["loss"]) == float(b["loss"])


def test_factory_names_match_jax():
    assert sorted(zoo.ALGO_FACTORY) == sorted(jax_zoo.ALGO_FACTORY) == sorted(ALGOS)
    with pytest.raises(KeyError, match="unknown algo"):
        zoo.algo_factory(registry.get_registered_experiment_config("cld_smoke"), "nope")


ZOO_ROWS = [r for r in jax_registry._REFERENCE_EXPERIMENTS if r[2] == "zoo"]
OTHER_ROWS = [r for r in jax_registry._REFERENCE_EXPERIMENTS if r[2] != "zoo"]


@pytest.mark.parametrize("dataset", sorted({r[1] for r in ZOO_ROWS}))
def test_registry_zoo_rows_and_dataset_presets_match_jax(dataset):
    """Every zoo row of the JAX registry on this dataset resolves in the port
    to the same algo and the same config, key for key."""
    rows = [r for r in ZOO_ROWS if r[1] == dataset]
    for name, _, _, algo in rows:
        want = jax_registry.get_registered_experiment_config(name)
        got = registry.get_registered_experiment_config(name)
        assert got.algo.name == algo == want.algo.name and got.train.mode == "zoo"
        assert got.to_dict() == want.to_dict(), name


def test_registry_counts_and_unported_rows():
    """The 47 zoo rows and the 8 rows of the gan / ebm / scene_dm modes: each
    of the 8 resolves to the JAX package's config, key for key (a
    transformer GAN row's generator included)."""
    assert len(ZOO_ROWS) == 47 and len(OTHER_ROWS) == 8
    assert set(registry.EXP_CONFIG_REGISTRY) == (
        {r[0] for r in ZOO_ROWS + OTHER_ROWS}
        | {"cld_vae_nusc", "cld_dm_nusc", "cld_ppo_nusc", "cld_smoke"})
    for name, _, kind, algo in OTHER_ROWS:
        got = registry.get_registered_experiment_config(name)
        want = jax_registry.get_registered_experiment_config(name)
        assert got.train.mode == kind and got.to_dict() == want.to_dict(), name
        assert got.algo.get("gan_generator_arch") == algo
    ped = registry.get_registered_experiment_config("eupeds_bc")
    assert (ped.algo.horizon, ped.env.rasterizer.num_sem_layers, ped.algo.step_time) == (12, 0,
                                                                                          0.4)


def test_train_cli_mode_zoo_end_to_end(tmp_path):
    """`python -m cld_tpu_torch.train --mode zoo --zoo-algo bc --device cpu
    --steps 2`, then `--resume` from its `ckpt_final_full` to 3 steps, then
    the algo from `--registered-name`, in one process that imports no JAX;
    a `ckpt_final` round trip through `restore_pytree` into a fresh model."""
    out = tmp_path / "runs"
    code = f"""
import json, sys
from cld_tpu_torch import train
base = ["--registered-name", "cld_smoke", "--device", "cpu", "--output", {str(out)!r}]
train.main(base + ["--mode", "zoo", "--zoo-algo", "bc", "--steps", "2"])
train.main(base + ["--mode", "zoo", "--zoo-algo", "bc", "--steps", "3",
                   "--resume", {str(out / "zoo_bc" / "ckpt_final_full")!r}])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "cld_tpu"))
print("FORBIDDEN_IMPORTED=" + json.dumps(bad))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN_IMPORTED=[]" in res.stdout, res.stdout[-500:]
    assert "resumed full train state" in res.stdout and "at step 2" in res.stdout
    d = out / "zoo_bc"
    assert sorted(p.name for p in d.iterdir()) == ["ckpt_final", "ckpt_final_full",
                                                    "metrics.jsonl"]
    records = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(v) for r in records for v in r.values())
    full = torch.load(d / "ckpt_final_full", weights_only=True)
    assert full["step"] == 3 and full["loop_step"] == 3

    cfg = registry.get_registered_experiment_config("cld_smoke")
    model = zoo.algo_factory(cfg, "bc").build()
    sd = restore_pytree(str(d / "ckpt_final"))["params"]
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)

    # the algo by name from the registry: nusc_tree_vae at the smoke widths
    from cld_tpu_torch import train

    over = tmp_path / "over.json"
    over.write_text(json.dumps({
        "algo": {"cond_feat_dim": 32, "history_num_frames": 8},
        "env": {"rasterizer": {"raster_size": 40}},
        "train": {"training": {"batch_size": 2}}}))
    state = train.main(["--registered-name", "nusc_tree_vae", "--config", str(over),
                        "--device", "cpu", "--steps", "1", "--output", str(out)])
    assert state.step == 1 and (out / "zoo_tree_vae" / "ckpt_final").exists()
