"""One `ZooTrainer` step of five of the eleven zoo algos against the JAX
package's, and the non-finite guard of all eleven (the other six steps, the
JAX guard's semantics, the registry's zoo rows and `--mode zoo` are in
`test_torch_zoo_trainer.py`, which sets out the method and the tolerances;
the step check itself is `zoo_step_parity.one_zoo_step_matches_jax`). Two
files, so that neither holds one test worker for long."""

import pytest
import torch
import zoo_parity as zp
import zoo_step_parity as zsp

from cld_tpu_torch.training import zoo
from cld_tpu_torch.utils import registry

torch.set_num_threads(2)


@pytest.mark.parametrize("name", zsp.ALGOS[6:])
def test_one_zoo_step_matches_jax(name, monkeypatch):
    """Loss, gradients and BatchNorm statistics of one step, in eval mode and
    through `ZooTrainer.train_step`, from the same weights and draws."""
    zsp.one_zoo_step_matches_jax(name, monkeypatch)


@pytest.mark.parametrize("name", zsp.ALGOS)
def test_nonfinite_loss_keeps_the_state(name):
    """A batch with a NaN target: the step is skipped and parameters,
    optimizer moments, BatchNorm statistics and the step count stay as they
    were (the JAX trainer's `jnp.where(isfinite(loss), new, old)`)."""
    cfg = zsp.smoke_config(registry.get_registered_experiment_config)
    _, tb = zp.batches()
    trainer = zoo.ZooTrainer(cfg, name, device="cpu")
    state = trainer.init_state(1)
    gen = torch.Generator().manual_seed(0)
    state, _ = trainer.train_step(state, tb, generator=gen)  # moments exist
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [t.clone() for s in state.optimizer.state.values() for t in s.values()]
    pos = tb.target_positions.clone()
    pos[0, 5, 0] = float("nan")
    bad = tb._replace(target_positions=pos, image=tb.image * float("nan"))
    state, m = trainer.train_step(state, bad, generator=gen)
    assert m["skipped_nonfinite"] == 1.0 and state.step == 1
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, equal_nan=True, msg=k)
    after = [t for s in state.optimizer.state.values() for t in s.values()]
    for a, b in zip(after, moments):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(p.grad is None for p in state.model.parameters())
