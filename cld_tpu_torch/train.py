"""Training CLI of the port: the VAE, DM and PPO stages on synthetic data,
and the open-loop test.

    python -m cld_tpu_torch.train --mode vae
    python -m cld_tpu_torch.train --mode dm --vae-ckpt runs/vae/ckpt_final
    python -m cld_tpu_torch.train --mode ppo --vae-ckpt ... --dm-ckpt ...
    python -m cld_tpu_torch.train --mode test --vae-ckpt ... --dm-ckpt ...

Counterpart of the JAX package's `train.py` (`train_vae`, `train_dm`,
`train_ppo`, `evaluate`), with its flag names plus `--device` (default
"cuda"; the tests and CPU runs pass "cpu"). One config drives all stages;
each stage loads the previous stage's checkpoint; metrics stream to stdout
and to `<output>/<stage>/metrics.jsonl`; checkpoints are single files
written with `torch.save`: `ckpt_<step>` / `ckpt_final` hold the stage's
module, `ckpt_<step>_full` / `ckpt_final_full` add the optimizer for
`--resume`. `--vae-ckpt` / `--dm-ckpt` also take the output of
`python -m cld_tpu_torch.utils.torch_import` or a reference Lightning
`.ckpt`. `--mode test` prints the failure rates and the Wasserstein realism
deviation over `--steps` validation batches as JSON.

A small run on the CPU:

    python -m cld_tpu_torch.train --registered-name cld_smoke --mode vae \\
        --device cpu --steps 2 --output runs_smoke
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from cld_tpu_torch.data.loader import make_loader
from cld_tpu_torch.eval.metrics import realism_deviation
from cld_tpu_torch.training.checkpoints import (
    restore_train_state,
    save_pytree,
    save_train_state,
)
from cld_tpu_torch.training.dm import DMTrainer
from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init
from cld_tpu_torch.training.vae import VAETrainer
from cld_tpu_torch.utils.registry import config_from_flags
from cld_tpu_torch.utils.torch_import import read_checkpoint

# modes of the JAX CLI that the port does not have yet, with where they wait
UNPORTED_MODES = {
    "scene_dm": "ROADMAP Queue A 12 (training/scene_dm.py)",
    "zoo": "ROADMAP Queue A 12 (training/zoo.py)",
    "gan": "ROADMAP Queue A 12 (training/gan.py)",
    "ebm": "ROADMAP Queue A 12 (training/ebm.py)",
}


class MetricLogger:
    """Appends one JSON record per step to `<out_dir>/metrics.jsonl` and
    prints every `log_every`-th. Reading a metric's value waits for the
    device."""

    def __init__(self, out_dir: str, log_every: int = 5):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.log_every = log_every
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        record = {"step": step, **{f"{prefix}/{k}": float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(record) + "\n")
        if step % self.log_every == 0:
            self._f.flush()
            line = " ".join(f"{k}={v:.5g}" for k, v in record.items() if k != "step")
            print(f"[{prefix} step {step}] {line}", flush=True)

    def close(self) -> None:
        self._f.close()


def _batches(cfg, device, start_step: int):
    """The training stream as the JAX CLI draws it: one batch drawn for
    init and dropped, then the `start_step` batches that a resumed run has
    already trained on, so that step s trains on the stream's batch s + 1."""
    it = iter(make_loader(cfg, "train", device=device))
    for _ in range(1 + start_step):
        next(it)
    return it


def _save(out_dir: str, name: str, state, loop_step: int) -> None:
    save_pytree(os.path.join(out_dir, name), {"params": state.model.state_dict()})
    save_train_state(os.path.join(out_dir, f"{name}_full"), state, loop_step=loop_step)


def _run_stage(cfg, args, stage: str, state, step_fn):
    """The loop the three stages share: resume, step, log, checkpoint.
    Returns the trained state."""
    out_dir = os.path.join(args.output, stage)
    logger = MetricLogger(out_dir, cfg.train.logging.log_every_n_steps)
    try:
        start_step = 0
        if args.resume:
            state, start_step = restore_train_state(args.resume, state)
            print(f"resumed full train state from {args.resume} at step {start_step}")
        # step s, resumed or not, trains on the batch of the JAX CLI's step s
        it = _batches(cfg, args.device, start_step)
        num_steps = args.steps or cfg.train.training.num_steps
        t0 = time.time()
        for step in range(start_step, num_steps):
            metrics = step_fn(state, next(it), step)
            logger.log(step, metrics)
            if cfg.train.save.enabled and (step + 1) % cfg.train.save.every_n_steps == 0:
                _save(out_dir, f"ckpt_{step + 1}", state, step + 1)
        _save(out_dir, "ckpt_final", state, num_steps)
        print(f"{stage} done: {num_steps} steps in {time.time() - t0:.1f}s -> {out_dir}")
        return state
    finally:
        logger.close()


def train_vae(cfg, args):
    trainer = VAETrainer(cfg, device=args.device)
    state = trainer.init_state(cfg.seed)
    gen = torch.Generator(device=args.device).manual_seed(cfg.seed + 1)

    def step_fn(state, batch, step):
        return trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, "vae", state, step_fn)


def _build_dm(cfg, args):
    vae_state = VAETrainer(cfg, device=args.device).init_state(0)
    if args.vae_ckpt:
        vae_state.model.load_state_dict(read_checkpoint(args.vae_ckpt, "vae"), strict=True)
    else:
        print("WARNING: no --vae-ckpt; DM will train on an untrained VAE")
    dm_trainer = DMTrainer(cfg, vae_state.model, device=args.device)
    dm_state = dm_trainer.init_state(cfg.seed + 2)
    if args.dm_ckpt:
        dm_state.model.load_state_dict(read_checkpoint(args.dm_ckpt, "dm"), strict=True)
    return dm_trainer, dm_state


def train_dm(cfg, args):
    dm_trainer, dm_state = _build_dm(cfg, args)
    gen = torch.Generator(device=args.device).manual_seed(cfg.seed + 3)

    def step_fn(state, batch, step):
        return dm_trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, "dm", dm_state, step_fn)


def train_ppo(cfg, args):
    """Collect every step, update every `algo.update_interval` steps. A
    resumed run restores the optimizer and the step; the replay buffer is
    transient and starts empty."""
    dm_trainer, dm_state = _build_dm(cfg, args)
    ppo = PPOTrainer(cfg, dm_trainer)
    algo = cfg.algo
    buf = buffer_init(algo.buffer_max, algo.horizon, algo.vae.latent_size, algo.cond_feat_dim,
                      device=args.device)
    gen = torch.Generator(device=args.device).manual_seed(cfg.seed + 4)

    def step_fn(state, batch, step):
        _, collected = ppo.collect_step(state, buf, batch, generator=gen)
        metrics = {"reward": collected["reward"]}
        if (step + 1) % algo.update_interval == 0:
            _, pm = ppo.ppo_update(state, buf, generator=gen)
            metrics.update(ppo_loss=pm["loss"], ppo_clip_fraction=pm["clip_fraction"],
                           ppo_ratio_mean=pm["ratio_mean"], ppo_approx_kl=pm["approx_kl"])
        return metrics

    return _run_stage(cfg, args, "ppo", dm_state, step_fn)


def _eval_batches(cfg, device):
    """The validation stream as the JAX CLI's `evaluate` draws it: the
    loader's first batch, drawn before the models are built, is batch 0 (the
    training stream drops it)."""
    return iter(make_loader(cfg, "val", device=device))


def evaluate(cfg, args, noise: Optional[Callable[[int], Dict]] = None) -> dict:
    """Open-loop test (`guide_dm_trainer.py:204-295`): one sampled
    trajectory per agent for each of `--steps` validation batches (default
    `train.validation.num_steps_per_epoch`), its failure rates averaged over
    the batches and the Wasserstein realism deviation of its accelerations
    and jerk against the ground truth's. `noise(i)` gives batch i's sampler
    noise (`x_init`, `step_noises`) explicitly; by default it is drawn from
    a generator seeded `cfg.seed + 5`. Prints and returns the result."""
    it = _eval_batches(cfg, args.device)
    dm_trainer, dm_state = _build_dm(cfg, args)
    ppo = PPOTrainer(cfg, dm_trainer)
    gen = torch.Generator(device=args.device).manual_seed(cfg.seed + 5)
    num_batches = args.steps or cfg.train.validation.num_steps_per_epoch
    all_rates, all_stats = [], []
    for i in range(num_batches):
        kw = noise(i) if noise is not None else {"generator": gen}
        rates, stats = ppo.test_step(dm_state, next(it), **kw)
        all_rates.append({k: float(v) for k, v in rates.items()})
        # [B, T] rows: jerk is differenced along T per agent
        all_stats.append({k: v.cpu().numpy() for k, v in stats.items()})
    result = {k: float(np.mean([r[k] for r in all_rates])) for k in all_rates[0]}
    merged = {k: np.concatenate([s[k] for s in all_stats], axis=0) for k in all_stats[0]}
    result.update(realism_deviation(merged, dt=cfg.algo.step_time))
    print(json.dumps(result, indent=2))
    return result


def main(argv: Optional[Sequence[str]] = None):
    """Runs the mode; returns the trained state of a training stage, or
    `evaluate`'s result for --mode test."""
    parser = argparse.ArgumentParser(description="cld_tpu_torch trainer")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--registered-name", type=str, default=None,
                        help="named experiment config (cld_tpu_torch.utils.registry)")
    parser.add_argument("--mode", type=str, default=None,
                        choices=["vae", "dm", "ppo", "test", *UNPORTED_MODES])
    parser.add_argument("--output", type=str, default="runs")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--vae-ckpt", type=str, default=None)
    parser.add_argument("--dm-ckpt", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="full-state checkpoint (ckpt_*_full) to resume mid-training: "
                             "parameters, optimizer moments and step counters; the batch "
                             "stream skips to the step, as the JAX CLI's does")
    parser.add_argument("--precision", type=str, default=None,
                        help="network compute dtype: auto or fp32 (bf16 is not ported yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to train: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = config_from_flags(args.registered_name, args.config)
    if args.precision is not None:
        cfg.unlock()
        cfg.train.training.precision = args.precision
        cfg.lock()
    mode = args.mode or cfg.train.mode
    if mode in UNPORTED_MODES:
        raise NotImplementedError(f"--mode {mode} is not ported yet: {UNPORTED_MODES[mode]}")
    print(f"mode={mode} device={args.device}")
    return {"vae": train_vae, "dm": train_dm, "ppo": train_ppo, "test": evaluate}[mode](cfg, args)


if __name__ == "__main__":
    main()
