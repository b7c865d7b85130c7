"""Training CLI of the port: the VAE, DM and PPO stages, the model zoo's
baseline algos, the GAN, the EBM learned metric, scene diffusion, and the
open-loop test.

    python -m cld_tpu_torch.train --mode vae
    python -m cld_tpu_torch.train --mode dm --vae-ckpt runs/vae/ckpt_final
    python -m cld_tpu_torch.train --mode ppo --vae-ckpt ... --dm-ckpt ...
    python -m cld_tpu_torch.train --mode zoo --zoo-algo bc
    python -m cld_tpu_torch.train --registered-name nusc_transformer_gan --mode gan
    python -m cld_tpu_torch.train --registered-name nusc_ebm --mode ebm
    python -m cld_tpu_torch.train --registered-name trajdata_nusc_scene_diff --mode scene_dm
    python -m cld_tpu_torch.train --registered-name nusc_vae
    python -m cld_tpu_torch.train --mode test --vae-ckpt ... --dm-ckpt ...

Counterpart of the JAX package's `train.py` (`train_vae`, `train_dm`,
`train_ppo`, `train_zoo`, `train_gan`, `train_ebm`, `train_scene_dm`,
`evaluate`), with its flag names plus `--device` (default
"cuda"; the tests and CPU runs pass "cpu"). One config drives all stages;
each stage loads the previous stage's checkpoint; metrics stream to stdout
and to `<output>/<stage>/metrics.jsonl`; checkpoints are single files
written with `torch.save`: `ckpt_<step>` / `ckpt_final` hold the stage's
module, `ckpt_<step>_full` / `ckpt_final_full` add the optimizer for
`--resume` (as in the JAX CLI, `--mode gan` and `--mode scene_dm` write no
`_full` file and take no `--resume`). `--vae-ckpt` / `--dm-ckpt` also take the output of
`python -m cld_tpu_torch.utils.torch_import` or a reference Lightning
`.ckpt`. `--mode zoo` trains the algo named by `--zoo-algo`, else the
config's `algo.name`, into `<output>/zoo_<name>/`. `--mode scene_dm` trains
on synthetic scene batches (`data.scene_batch`). `--mode ebm` writes the
checkpoint that the rollout CLI's `--ebm-ckpt` reads. `--mode test` prints the
failure rates and the Wasserstein realism deviation over `--steps`
validation batches as JSON.

Data parallelism, as the JAX CLI shards every stage but `scene_dm` over its
mesh: under `torchrun --nproc-per-node N` each rank trains on its rows of
the global batch (`train.training.batch_size`, which N must divide) and the
step is the global batch's (`parallel.mesh`: gradients averaged, BatchNorm
on the global batch's statistics, parameters broadcast from rank 0); rank 0
logs the metrics averaged over the ranks and writes the checkpoints.
`train.parallel.dp` -1 takes every rank. On the CPU (gloo):

    torchrun --nproc-per-node 2 -m cld_tpu_torch.train --registered-name cld_smoke \
        --mode vae --device cpu --steps 2 --output runs_dp

A small run on the CPU:

    python -m cld_tpu_torch.train --registered-name cld_smoke --mode vae \\
        --device cpu --steps 2 --output runs_smoke
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from cld_tpu_torch.data.loader import make_loader
from cld_tpu_torch.data.scene_batch import synthetic_scene_batch
from cld_tpu_torch.eval.metrics import realism_deviation
from cld_tpu_torch.parallel.mesh import Mesh, make_mesh, mean_over_ranks, replicate
from cld_tpu_torch.training.checkpoints import (
    restore_train_state,
    save_pytree,
    save_train_state,
)
from cld_tpu_torch.training.dm import DMTrainer
from cld_tpu_torch.training.ebm import EBMTrainer
from cld_tpu_torch.training.gan import GANTrainer
from cld_tpu_torch.training.ppo import PPOTrainer, buffer_init
from cld_tpu_torch.training.scene_dm import SceneDMTrainer
from cld_tpu_torch.training.vae import VAETrainer
from cld_tpu_torch.training.zoo import ZooTrainer
from cld_tpu_torch.utils.registry import config_from_flags
from cld_tpu_torch.utils.torch_import import read_checkpoint

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


# a rank's generators are seeded apart by this much, so that the ranks draw
# different noise for their rows (rank 0 draws as a single process does)
RANK_SEED_STRIDE = 1_000_003


def _generator(args, seed: int, per_rank: bool = True) -> torch.Generator:
    rank = args.mesh.rank if per_rank else 0
    return torch.Generator(device=args.device).manual_seed(seed + RANK_SEED_STRIDE * rank)


def _shared(state, args):
    """The state made a data-parallel replica (`parallel.mesh`) when the run
    has several ranks; as it is otherwise."""
    if args.mesh.active:
        replicate(state.model, args.mesh)
        state.mesh = args.mesh
    return state


def _train_loader(cfg, device, mesh: Optional[Mesh] = None):
    """This rank's training loader: the global batch in one process; under
    data parallelism the rank's lane of the packed shards
    (`DistributedPackedLoader`), or its rows of the global synthetic batch,
    the only rows it makes."""
    if mesh is None or not mesh.active:
        return make_loader(cfg, "train", device=device)
    data_path = cfg.train.get("data_path")
    if data_path not in (None, "synthetic"):
        from cld_tpu_torch.data.multihost import DistributedPackedLoader

        return DistributedPackedLoader(data_path, split="train",
                                       global_batch_size=cfg.train.training.batch_size, seed=0,
                                       rank=mesh.rank, world_size=mesh.world_size,
                                       device=device)
    return make_loader(cfg, "train", device=device, rank=mesh.rank, world_size=mesh.world_size)


def _batches(cfg, device, start_step: int, mesh: Optional[Mesh] = None):
    """The training stream as the JAX CLI draws it: one batch drawn for
    init and dropped, then the `start_step` batches that a resumed run has
    already trained on, so that step s trains on the stream's batch s + 1
    (under data parallelism, this rank's rows of it)."""
    it = iter(_train_loader(cfg, device, mesh))
    for _ in range(1 + start_step):
        next(it)
    return it


def _save(out_dir: str, name: str, state, loop_step: int, full: bool) -> None:
    save_pytree(os.path.join(out_dir, name), {"params": state.model.state_dict()})
    if full:
        save_train_state(os.path.join(out_dir, f"{name}_full"), state, loop_step=loop_step)


def _run_stage(cfg, args, stage: str, state, step_fn, batches=None, full: bool = True):
    """The loop the stages share: resume, step, log, checkpoint. `batches`
    is the stage's batch stream (default: the loader's, as the JAX CLI draws
    it); `full=False` writes no `_full` file and refuses `--resume`. Under
    data parallelism the metrics are averaged over the ranks and rank 0
    alone logs and writes. Returns the trained state."""
    if args.resume and not full:
        raise SystemExit(f"--resume: the {stage} stage writes no full-state checkpoint")
    out_dir = os.path.join(args.output, stage)
    main = args.mesh.is_main
    logger = MetricLogger(out_dir, cfg.train.logging.log_every_n_steps) if main else None
    try:
        start_step = 0
        if args.resume:
            state, start_step = restore_train_state(args.resume, state)
            print(f"resumed full train state from {args.resume} at step {start_step}")
        # step s, resumed or not, trains on the batch of the JAX CLI's step s
        it = batches if batches is not None else _batches(cfg, args.device, start_step, args.mesh)
        num_steps = args.steps or cfg.train.training.num_steps
        t0 = time.time()
        for step in range(start_step, num_steps):
            metrics = mean_over_ranks(step_fn(state, next(it), step), args.mesh)
            if not main:
                continue
            logger.log(step, metrics)
            if cfg.train.save.enabled and (step + 1) % cfg.train.save.every_n_steps == 0:
                _save(out_dir, f"ckpt_{step + 1}", state, step + 1, full)
        if main:
            _save(out_dir, "ckpt_final", state, num_steps, full)
            print(f"{stage} done: {num_steps} steps in {time.time() - t0:.1f}s -> {out_dir}")
        return state
    finally:
        if logger is not None:
            logger.close()


def train_vae(cfg, args):
    trainer = VAETrainer(cfg, device=args.device)
    state = _shared(trainer.init_state(cfg.seed), args)
    gen = _generator(args, cfg.seed + 1)

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
    dm_state = _shared(dm_state, args)
    gen = _generator(args, cfg.seed + 3)

    def step_fn(state, batch, step):
        return dm_trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, "dm", dm_state, step_fn)


def train_ppo(cfg, args):
    """Collect every step, update every `algo.update_interval` steps. A
    resumed run restores the optimizer and the step; the replay buffer is
    transient and starts empty. Under data parallelism every rank holds the
    global buffer (each collection adds every rank's rows) and its baseline,
    and an update iteration is the global minibatch's, split over the ranks
    (`PPOTrainer.collect_step`, `ppo_update`)."""
    dm_trainer, dm_state = _build_dm(cfg, args)
    dm_state = _shared(dm_state, args)
    ppo = PPOTrainer(cfg, dm_trainer)
    algo = cfg.algo
    buf = buffer_init(algo.buffer_max, algo.horizon, algo.vae.latent_size, algo.cond_feat_dim,
                      device=args.device)
    gen = _generator(args, cfg.seed + 4)

    def step_fn(state, batch, step):
        _, collected = ppo.collect_step(state, buf, batch, generator=gen)
        metrics = {"reward": collected["reward"]}
        if (step + 1) % algo.update_interval == 0:
            _, pm = ppo.ppo_update(state, buf, generator=gen)
            metrics.update(ppo_loss=pm["loss"], ppo_clip_fraction=pm["clip_fraction"],
                           ppo_ratio_mean=pm["ratio_mean"], ppo_approx_kl=pm["approx_kl"])
        return metrics

    return _run_stage(cfg, args, "ppo", dm_state, step_fn)


def train_zoo(cfg, args, algo_name: Optional[str] = None):
    """A baseline algo of the zoo (`training/zoo.py`): the algo named by
    `algo_name`, else `--zoo-algo`, else the config's `algo.name`, into
    `<output>/zoo_<name>/`."""
    name = algo_name or args.zoo_algo or cfg.algo.get("name", "bc")
    trainer = ZooTrainer(cfg, name, device=args.device)
    state = _shared(trainer.init_state(cfg.seed + 9), args)
    gen = _generator(args, cfg.seed + 10)

    def step_fn(state, batch, step):
        return trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, f"zoo_{name}", state, step_fn)


def train_gan(cfg, args):
    """The trajectory GAN (`training/gan.py`): alternating LSGAN updates,
    the generator `algo.gan_generator_arch` (default "mlp"); `ckpt_<n>` and
    `ckpt_final` only, as the JAX CLI writes."""
    trainer = GANTrainer(cfg, device=args.device)
    state = _shared(trainer.init_state(cfg.seed + 11), args)
    gen = _generator(args, cfg.seed + 12)

    def step_fn(state, batch, step):
        return trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, "gan", state, step_fn, full=False)


def train_ebm(cfg, args):
    """The learned-metric EBM (`training/ebm.py`, InfoNCE): the checkpoint
    that `python -m cld_tpu_torch.rollout --ebm-ckpt` reads. Its step draws
    nothing (the JAX CLI's key seed + 8 goes unused as well)."""
    trainer = EBMTrainer(cfg, device=args.device)
    state = _shared(trainer.init_state(cfg.seed + 7), args)
    return _run_stage(cfg, args, "ebm", state, lambda state, batch, step:
                      trainer.train_step(state, batch)[1])


def train_scene_dm(cfg, args):
    """Scene diffusion (`training/scene_dm.py`) on four synthetic scene
    batches of `max(1, batch_size // 8)` scenes x 8 agents (seeds 0-3),
    cycled; `ckpt_<n>` and `ckpt_final` only, as the JAX CLI writes. The
    JAX CLI does not shard this stage: under several ranks each trains the
    same replica, and rank 0 writes it."""
    trainer = SceneDMTrainer(cfg, device=args.device)
    algo = cfg.algo
    batches = [synthetic_scene_batch(seed=i, batch_size=max(1, cfg.train.training.batch_size // 8),
                                     num_agents=8, hist_frames=algo.history_num_frames,
                                     horizon=algo.future_num_frames, device=args.device)
               for i in range(4)]
    state = trainer.init_state(cfg.seed)
    gen = _generator(args, cfg.seed + 6, per_rank=False)

    def step_fn(state, batch, step):
        return trainer.train_step(state, batch, generator=gen)[1]

    return _run_stage(cfg, args, "scene_dm", state, step_fn, batches=itertools.cycle(batches),
                      full=False)


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
    """Runs the mode; returns the trained state of a training stage (a zoo
    algo's, the GAN's, the EBM's and the scene model's included), or
    `evaluate`'s result for --mode test."""
    parser = argparse.ArgumentParser(description="cld_tpu_torch trainer")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--registered-name", type=str, default=None,
                        help="named experiment config (cld_tpu_torch.utils.registry)")
    parser.add_argument("--mode", type=str, default=None,
                        choices=["vae", "dm", "ppo", "test", "scene_dm", "ebm", "zoo", "gan"])
    parser.add_argument("--zoo-algo", type=str, default=None,
                        help="factory algo for --mode zoo (cld_tpu_torch.training.zoo; "
                             "default: the config's algo.name)")
    parser.add_argument("--output", type=str, default="runs")
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--vae-ckpt", type=str, default=None)
    parser.add_argument("--dm-ckpt", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="full-state checkpoint (ckpt_*_full) to resume mid-training: "
                             "parameters, optimizer moments and step counters; the batch "
                             "stream skips to the step, as the JAX CLI's does")
    parser.add_argument("--precision", type=str, default=None,
                        help="network compute dtype of every mode: auto (bf16 on the card, "
                             "fp32 on the CPU), bf16 or fp32; parameters and losses stay fp32 "
                             "(the scene model's time_pos_emb takes the compute dtype, as in "
                             "the JAX package). --mode zoo's diff algo and the scene model's "
                             "conditioning encoder compute in fp32 under every precision")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where to train: cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = config_from_flags(args.registered_name, args.config)
    if args.precision is not None:
        cfg.unlock()
        cfg.train.training.precision = args.precision
        cfg.lock()
    mode = args.mode or cfg.train.mode
    args.mesh = Mesh(device=torch.device(args.device))
    if mode != "test":
        args.mesh = make_mesh(cfg.train.parallel.get("dp", -1), args.device)
        if args.mesh.active:
            args.device = str(args.mesh.device)
    print(f"mode={mode} device={args.device}"
          + (f" rank={args.mesh.rank}/{args.mesh.world_size}" if args.mesh.active else ""))
    return {"vae": train_vae, "dm": train_dm, "ppo": train_ppo, "scene_dm": train_scene_dm,
            "ebm": train_ebm, "zoo": train_zoo, "gan": train_gan, "test": evaluate}[mode](cfg, args)


if __name__ == "__main__":
    main()
