"""Data parallelism over a `torch.distributed` process group: the port's
counterpart of the JAX package's `make_mesh`, `shard_batch` and
`replicate`.

Under `jit` the JAX train step is one step over the global batch, its
parameters replicated and its batch sharded over a 1-D 'dp' mesh. Here each
rank is one process (`torchrun --nproc-per-node N`), and a step keeps those
semantics:

* the process group comes from torchrun's environment (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL on the
  card, gloo on the CPU; each rank on the card takes `cuda:LOCAL_RANK`;
* each rank takes its rows of the global batch: its lane of
  `data.multihost.DistributedPackedLoader` from packed shards, its rows of
  a synthetic batch (`data.synthetic.synthetic_batch(rank=, world_size=)`),
  or `shard_batch`'s rows of a global batch;
* parameters and buffers start identical on every rank (`replicate`
  broadcasts rank 0's);
* train-mode BatchNorm normalizes with the statistics of the global batch
  and moves its running statistics by them (`GlobalBatchNorm2d`: per-channel
  sums through an all-reduce that carries the gradient), so the step is the
  global batch's, BatchNorm included; `torch.nn.SyncBatchNorm` would do the
  same on the card but refuses CPU tensors;
* gradients are averaged over the ranks before each update (the loss of a
  rank is its rows' mean, so the average is the global mean's gradient),
  and the non-finite guard skips an update on every rank when the loss is
  not finite on one;
* where a loss couples rows (the EBM's InfoNCE) or a trainer keeps state
  over batches (PPO's replay buffer and reward baseline), the rows of every
  rank are gathered (`gather_rows`), so the loss and the state are the
  global batch's.

At world size 1 nothing of this runs: no process group is made, and the
trainers' steps are the single-process ones, bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from cld_tpu_torch.models.resnet import BatchNorm2d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group, and its device."""

    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cuda")

    @property
    def active(self) -> bool:
        """More than one rank: the collectives run."""
        return self.world_size > 1

    @property
    def is_main(self) -> bool:
        """Rank 0, which writes the logs and checkpoints."""
        return self.rank == 0


def make_mesh(num_devices: int = -1, device="cuda") -> Mesh:
    """The data-parallel mesh of this process. Under torchrun (`WORLD_SIZE`
    above 1) the default process group is initialized from its environment,
    if it is not already, with NCCL for a CUDA `device` and gloo for the
    CPU; a CUDA rank runs on `cuda:LOCAL_RANK`. Without it, world size 1 on
    `device`. `num_devices` is the config's `train.parallel.dp`: -1 takes
    every rank, another value must equal the world size."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
    if num_devices > 0 and num_devices != world:
        raise ValueError(f"train.parallel.dp={num_devices}, but {world} ranks run; launch "
                         f"torchrun --nproc-per-node {num_devices} or set dp to -1")
    if world == 1:
        return Mesh(0, 1, device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return Mesh(dist.get_rank(), dist.get_world_size(), device)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a NamedTuple of tensors and
    Nones, or a tensor): rows [rank * b, (rank + 1) * b) of every tensor,
    b = global rows / world size, which must divide."""
    if not mesh.active:
        return batch

    def rows(x):
        if not torch.is_tensor(x):
            return x
        n = x.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"a batch of {n} rows does not divide over {mesh.world_size} ranks")
        b = n // mesh.world_size
        return x[mesh.rank * b:(mesh.rank + 1) * b]

    if torch.is_tensor(batch):
        return rows(batch)
    return batch._replace(**{k: rows(v) for k, v in batch._asdict().items()})


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch's rows of `x`: every rank's rows in rank order (the
    inverse of `shard_batch`), through an all-gather that carries the
    gradient. `x` itself without an active mesh."""
    if mesh is None or not mesh.active:
        return x
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(x), dim=0)


def broadcast_from_main(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Rank 0's `x` on every rank (a copy); `x` itself without an active
    mesh."""
    if mesh is None or not mesh.active:
        return x
    x = x.clone()
    dist.broadcast(x, src=0)
    return x


def max_over_ranks(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The largest of the ranks' `x`, elementwise; `x` itself without an
    active mesh."""
    if mesh is None or not mesh.active:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


class GlobalBatchNorm2d(BatchNorm2d):
    """The port's BatchNorm2d whose train-mode statistics are the global
    batch's: the mean and the (biased) variance are two all-reduces of
    per-channel sums (the variance about the global mean) that carry the
    gradient to every rank. Eval mode and the running-statistics rule are
    the base class's."""

    def normalize_batch(self, x: torch.Tensor):
        from torch.distributed.nn.functional import all_reduce

        dims = (0, 2, 3)
        xs = x.to(torch.promote_types(x.dtype, torch.float32))  # bf16 compute: f32 statistics
        n = all_reduce(torch.tensor(float(x.numel() // x.shape[1]), dtype=xs.dtype,
                                    device=x.device))
        mean = all_reduce(xs.sum(dim=dims)) / n
        centered = xs - mean[None, :, None, None]
        var = all_reduce((centered * centered).sum(dim=dims)) / n
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = centered * scale[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype), mean, var


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Make `module` a replica of rank 0's, in place: its parameters and
    buffers broadcast from rank 0, and every BatchNorm2d of the port's
    models (`models.resnet.BatchNorm2d`) made a `GlobalBatchNorm2d`. At
    world size 1 the module is left as it is."""
    if not mesh.active:
        return module
    for m in module.modules():
        if type(m) is BatchNorm2d:
            m.__class__ = GlobalBatchNorm2d
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def average_gradients(params: Iterable[nn.Parameter], mesh: Optional[Mesh]) -> None:
    """Every parameter's `.grad` averaged over the ranks, in place, in one
    all-reduce of the flattened gradients (a missing gradient counts as 0
    and stays missing where no rank has one)."""
    if mesh is None or not mesh.active:
        return
    params = list(params)
    flags = torch.tensor([float(p.grad is not None) for p in params], dtype=params[0].dtype,
                         device=params[0].device)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [flags])
    dist.all_reduce(flat)
    has = flat[-len(params):]
    off = 0
    for p, h in zip(params, has.tolist()):
        n = p.numel()
        if h > 0:
            g = flat[off:off + n].view_as(p) / mesh.world_size
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.copy_(g)
        off += n


def all_finite(loss: torch.Tensor, mesh: Optional[Mesh]) -> bool:
    """Whether the loss is finite on every rank (one scalar read on the
    host)."""
    ok = torch.isfinite(loss).all()
    if mesh is not None and mesh.active:
        flag = ok.to(torch.float32).reshape(1)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        ok = flag[0] > 0
    return bool(ok)


def mean_over_ranks(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Each tensor metric averaged over the ranks (the global batch's value
    for a mean over rows); other values as they are."""
    if mesh is None or not mesh.active:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if not keys:
        return metrics
    flat = torch.stack([metrics[k].detach().to(torch.float32).reshape(()) for k in keys])
    flat = flat.to(mesh.device)
    dist.all_reduce(flat)
    flat = flat / mesh.world_size
    return {**metrics, **{k: flat[i] for i, k in enumerate(keys)}}
