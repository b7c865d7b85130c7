"""Per-rank shard reading with DistributedSampler semantics (port of
`cld_tpu/data/multihost.py`).

Every rank gathers only its `global_batch / world_size` slice of each step
from the packed shards. Where the JAX package assembles one global array per
field, here each rank yields its local batch, as a PyTorch
`DistributedSampler` feeds a DDP rank.

Determinism (the JAX package's contract, the same index stream):
  * one global permutation per epoch, seeded by (seed, epoch), identical on
    every rank, no communication;
  * the permutation is cut to `steps * global_batch` and carved as
    [steps, world_size, local_batch]; rank r takes lane r, so the lanes are
    disjoint and jointly cover the cut permutation.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.data.packed import PackedShardDataset, resolve_split, to_traffic_batch


class HostShardSampler:
    """Deterministic, disjoint, epoch-reshuffled per-rank index stream."""

    def __init__(self, num_samples: int, global_batch: int, host_id: int, num_hosts: int,
                 seed: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f"global_batch {global_batch} must divide by num_hosts {num_hosts}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} out of range [0, {num_hosts})")
        self.num_samples = num_samples
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.steps_per_epoch = num_samples // global_batch
        if self.steps_per_epoch == 0:
            raise ValueError(f"dataset of {num_samples} samples smaller than one global batch "
                             f"of {global_batch}")

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """[steps_per_epoch, local_batch] int64: this rank's sample indices."""
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self.num_samples)[: self.steps_per_epoch * self.global_batch]
        lanes = perm.reshape(self.steps_per_epoch, self.num_hosts, self.local_batch)
        return np.ascontiguousarray(lanes[:, self.host_id], dtype=np.int64)


def _process_group() -> tuple:
    """(rank, world_size) of the default process group, (0, 1) without one."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


class DistributedPackedLoader:
    """Endless iterator of this rank's local TrafficBatch, [global_batch /
    world_size, ...] on `device`. `rank` / `world_size` default to the
    default process group's ((0, 1) without one). Concatenated over the
    ranks in rank order, step s's local batches are the JAX package's global
    batch of step s."""

    def __init__(self, path: str, split: str = "train", global_batch_size: int = 128,
                 seed: int = 0, num_threads: int = 8, rank: Optional[int] = None,
                 world_size: Optional[int] = None, device="cuda", use_native: bool = True):
        self.ds = PackedShardDataset(resolve_split(path, split), num_threads=num_threads,
                                     use_native=use_native)
        pg_rank, pg_world = _process_group()
        self.rank = pg_rank if rank is None else rank
        self.world_size = pg_world if world_size is None else world_size
        self.sampler = HostShardSampler(self.ds.num_samples, global_batch_size, self.rank,
                                        self.world_size, seed=seed)
        self.global_batch_size = global_batch_size
        self.device = device

    def __iter__(self) -> Iterator[TrafficBatch]:
        epoch = 0
        while True:
            for step_idx in self.sampler.epoch_indices(epoch):
                yield to_traffic_batch(self.ds.gather(step_idx), self.device)
            epoch += 1
