"""Batch iterators (port of `cld_tpu/data/loader.py`): a small pool of
procedurally generated batches, cycled, or packed shards written by the
offline converter (`data.convert`), read by `data.packed.PackedShardLoader`.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Union

from cld_tpu_torch.data.batch import TrafficBatch
from cld_tpu_torch.data.packed import PackedShardLoader
from cld_tpu_torch.data.synthetic import synthetic_batch


class SyntheticLoader:
    """Cycles a pool of `pool_size` synthetic batches (seeds `seed`,
    `seed + 1`, ...), generated on first use and kept on `device`."""

    def __init__(self, batch_size: int = 32, raster_size: int = 224, pool_size: int = 8,
                 seed: int = 0, device="cuda", **kwargs):
        self.batch_size = batch_size
        self.raster_size = raster_size
        self.pool_size = pool_size
        self.seed = seed
        self.device = device
        self.kwargs = kwargs
        self._pool: List[TrafficBatch] = []

    def _ensure_pool(self) -> None:
        while len(self._pool) < self.pool_size:
            self._pool.append(synthetic_batch(
                seed=self.seed + len(self._pool), batch_size=self.batch_size,
                raster_size=self.raster_size, device=self.device, **self.kwargs))

    def __iter__(self) -> Iterator[TrafficBatch]:
        self._ensure_pool()
        return itertools.cycle(self._pool)

    def take(self, n: int) -> List[TrafficBatch]:
        it = iter(self)
        return [next(it) for _ in range(n)]


def make_loader(config, split: str = "train",
                device="cuda") -> Union[SyntheticLoader, PackedShardLoader]:
    """Loader from a config: synthetic batches when `train.data_path` is
    None or "synthetic", else the packed shards under it (`<path>/<split>`,
    or a flat dataset at the root). The validation split draws other seeds
    (10,000 against 0): on a flat dataset equal seeds would replay the
    training samples."""
    data_path = config.train.get("data_path")
    tr = config.train
    batch_size = tr.training.batch_size if split == "train" else tr.validation.batch_size
    seed = 0 if split == "train" else 10_000
    if data_path not in (None, "synthetic"):
        return PackedShardLoader(data_path, split=split, batch_size=batch_size, seed=seed,
                                 device=device)
    return SyntheticLoader(
        batch_size=batch_size,
        raster_size=config.env.rasterizer.raster_size,
        hist_frames=config.algo.history_num_frames,
        horizon=config.algo.future_num_frames,
        seed=seed,
        device=device,
    )
