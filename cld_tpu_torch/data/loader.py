"""Batch iterators (port of the synthetic branch of
`cld_tpu/data/loader.py`): a small pool of procedurally generated batches,
cycled. Packed shards are not ported yet (ROADMAP Queue A 11).
"""

from __future__ import annotations

import itertools
from typing import Iterator, List

from cld_tpu_torch.data.batch import TrafficBatch
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


def make_loader(config, split: str = "train", device="cuda") -> SyntheticLoader:
    """Loader from a config: synthetic batches when `train.data_path` is
    None or "synthetic"; the validation split draws other seeds."""
    data_path = config.train.get("data_path")
    if data_path not in (None, "synthetic"):
        raise NotImplementedError(
            f"train.data_path {data_path!r}: packed shards are not ported yet (ROADMAP Queue A "
            "11); use 'synthetic'")
    tr = config.train
    batch_size = tr.training.batch_size if split == "train" else tr.validation.batch_size
    return SyntheticLoader(
        batch_size=batch_size,
        raster_size=config.env.rasterizer.raster_size,
        hist_frames=config.algo.history_num_frames,
        horizon=config.algo.future_num_frames,
        seed=0 if split == "train" else 10_000,
        device=device,
    )
