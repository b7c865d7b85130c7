"""Experiment management (port of `cld_tpu/utils/experiment.py`): config
sweeps, one config per combination of the swept values, and checkpoint
lookup by key."""

from __future__ import annotations

import itertools
import os
from typing import Iterator, List, Sequence, Tuple

from cld_tpu_torch.utils.config import Config


class ParamRange:
    """One swept parameter: dotted config path, values, and the alias that
    names it in a run's name (the path's last part by default)."""

    def __init__(self, path: str, values: Sequence, alias: str | None = None):
        self.path = path
        self.values = list(values)
        self.alias = alias or path.split(".")[-1]


class ParamSearchPlan:
    """Cartesian-product sweep over `ParamRange`s."""

    def __init__(self, base_config: Config, ranges: Sequence[ParamRange]):
        self.base = base_config
        self.ranges = list(ranges)

    def _set_path(self, cfg: Config, path: str, value):
        node = cfg
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value

    def generate(self) -> Iterator[Tuple[str, Config]]:
        """Yields (run_name, locked config) per combination; the name joins
        `alias=value` of each range with '_'."""
        for combo in itertools.product(*(r.values for r in self.ranges)):
            cfg = Config(self.base.to_dict())
            name_parts = []
            for r, v in zip(self.ranges, combo):
                self._set_path(cfg, r.path, v)
                name_parts.append(f"{r.alias}={v}")
            yield "_".join(name_parts), cfg.lock()


def find_checkpoint(root_dir: str, key: str = "final") -> str:
    """The checkpoint under `root_dir` whose name starts with `ckpt` and
    contains `key`: a file of `torch.save` (the port's `ckpt_final`) or a
    directory; the last in sorted path order when several match."""
    matches: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root_dir):
        for name in dirnames + filenames:
            if name.startswith("ckpt") and key in name:
                matches.append(os.path.join(dirpath, name))
    if not matches:
        raise FileNotFoundError(f"no checkpoint matching {key!r} under {root_dir}")
    return sorted(matches)[-1]
