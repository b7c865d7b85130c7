"""Packed-shard dataset (port of `cld_tpu/data/packed.py`): the offline
converter's output, read by a batched index gather.

Format (a directory), the same bytes as the JAX package's, so shards
written by either package load in the other:

    meta.json   {"version": 1, "fields": {name: {"shape": [...], "dtype": "..."}},
                 "num_samples": N}
    <field>.bin raw C-order array [N, *shape]

Reading is served by the native reader `cld_tpu_torch/native/shard_reader.cpp`
(mmap + thread-pool memcpy, no GIL), compiled with `g++ -O3 -shared -fPIC
-lpthread` into `cld_tpu_torch/_build/` at first use, never at import. The
one departure from the JAX package: there, a reader that fails to build or
to open a field falls back to a numpy memmap without a word. Here
`use_native=True` (the default) raises, naming the compiler, and the numpy
memmap path runs only when the caller passes `use_native=False`.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from cld_tpu_torch.data.batch import TrafficBatch

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "shard_reader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

# the JAX package's TrafficBatch field order: `write_batches` writes the
# fields in it, so that both packages write the same meta.json
SHARD_FIELD_ORDER = (
    "image", "drivable_map", "raster_from_agent", "history_positions", "history_yaws",
    "history_availabilities", "curr_speed", "target_positions", "target_yaws",
    "target_availabilities", "extent", "all_other_agents_future_positions",
    "all_other_agents_future_availability", "all_other_agents_history_positions",
    "all_other_agents_history_yaws", "all_other_agents_history_availability",
    "world_from_agent", "agent_from_world", "scene_index", "history_speeds", "sim_step",
    "lane_points", "lane_avail",
)

_NATIVE_LIB: Optional[ctypes.CDLL] = None


def native_library_path(build_dir: Optional[Path] = None) -> Path:
    """The reader's shared library in `build_dir` (default `BUILD_DIR`),
    named by a hash of its source, compiler and flags (a changed source
    builds anew)."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(NATIVE_SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libshard_reader_{h.hexdigest()[:16]}.so"


def build_native(build_dir: Optional[Path] = None) -> Path:
    """Compile the reader into `build_dir` (default `BUILD_DIR`; a no-op
    when the library for the current source exists). Raises RuntimeError
    naming the compiler when it is missing or fails."""
    so = native_library_path(build_dir)
    if so.exists():
        return so
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(f"the native shard reader needs the C++ compiler {CXX!r}, which is "
                           "not on PATH; pass use_native=False to read with numpy memmaps")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC), "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the native shard reader with {CXX!r} failed:\n"
                           f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def native_lib() -> ctypes.CDLL:
    """The loaded native reader, built on first call."""
    global _NATIVE_LIB
    if _NATIVE_LIB is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.shard_open.restype = ctypes.c_void_p
        lib.shard_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.shard_num_samples.restype = ctypes.c_int64
        lib.shard_num_samples.argtypes = [ctypes.c_void_p]
        lib.shard_gather.restype = ctypes.c_int
        lib.shard_gather.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
        lib.shard_close.restype = None
        lib.shard_close.argtypes = [ctypes.c_void_p]
        _NATIVE_LIB = lib
    return _NATIVE_LIB


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def write_packed(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write a field dict (each [N, ...]) as a packed-shard directory."""
    os.makedirs(path, exist_ok=True)
    num = None
    meta = {"version": 1, "fields": {}}
    for name, arr in fields.items():
        arr = np.ascontiguousarray(_numpy(arr))
        if num is None:
            num = arr.shape[0]
        if arr.shape[0] != num:
            raise ValueError(f"{name}: {arr.shape[0]} samples, the first field has {num}")
        arr.tofile(os.path.join(path, f"{name}.bin"))
        meta["fields"][name] = {"shape": list(arr.shape[1:]), "dtype": str(arr.dtype)}
    meta["num_samples"] = int(num)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def write_batches(path: str, batches) -> None:
    """Pack a list of TrafficBatch into shards: each field present in the
    batches, stacked over samples, in the JAX package's field order."""
    fields: Dict[str, list] = {}
    for b in batches:
        for name in SHARD_FIELD_ORDER:
            val = getattr(b, name)
            if val is not None:
                fields.setdefault(name, []).append(_numpy(val))
    write_packed(path, {k: np.concatenate(v, axis=0) for k, v in fields.items()})


class PackedShardDataset:
    """Random-access gather over a packed-shard directory: the native reader
    (`use_native=True`, built at first use; a failed build or open raises)
    or numpy memmaps (`use_native=False`)."""

    def __init__(self, path: str, num_threads: int = 8, use_native: bool = True):
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.path = path
        self.num_samples = self.meta["num_samples"]
        self.num_threads = num_threads
        self._lib = native_lib() if use_native else None
        self._handles: Dict[str, int] = {}
        self._mmaps: Dict[str, np.memmap] = {}
        for name, info in self.meta["fields"].items():
            fpath = os.path.join(path, f"{name}.bin")
            dtype = np.dtype(info["dtype"])
            sample_bytes = int(np.prod(info["shape"], dtype=np.int64)) * dtype.itemsize
            if self._lib is not None:
                h = self._lib.shard_open(fpath.encode(), sample_bytes)
                if not h:
                    self.close()
                    raise OSError(f"the native shard reader (built with {CXX}) could not open "
                                  f"{fpath}")
                self._handles[name] = h
            else:
                self._mmaps[name] = np.memmap(fpath, dtype=dtype, mode="r",
                                              shape=(self.num_samples, *info["shape"]))

    @property
    def uses_native(self) -> bool:
        return bool(self._handles)

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """{field: [len(indices), *shape]} for the given sample indices;
        IndexError on an index outside [0, num_samples)."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        out = {}
        for name, info in self.meta["fields"].items():
            if name in self._handles:
                buf = np.empty((len(indices), *info["shape"]), dtype=np.dtype(info["dtype"]))
                rc = self._lib.shard_gather(
                    self._handles[name], indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(indices), buf.ctypes.data_as(ctypes.c_char_p), self.num_threads)
                if rc != 0:
                    raise IndexError(f"shard_gather failed for field {name}")
                out[name] = buf
            else:
                out[name] = np.asarray(self._mmaps[name][indices])
        return out

    def close(self) -> None:
        for h in self._handles.values():
            self._lib.shard_close(h)
        self._handles.clear()


def resolve_split(path: str, split: str) -> str:
    """`<path>/<split>` when that directory exists, else `path` itself when
    it holds a flat dataset (meta.json); otherwise FileNotFoundError listing
    the subdirectories (reading the root in place of an unknown split would
    evaluate on training data)."""
    split_path = os.path.join(path, split)
    if os.path.isdir(split_path):
        return split_path
    if os.path.isfile(os.path.join(path, "meta.json")):
        return path
    subdirs = sorted(d for d in os.listdir(path)
                     if os.path.isdir(os.path.join(path, d))) if os.path.isdir(path) else []
    raise FileNotFoundError(f"no split {split!r} under {path!r} and no flat dataset (meta.json) "
                            f"at the root; available subdirs: {subdirs}")


def to_traffic_batch(raw: Dict[str, np.ndarray], device) -> TrafficBatch:
    """The TrafficBatch fields of a gathered sample dict, as tensors on
    `device` (other fields, such as `scene_ts`, are dropped)."""
    return TrafficBatch(**{k: torch.from_numpy(v).to(device) for k, v in raw.items()
                           if k in TrafficBatch._fields})


class PackedShardLoader:
    """Endless iterator of TrafficBatch drawn uniformly with replacement:
    batch i gathers `np.random.default_rng(seed).integers(0, n, batch_size)`'s
    i-th draw, as the JAX loader does, so the same seed gives the same
    batches; the tensors land on `device`."""

    def __init__(self, path: str, split: str = "train", batch_size: int = 128, seed: int = 0,
                 num_threads: int = 8, device="cuda", use_native: bool = True):
        self.ds = PackedShardDataset(resolve_split(path, split), num_threads=num_threads,
                                     use_native=use_native)
        self.batch_size = batch_size
        self.seed = seed
        self.device = device

    def __iter__(self) -> Iterator[TrafficBatch]:
        rng = np.random.default_rng(self.seed)
        n = self.ds.num_samples
        while True:
            yield to_traffic_batch(self.ds.gather(rng.integers(0, n, self.batch_size)),
                                   self.device)
