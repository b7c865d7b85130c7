"""Build and bind the port's CUDA kernels (`cld_tpu_torch/csrc/*.cu`).

Route: ``nvcc`` compiles each source to an object, all sources at once in
parallel, for ``sm_90a`` (``-gencode arch=compute_90a,code=sm_90a -O3``),
links them into one shared library with a plain C interface, and
``ctypes`` loads it. The build happens at first use, never at import, into
``cld_tpu_torch/_build/`` (listed in ``.gitignore``), under a file name that
carries a hash of the sources and flags, so a changed source rebuilds.

Every kernel wrapper counts its launches here: `count_launch` adds one where
a wrapper launches its kernel and nowhere else; `launch_counts` /
`reset_launch_counts` read and clear the counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

KERNELS = ("lstm2_fwd", "lstm2_bwd", "bit_gather", "value_gather", "drivable_gather",
           "rigid_min", "rigid_min_fused", "rigid_bwd", "offroad_count", "disk_collision",
           "lstm2_fwd_bf16", "lstm2_bwd_bf16", "lstm2_fwd_wide", "lstm2_bwd_wide",
           "lstm2_fwd_wide_bf16", "lstm2_bwd_wide_bf16", "dma_probe")
_LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
_LIB: Optional[ctypes.CDLL] = None


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels of cld_tpu_torch cannot be built"
    )


def _run(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(procs) -> None:
    failed = []
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcld_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source in parallel and link one shared library; a no-op
    when the library for the current sources already exists."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c", str(src), "-o", str(obj)]
        procs.append((cmd, _run(cmd)))
        objs.append(obj)
    _wait(procs)
    tmp = so.with_suffix(f".{tag}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)]
    _wait([(cmd, _run(cmd))])
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cld_lstm2_fwd.argtypes = [p] * 8 + [i] * 4 + [p]
        lib.cld_lstm2_fwd_bf16.argtypes = [p] * 8 + [i] * 3 + [p]
        lib.cld_lstm2_bwd.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.cld_lstm2_bwd_bf16.argtypes = [p] * 13 + [i] * 4 + [p]
        lib.cld_lstm2_attributes.argtypes = [i, i, i, p]
        lib.cld_lstm2_attributes_bf16.argtypes = [i, i, p]
        lib.cld_lstm2_wide_fwd_bf16.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.cld_lstm2_wide_fwd_bf16_query.argtypes = [i] * 3 + [p]
        lib.cld_lstm2_wide_bwd.argtypes = [p] * 13 + [i] * 6 + [p]
        lib.cld_lstm2_wide_chain_query.argtypes = [i] * 4 + [p]
        lib.cld_lstm2_wide_attributes.argtypes = [i, i, i, i, p]
        lib.cld_lstm2_wide_fwd_f32.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.cld_lstm2_wide_fwd_f32_query.argtypes = [i] * 3 + [p]
        for fn in (lib.cld_lstm2_fwd, lib.cld_lstm2_fwd_bf16, lib.cld_lstm2_bwd,
                   lib.cld_lstm2_bwd_bf16, lib.cld_lstm2_attributes,
                   lib.cld_lstm2_attributes_bf16, lib.cld_lstm2_wide_fwd_bf16,
                   lib.cld_lstm2_wide_bwd, lib.cld_lstm2_wide_attributes,
                   lib.cld_lstm2_wide_fwd_f32, lib.cld_lstm2_wide_fwd_f32_query,
                   lib.cld_lstm2_wide_fwd_bf16_query,
                   lib.cld_lstm2_wide_chain_query):
            fn.restype = i
        lib.cld_bit_gather.argtypes = [p] * 3 + [i, i, i, i, p]
        lib.cld_bit_gather.restype = i
        lib.cld_value_gather.argtypes = [p] * 3 + [i, i, i, i, i, p]
        lib.cld_value_gather.restype = i
        lib.cld_value_gather_attributes.argtypes = [i, i, p]
        lib.cld_value_gather_attributes.restype = i
        for fn in (lib.cld_drivable_gather_i8, lib.cld_drivable_gather_f32):
            fn.argtypes = [p] * 3 + [i] * 5 + [p]
            fn.restype = i
        lib.cld_drivable_gather_attributes.argtypes = [i, i, p]
        lib.cld_drivable_gather_attributes.restype = i
        lib.cld_rigid_min.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.cld_rigid_min.restype = i
        lib.cld_rigid_min_fused.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.cld_rigid_min_fused.restype = i
        lib.cld_rigid_min_attributes.argtypes = [i, i, p]
        lib.cld_rigid_min_attributes.restype = i
        lib.cld_rigid_bwd.argtypes = [p] * 5 + [i, i, p]
        lib.cld_rigid_bwd.restype = i
        lib.cld_rigid_bwd_attributes.argtypes = [i, p]
        lib.cld_rigid_bwd_attributes.restype = i
        lib.cld_offroad_count.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.cld_offroad_count.restype = i
        lib.cld_offroad_count_attributes.argtypes = [p]
        lib.cld_offroad_count_attributes.restype = i
        lib.cld_disk_collision.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.cld_disk_collision.restype = i
        lib.cld_disk_collision_attributes.argtypes = [i, p]
        lib.cld_disk_collision_attributes.restype = i
        lib.cld_dma_probe.argtypes = [p, p] + [i] * 3 + [p]
        lib.cld_dma_probe.restype = i
        lib.cld_dma_probe_attributes.argtypes = [p]
        lib.cld_dma_probe_attributes.restype = i
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def attributes(fn, *args, n: int = 3) -> list:
    """What a `cld_*_attributes` query writes: registers and local memory
    bytes (spills) per thread, max threads per block (and, for the n = 4
    queries, shared memory bytes per block)."""
    out = (ctypes.c_int * n)()
    check(fn(*args, ctypes.addressof(out)), "kernel attributes")
    return list(out)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape, layout."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
