"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``pwcnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled, at first use, into ``build/pwcnet_tpu_torch/lib<name>-<hash>.so``
at the root of the checkout (the hash is of the source and of every
``csrc/*.cuh`` header, so an edited source or header is rebuilt).
``build_all`` starts one ``nvcc`` per source, all at once, and waits;
``start`` starts the given ones at once and returns, so that a model built
on the card compiles the kernels it launches side by side while it sets
up, and ``load_library`` waits for each when first asked for it.
A build failure raises; nothing falls back.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pwcnet_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Compiles that ``start`` began and no ``load_library`` has finished yet.
_pending: Dict[str, tuple] = {}
# nvcc's output per kernel built in this process (ptxas: registers, spills).
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    path = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha1()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start compiling ``name`` unless it is built; returns (target, job)."""
    out = _target(name)
    if out.exists():
        return out, None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (name, proc, tmp, cmd)


def _finish(out: Path, job) -> None:
    if job is None:
        return
    name, proc, tmp, cmd = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)


def _take(name: str):
    """(target, job) of ``name``: the compile ``start`` began, else a new
    one (job None where the target is built)."""
    return _pending.pop(name, None) or _start(name)


def _stop(job) -> None:
    if job is not None and job[1].poll() is None:
        job[1].kill()
        job[1].wait()


def start(names: Iterable[str]) -> None:
    """Start compiling each of ``names`` that is not built, all at once,
    and return without waiting. A compile that no ``load_library`` takes
    is stopped when the process exits."""
    with _lock:
        for name in names:
            if name not in _libs and name not in _pending:
                out, job = _start(name)
                if job is not None:
                    _pending[name] = (out, job)


@atexit.register
def _stop_pending() -> None:
    while _pending:
        _, (_, job) = _pending.popitem()
        _stop(job)
        job[2].unlink(missing_ok=True)


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> float:
    """Compile every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        jobs = [_take(n) for n in kernel_names()]
        try:
            for out, job in jobs:
                _finish(out, job)
        finally:  # after a failure, stop the compilers still running
            for _, job in jobs:
                _stop(job)
    return time.perf_counter() - t0


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy when its data is not 16-byte aligned: for the
    tensors that a kernel stages in 16-byte copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out, job = _take(name)
            _finish(out, job)
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
