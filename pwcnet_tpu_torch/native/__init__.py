"""The port's native host decoder (``decoder.cc``), bound with ``ctypes``:
the counterpart of ``pwcnet_tpu/native``, for the ``Loader``'s fast path
on FlyingChairs records (.ppm, .ppm, .flo).

At first use ``load`` compiles the source with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``build/pwcnet_tpu_torch/libpwcnative-<hash>.so``
at the root of the checkout (the hash is of the source). Where ``g++`` or
the build fails, ``load`` returns None and ``BUILD_ERROR`` says why; the
``Loader`` logs it and decodes in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decoder.cc"
BUILD_DIR = SOURCE.parents[2] / "build" / "pwcnet_tpu_torch"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_ERROR: Optional[str] = None


def _target() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libpwcnative-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                    "-pthread", str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True, text=True, timeout=300)
    os.replace(tmp, out)  # atomic: concurrent builds leave one file


def load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None when it cannot be built."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _tried:
            return _lib
        _tried = True
        out = _target()
        try:
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except subprocess.CalledProcessError as e:
            BUILD_ERROR = f"g++ failed ({e.returncode}): {e.stderr[-2000:]}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.pwc_decode_batch.argtypes = ([ctypes.POINTER(ctypes.c_char_p)] * 3
                                         + [ctypes.c_int] * 4 + [f32p] * 4)
        lib.pwc_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def decode_batch(im1_paths: Sequence[str], im2_paths: Sequence[str],
                 flow_paths: Sequence[str], hw: Tuple[int, int],
                 num_threads: int = 8) -> Dict[str, np.ndarray]:
    """Decode n (.ppm, .ppm, .flo) samples on ``num_threads`` threads into
    f32 im1, im2 (n, H, W, 3), flow (n, H, W, 2) and valid (n, H, W), each
    sample center-cropped or zero-padded (invalid) to ``hw``."""
    lib = load()
    if lib is None:
        raise RuntimeError(f"the native decoder is unavailable: "
                           f"{BUILD_ERROR}")
    n = len(im1_paths)
    if not n == len(im2_paths) == len(flow_paths):
        raise ValueError("decode_batch takes as many im2 and flow paths as "
                         "im1 paths")
    th, tw = hw
    out = {"im1": np.empty((n, th, tw, 3), np.float32),
           "im2": np.empty((n, th, tw, 3), np.float32),
           "flow": np.empty((n, th, tw, 2), np.float32),
           "valid": np.empty((n, th, tw), np.float32)}

    def paths(ps):
        return (ctypes.c_char_p * n)(*[os.fsencode(p) for p in ps])

    ptrs = [out[k].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            for k in ("im1", "im2", "flow", "valid")]
    rc = lib.pwc_decode_batch(paths(im1_paths), paths(im2_paths),
                              paths(flow_paths), n, th, tw, num_threads,
                              *ptrs)
    if rc:
        raise IOError(f"native batch decode failed (code {rc}: 1 = a file "
                      "could not be read, 2 = one could not be decoded)")
    return out
