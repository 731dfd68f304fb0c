"""ctypes bindings for the port's native data-loading library (counterpart
of `yolo_from_scratch_tpu/native/__init__.py`): `yolodata.cc`, libjpeg /
libpng decode, letterbox and normalize a batch in a thread pool.

The library is built at first use with g++ and the JAX package's Makefile
flags into `build/torch_native/` at the repository root, never into either
package's directory, under a file name that carries a hash of the source
and the flags, so a stale build is never loaded. A file lock serialises
concurrent builds (several test workers, several ranks), and each build
writes a temporary file that is renamed into place. A failed build keeps
the compiler's stderr: `available()` is then False, and
`decode_letterbox_batch` (the dataset's `backend="native"`) raises with
it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("yolodata.cc")
BUILD_DIR = SOURCE.parents[2] / "build" / "torch_native"
CXX = "g++"
# yolo_from_scratch_tpu/native/Makefile's CXXFLAGS and LDLIBS
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib = None
_error = None


def library_path(build_dir=BUILD_DIR) -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LD_LIBS)).encode())
    h.update(SOURCE.read_bytes())
    return Path(build_dir) / f"libyolodata_{h.hexdigest()[:16]}.so"


def build(build_dir=BUILD_DIR) -> Path:
    """Compile the library if the hashed file is absent; return its path.
    Raises RuntimeError with the compiler's stderr when g++ or a header
    or library is missing."""
    target = library_path(build_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            return target
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [CXX, *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE),
               *LD_LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native loader build failed: {' '.join(cmd)}"
                               f"\n{e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native loader build failed (exit "
                               f"{proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, target)
    return target


def load(path) -> ctypes.CDLL:
    """Open a built library and declare its batch function."""
    lib = ctypes.CDLL(str(path))
    lib.yd_decode_letterbox_batch.restype = ctypes.c_int
    lib.yd_decode_letterbox_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,                     # n
        ctypes.c_int,                     # target
        ctypes.POINTER(ctypes.c_float),   # out
        ctypes.POINTER(ctypes.c_float),   # scales
        ctypes.POINTER(ctypes.c_int32),   # pad_tops
        ctypes.POINTER(ctypes.c_int32),   # pad_lefts
        ctypes.c_int,                     # n_threads
    ]
    return lib


def _load():
    """The library of this process, built and opened once; None after a
    failed build (its error in `_error`)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = load(build())
            except (RuntimeError, OSError) as e:
                _error = str(e)
        return _lib


def available() -> bool:
    """True when the library builds and loads here."""
    return _load() is not None


def decode_letterbox_batch(paths, target_size: int, n_threads: int = 4):
    """Decode + letterbox + normalize a batch of image files natively.

    Returns (images (N, S, S, 3) float32 [0,1], scales (N,) float32,
    pad_tops (N,) int32, pad_lefts (N,) int32, n_failures int). Failed
    decodes leave an all-gray canvas with scale 0."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    n = len(paths)
    out = np.empty((n, target_size, target_size, 3), np.float32)
    scales = np.empty(n, np.float32)
    pad_tops = np.empty(n, np.int32)
    pad_lefts = np.empty(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.yd_decode_letterbox_batch(
        ctypes.cast(c_paths, ctypes.POINTER(ctypes.c_char_p)),
        n,
        target_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pad_tops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pad_lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(n_threads),
    )
    return out, scales, pad_tops, pad_lefts, int(failures)

