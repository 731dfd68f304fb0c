"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every `csrc/*.cu` source compiles into one shared library with a plain C
interface (no PyTorch headers, so the build takes seconds): one nvcc per
source, all started together, then one link. The library lands in
`build/torch_kernels/` at the repository root, under a file name that
carries a hash of the sources, headers and flags, so a stale build is
never loaded;
ptxas's report (registers, shared memory, spills of every kernel) goes to a
`.log` beside it. A file lock serialises concurrent builds. If nvcc is
missing or fails, the error carries nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from yolo_from_scratch_tpu_torch.utils.metrics_log import span

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no FMA contraction: the NMS IoU must round like unfused torch ops;
    # the conv backward writes its FMAs out with __fmaf_rn
    "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (not on PATH, CUDA_HOME or /usr/local/cuda): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources, headers and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyolo_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Start every command at once; raise with the first failure's stderr.
    Returns the commands' stderr, joined."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        outs.append((cmd, proc.returncode, err))
    for cmd, rc, err in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n"
                               f"{err}")
    return "".join(err for _, _, err in outs)


def build() -> tuple[Path, float]:
    """Compile the sources if the hashed library is absent. Returns (path,
    seconds spent compiling, 0.0 when the library was already built). The
    span `kernels.build` times a compile (none when the library is
    there)."""
    target = library_path()
    if target.exists():
        return target, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            return target, 0.0
        tag = f"{target.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        try:
            with span("kernels.build"):
                log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                 str(s)] for s, o in zip(_sources(), objs)])
                _run_all([[nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        os.replace(tmp, target)
    return target, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every exported
    function's argtypes and restype declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nms_keep_mask_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                      ctypes.c_float, ptr]
    lib.nms_keep_mask_f32.restype = i32
    lib.nms_max_boxes.argtypes = []
    lib.nms_max_boxes.restype = i32
    lib.nms_geometry.argtypes = [i32, i32, ptr]
    lib.nms_geometry.restype = i32
    lib.nms_error_string.argtypes = [i32]
    lib.nms_error_string.restype = ctypes.c_char_p
    lib.conv3x3_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                i32, i32, ptr]
    lib.conv3x3_bwd.restype = i32
    lib.conv3x3_bwd_error_string.argtypes = [i32]
    lib.conv3x3_bwd_error_string.restype = ctypes.c_char_p
    for name in ("conv_bwd_patch", "conv_bwd_tap"):
        getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        getattr(lib, name).restype = i32
    for name in ("conv3x3_bwd", "conv_bwd_patch", "conv_bwd_tap",
                 "chain_bwd"):
        getattr(lib, f"{name}_geometry").argtypes = [i32, ptr]
        getattr(lib, f"{name}_geometry").restype = i32
    lib.chain_bwd.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
    lib.chain_bwd.restype = i32
    lib.int8_conv.argtypes = [ptr] * 5 + [i32] * 12 + [ptr]
    lib.int8_conv.restype = i32
    lib.int8_conv_geometry.argtypes = [i32] * 8 + [ptr]
    lib.int8_conv_geometry.restype = i32
    lib.quant_input.argtypes = ([ptr, i32] + [ctypes.c_longlong] * 4
                                + [i32] * 5 + [ctypes.c_float, ptr, ptr])
    lib.quant_input.restype = i32
    lib.int8_conv_error_string.argtypes = [i32]
    lib.int8_conv_error_string.restype = ctypes.c_char_p
    lib.letterbox_u8.argtypes = [ptr, i32, i32, i32, ptr, ptr]
    lib.letterbox_u8.restype = i32
    lib.letterbox_error_string.argtypes = [i32]
    lib.letterbox_error_string.restype = ctypes.c_char_p
    return lib
