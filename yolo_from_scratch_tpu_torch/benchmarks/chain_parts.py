"""Where the chain backward kernel K5 (`csrc/chain_bwd.cu`) spends its
time on the card.

The card's profilers that see inside a kernel do not run there, so this
builds the kernel source once as it is and once for each part of a
tile's work left out (`VARIANTS`), each into its own library under
`build/chain_parts/`, and times each through `blockbwd`'s wrapper at the
training path's two bf16 shapes (B=8, 40x40 and 80x80), in two rounds.
A variant's results are wrong by design; only its device time means
anything: the full kernel's time less a variant's is what the part costs
(where the part sets the pace). ptxas's registers and spills of each
variant are printed beside it.

Usage (on the machine with the card; each variant's nvcc runs in
parallel):
    python -m yolo_from_scratch_tpu_torch.benchmarks.chain_parts [variant ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import re
import shutil
import subprocess

import torch

from yolo_from_scratch_tpu_torch.benchmarks import blockbwd
from yolo_from_scratch_tpu_torch.device import cuda_device
from yolo_from_scratch_tpu_torch.kernels.build import (
    BUILD_DIR,
    CSRC_DIR,
    NVCC_FLAGS,
    find_nvcc,
)
from yolo_from_scratch_tpu_torch.utils.timing import device_ms, log

SOURCE = "chain_bwd.cu"
OUT_DIR = BUILD_DIR.parent / "chain_parts"
# variant: (what it leaves out, [(line of SOURCE, its replacement)]); each
# line occurs once in SOURCE (tests/test_torch_blockbwd.py holds that)
VARIANTS = {
    "full": ("nothing", []),
    "no A dz2": ("block A's dz2 = bf16(dy * s2) in place", [(
        "  for (int g = threadIdx.x; g < kR2Bytes / 16; g += tt::kThreads) {",
        "  for (int g = threadIdx.x; g < 0; g += tt::kThreads) {")]),
    "no A dw2": ("block A's dw2 products", [(
        "  tt::dw_tile<kR2W, 2>(acc_w, a1h, dz2h, warp, lane);", "")]),
    "no A da1": ("block A's da1 and dz1 (both row blocks)", [
        ("  {  // rows 64 wg", "  if (false) {  // rows 64 wg"),
        ("  {  // rows 128 ..", "  if (false) {  // rows 128 ..")]),
    "no A ring rows 128+": ("block A's third row block of da1 and dz1", [
        ("  {  // rows 128 ..", "  if (false) {  // rows 128 ..")]),
    "no B silu'": ("silu'(z1) in block B's pass over A's ring (its loads, "
                   "stores and signal stay)", [(
        "      const float sig = 1.0f / (1.0f + expf(-z[e]));\n"
        "      grad[e] = sig * (1.0f + z[e] * (1.0f - sig));",
        "      grad[e] = z[e];")]),
    "no B dw1": ("block B's dw1 products", [(
        "  tt::dw_tile<tt::kHaloW, 1>(acc_w, xh, dz1h, warp, lane);", "")]),
    "no A tile": ("all of block A's tile but its TMA wait", [(
        "        conv2_tile(smem, s, pair + s * n_pairs, tiles, full, grad_ready,\n"
        "                   partner_dz1 + (s & 1) * tt::kHaloPitch, s1, s2, h, w, acc_w);",
        "        hop::mbar_wait(&full[s & 1], (s >> 1) & 1);")]),
    "no B tile": ("all of block B's own tile but its TMA wait (silu' stays)", [(
        "        conv1_tile(smem, s - 1, pair + (s - 1) * n_pairs, tiles, full, dy, dx, h, "
        "w, acc_w);",
        "        hop::mbar_wait(&full[(s - 1) & 1], ((s - 1) >> 1) & 1);")]),
}
# all of both blocks' work: what is left is the loads, the steps' cluster
# barriers and the fixed cost of a call
VARIANTS["no tiles"] = (
    "all of both blocks' work but their TMA waits",
    VARIANTS["no A tile"][1] + VARIANTS["no B tile"][1] + [(
        "      if (s < mine) silu_grad_ring(smem, s, zfull, partner_grad, grad_ready, "
        "rank - 1);",
        "      if (s < mine) hop::mbar_wait(&zfull[s & 1], (s >> 1) & 1);")])

REGISTERS = re.compile(r"Used (\d+) registers")
SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def variant_source(name, text):
    """SOURCE's text with variant `name`'s lines replaced; raises if a line
    is not there exactly once."""
    for old, new in VARIANTS[name][1]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old.strip()!r} occurs {text.count(old)} "
                             f"times in {SOURCE}")
        text = text.replace(old, new)
    return text


def build_variants(names):
    """{name: (ctypes library, ptxas summary)}: every variant compiled at
    once, each from a copy of `csrc/` with its lines replaced."""
    nvcc, procs = find_nvcc(), {}
    for name in names:
        d = OUT_DIR / re.sub(r"\W+", "_", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC_DIR, d)
        (d / SOURCE).write_text(variant_source(name, (d / SOURCE).read_text()))
        procs[name] = (d, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{err}")
        # ptxas reports the bf16 tile kernel after its "chain_bwd_bf16" entry
        tail = err[err.index("chain_bwd_bf16"):]
        regs, spills = REGISTERS.search(tail)[1], SPILLS.search(tail).groups()
        lib = ctypes.CDLL(str(d / "lib.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_bwd.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.chain_bwd.restype = i32
        lib.chain_bwd_geometry.argtypes = [i32, ptr]
        lib.chain_bwd_geometry.restype = i32
        lib.conv3x3_bwd_error_string = lambda rc: b"error (chain_parts)"
        libs[name] = (lib, f"{regs} registers, spill stores/loads "
                           f"{spills[0]}/{spills[1]} bytes")
    return libs


@contextlib.contextmanager
def _library(lib):
    """blockbwd's wrapper launching from `lib` instead of the port's."""
    real = blockbwd.launch_env
    blockbwd.launch_env = lambda x: (lib, *real(x)[1:])
    try:
        yield
    finally:
        blockbwd.launch_env = real


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", metavar="variant",
                    help=f"any of {list(VARIANTS)} (default: all)")
    a = ap.parse_args(argv)
    unknown = [n for n in a.variants if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; choose from {list(VARIANTS)}")
    names = ["full", *(n for n in a.variants or VARIANTS if n != "full")]
    dev = cuda_device()
    log(f"device: {torch.cuda.get_device_name(dev)}")
    libs = build_variants(names)
    for name in names:
        log(f"{name} (leaves out {VARIANTS[name][0]}): {libs[name][1]}")
    for h in (80, 40):
        x, w1, w2, s1, s2, dy = blockbwd._inputs(8, h, h, torch.bfloat16, dev)
        with torch.no_grad():
            z1, a1, _ = blockbwd.chain_fwd(x, w1, w2, s1, s2)
        args = (x, z1, a1, dy, w1, w2, s1, s2)
        times = {}
        for _ in range(2):
            for name in names:
                with _library(libs[name][0]):
                    times.setdefault(name, []).append(
                        device_ms(lambda: blockbwd._launch(*args)))
        for name in names:
            ms = times[name]
            log(f"8x{h}x{h} bf16 {name}: " + " / ".join(f"{t:.4f}" for t in ms)
                + f" ms (profiler, two rounds); full less this "
                f"{(times['full'][0] - ms[0]) * 1e3:+.1f} us")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
