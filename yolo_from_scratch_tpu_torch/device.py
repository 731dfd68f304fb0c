"""Device selection and numerics switches.

The port takes its device explicitly everywhere; nothing here picks one
behind a caller's back.
"""

from __future__ import annotations

import contextlib

import torch


def cuda_device() -> torch.device:
    """The CUDA device, or RuntimeError. Never falls back to the CPU: a
    caller that asked for the card must not silently measure the host."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False "
            f"(torch {torch.__version__}, built for CUDA {torch.version.cuda})"
        )
    return torch.device("cuda")


def upload(t, device):
    """A CPU tensor on `device`, copied through pinned memory without
    waiting for the card (a copy from pageable memory may wait for it); on
    the CPU t itself. None stays None."""
    if t is None or torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def tf32_disabled():
    """Run float32 convolutions and matmuls in full float32.

    cuDNN runs float32 convolutions in TF32 by default
    (`torch.backends.cudnn.allow_tf32` is True), which keeps ~10 mantissa
    bits; float32 matmuls are full precision by default, but a caller may
    have changed that. The parity path against the CPU (or the JAX
    reference) turns both off; the previous settings come back on exit.
    """
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
