"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Nothing moves
to the CPU on its own: on a host without a card, the caller must ask for the
CPU explicitly (the tests do), or the call raises.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


@contextlib.contextmanager
def ieee_fp32():
    """Float32 matmuls and convs run in IEEE fp32 (TF32 off) inside the block
    (or the decorated call); the process's own flags come back after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
