"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Nothing moves
to the CPU on its own: on a host without a card, the caller must ask for the
CPU explicitly (the tests do), or the call raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
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


def to_device(a, dev: torch.device) -> torch.Tensor:
    """Host array (or tensor) -> tensor on ``dev``; onto the card through
    pinned memory, without a host wait."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def host_array(a) -> np.ndarray:
    """Tensor (on any device) or array-like -> NumPy array on the host."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def sync(dev: torch.device) -> None:
    """Waits for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
