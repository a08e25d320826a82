"""Timing, logging and tracing (counterpart of ``utils/telemetry.py``).

The reference's observability is wall-clock ``Timer``s
(``engine/inference.py:379-400``), ``setup_logger`` with an environment dump,
and ``result.txt`` as the canonical artifact. This module gives the port the
same surface, with ``torch.profiler`` traces in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Optional


class Timer:
    """Cumulative timer (reference ``Timer``: total_time / calls / avg)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self._start = None

    def tic(self):
        self._start = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._start
        self.total_time += dt
        self.calls += 1
        return dt

    @property
    def average_time(self) -> float:
        return self.total_time / max(self.calls, 1)

    @contextlib.contextmanager
    def time_this(self):
        self.tic()
        try:
            yield
        finally:
            self.toc()


def setup_logger(name: str, save_dir: Optional[str] = None,
                 filename: str = "log.txt") -> logging.Logger:
    """Console+file logger with env echo (``setup_logger`` contract)."""
    import torch

    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    logger.info("torch %s (cuda %s); device: %s", torch.__version__, torch.version.cuda,
                device)
    return logger


def teardown_logger(name: str):
    """Handler teardown between pipeline stages (the reference does this by
    hand, ``extract_features_rpn_detector.py:189-190``)."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace of the block (host, and the card where there
    is one), written to ``log_dir/trace.json`` as a Chrome trace. No-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
