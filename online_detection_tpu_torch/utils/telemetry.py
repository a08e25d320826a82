"""Timing, logging and tracing (counterpart of ``utils/telemetry.py``).

The reference's observability is wall-clock ``Timer``s
(``engine/inference.py:379-400``), a ``MetricLogger`` with ETA and peak
device memory (``engine/trainer.py:66,116-133``), ``setup_logger`` with an
environment dump, and ``result.txt`` as the canonical artifact. This module
gives the port the same surface, with ``torch.profiler`` traces in place of
``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import sys
import time
from collections import defaultdict, deque
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


class SmoothedValue:
    """Windowed median and average (maskrcnn-benchmark's metric smoothing)."""

    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Training-loop metrics with ETA and peak device memory
    (``engine/trainer.py:116-133`` contract)."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
                                   for name, m in self.meters.items())

    def log_line(self, iteration: int, max_iter: int) -> str:
        eta_sec = self.meters["time"].global_avg * (max_iter - iteration)
        eta = str(datetime.timedelta(seconds=int(eta_sec)))
        mem = device_memory_mb()
        mem_str = f"  max mem: {mem:.0f}MB" if mem else ""
        return f"eta: {eta}  iter: {iteration}  {self}{mem_str}"


def device_memory_mb() -> Optional[float]:
    """Peak memory allocated on the card since the last
    ``torch.cuda.reset_peak_memory_stats`` (``torch.cuda.max_memory_allocated``),
    in MB; None on a host without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.cuda.max_memory_allocated() / 1e6


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
