"""Timing, logging and tracing (counterpart of ``utils/telemetry.py``).

The reference's observability is wall-clock ``Timer``s
(``engine/inference.py:379-400``), a ``MetricLogger`` with ETA and peak
device memory (``engine/trainer.py:66,116-133``), ``setup_logger`` with an
environment dump, and ``result.txt`` as the canonical artifact. This module
gives the port the same surface, with ``torch.profiler`` traces and ranges
(``profile_trace``, ``annotate``) in place of ``jax.profiler``'s.

``annotate`` is also the program's span: while a ``torch.profiler`` session
records in this process, each span is an ``odtpu::<name>`` range on the
trace's timeline and a record in a bounded buffer (``last_root`` reads it),
and ``count`` adds to the innermost open span. With no session recording
both cost one flag check.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import logging
import os
import sys
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler


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


PREFIX = "odtpu::"
_RECORDS: deque = deque(maxlen=1 << 16)  # closed spans, each after its children
_ids = itertools.count()
_local = threading.local()  # the open spans of each thread


def _recording() -> bool:
    """Whether a ``torch.profiler`` session records in this process (a
    process-wide flag, set in every thread)."""
    return _autograd_profiler._is_profiler_enabled


class SpanRecord(NamedTuple):
    """A closed span: ``parent`` and ``root`` are span indices (``parent``
    None for a root), times are ``time.perf_counter_ns``, ``counts`` what
    ``count`` added while it was the innermost open span; ``self_ns`` (set
    by ``last_root``) is its duration less what its children cover."""
    index: int
    name: str
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]
    self_ns: int = 0


class _Open:
    __slots__ = ("index", "name", "parent", "root", "start_ns", "counts")

    def __init__(self, name: str, parent: Optional["_Open"]):
        self.index = next(_ids)
        self.name = name
        self.parent = None if parent is None else parent.index
        self.root = self.index if parent is None else parent.root
        self.counts: Dict[str, int] = {}
        self.start_ns = time.perf_counter_ns()


def _stack() -> List[_Open]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class annotate:
    """Span ``name`` (``with annotate("harvest.load"):``): while a
    ``torch.profiler`` session records, a ``record_function`` range named
    ``odtpu::<name>`` (a name that already starts with ``odtpu::`` keeps it)
    and a ``SpanRecord`` nested under the thread's innermost open span;
    otherwise nothing. An exception raised inside the block closes the span
    and goes through."""

    __slots__ = ("name", "_range", "_open")

    def __init__(self, name: str):
        self.name = name[len(PREFIX):] if name.startswith(PREFIX) else name
        self._open = None

    def __enter__(self):
        if not _recording():
            return self
        stack = _stack()
        self._range = _autograd_profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._open = _Open(self.name, stack[-1] if stack else None)
        stack.append(self._open)
        return self

    def __exit__(self, *exc):
        o = self._open
        if o is None:
            return False
        end = time.perf_counter_ns()
        _stack().pop()  # ``with`` blocks close in the order opposite to their opening
        self._range.__exit__(*exc)
        self._open = None
        _RECORDS.append(SpanRecord(o.index, o.name, o.parent, o.root, o.start_ns, end,
                                   o.counts))
        return False


def count(name: str, n: int = 1):
    """Adds ``n`` to counter ``name`` of this thread's innermost open span
    while a profiler session records (nothing otherwise, or with no span
    open). ``n`` must be a value the host already holds: a count never reads
    the device."""
    if not _recording():
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + n


def last_root(name: str) -> List[SpanRecord]:
    """The last recorded root span named ``name`` and its descendants, in
    order of start, each with its self time; [] when there is none."""
    name = name[len(PREFIX):] if name.startswith(PREFIX) else name
    records = list(_RECORDS)
    root = next((r for r in reversed(records) if r.parent is None and r.name == name), None)
    if root is None:
        return []
    tree = [r for r in records if r.root == root.index]
    covered: Dict[int, int] = {}
    for r in tree:
        if r.parent is not None:
            covered[r.parent] = covered.get(r.parent, 0) + r.end_ns - r.start_ns
    return sorted((r._replace(self_ns=r.end_ns - r.start_ns - covered.get(r.index, 0))
                   for r in tree), key=lambda r: (r.start_ns, r.index))
