"""Reduction of a ``torch.profiler`` trace to what the per-layer readers and
the result line take: device time by kernel name, the busy time (the union
of the device's kernel intervals), the longest device operations and the
idle gaps by what the host was doing.

The benchmark's own spans (``span``: ``record_function`` ranges named
``bench.<layer>``, opened around its calls into each layer) name the gaps.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Tuple

import torch


@contextlib.contextmanager
def span(name: str):
    with torch.profiler.record_function("bench." + name):
        yield


def reduce(prof, wall_s: float) -> Dict:
    """A finished trace of a window of ``wall_s`` seconds -> kernel time by
    name (seconds, launches), busy seconds, top device operations and idle
    gaps."""
    dev_events, host_events = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the benchmark's spans show on the device's timeline too: not work
            if getattr(e, "is_user_annotation", False) or e.name.startswith("bench."):
                continue
            dev_events.append(e)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host_events.append(e)
    by_name: Dict[str, List[float]] = {}
    spans = []
    for e in dev_events:
        s, t = e.time_range.start, e.time_range.end
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (t - s) / 1e6
        rec[1] += 1
        spans.append((s, t))
    spans.sort()
    busy_us, end, gaps = 0.0, None, []
    for s, t in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        busy_us += max(0.0, t - max(s, end if end is not None else s))
        end = t if end is None else max(end, t)
    bench = [(e.time_range.start, e.time_range.end, e.name) for e in host_events
             if e.name.startswith("bench.")]
    ops_r = sorted((e.time_range.start, e.time_range.end, e.name) for e in host_events
                   if not e.name.startswith("bench."))
    starts = [r[0] for r in ops_r]

    def host_doing(mid):
        """The outermost benchmark span and the innermost host operation
        open at ``mid`` (the search looks back over the last 500 starts)."""
        outer = [r for r in bench if r[0] <= mid <= r[1]]
        label = min(outer, key=lambda r: r[0])[2] if outer else "bench.none"
        inner = None
        i = bisect.bisect_right(starts, mid)
        for s, t, name in reversed(ops_r[max(0, i - 500):i]):
            if t >= mid and (inner is None or t - s < inner[1] - inner[0]):
                inner = (s, t, name)
        return label + "/" + (inner[2] if inner else "idle")

    gap_by: Dict[str, float] = {}
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        key = host_doing(0.5 * (s + t))
        gap_by[key] = gap_by.get(key, 0.0) + (t - s) / 1e6
    ops = sorted(((k, v[0]) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return {"kernels": {k: (v[0], v[1]) for k, v in by_name.items()},
            "busy_s": busy_us / 1e6, "window_s": wall_s,
            "device_ops": [[k, v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in sorted(gap_by.items(), key=lambda kv: -kv[1])[:10]]}


def kernel_s(reduced: Dict, *parts: str) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose names hold any of
    ``parts``."""
    s, n = 0.0, 0
    for name, (sec, count) in reduced["kernels"].items():
        if any(p in name for p in parts):
            s += sec
            n += count
    return s, n


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))
