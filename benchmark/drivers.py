"""What every kind of traffic mix shares: the streams drawn from the run's
seed, a device sync, and the measured window.

A kind's own set-up, window, readings and control sit in
``kinds/<kind>.py`` (see ``README.md``). Its window runs one unit of work
at a time through ``measure``. With ``trace`` the first units of the
window run under ``torch.profiler``; the window then goes on until at
least one unit ran outside the trace, whose wall times the readers take.
"""

from __future__ import annotations

import hashlib
import time

import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def measure(seconds: float, trace: bool, unit, units_traced: int):
    """Runs ``unit(i)`` until ``seconds`` have passed at a unit boundary;
    with ``trace`` the first ``units_traced`` units run under the profiler
    and the window holds at least one unit after them. Returns (window
    seconds, units, (profile, its wall seconds) or None, indices of the
    traced units)."""
    prof_red, traced = None, []
    start = time.perf_counter()
    i = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(units_traced):
                unit(i)
                traced.append(i)
                i += 1
            wall = time.perf_counter() - t0
        prof_red = (prof, wall)
    while True:
        if time.perf_counter() - start >= seconds and i > len(traced):
            break
        unit(i)
        i += 1
    return time.perf_counter() - start, i, prof_red, traced
