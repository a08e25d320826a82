"""The program's own spans of the traced round, for the per-layer readers.

The port records a span (``utils/telemetry.py::annotate``) only while a
``torch.profiler`` session records, so the spans in its buffer after a run
are those of the traced round. A program without the spans reads as none.
"""

from __future__ import annotations

from typing import List


def traced_root(run, name: str) -> List:
    """The last recorded root span ``name`` of the program and its
    descendants (``SpanRecord``s: ``name``, ``start_ns``, ``end_ns``,
    ``counts``), or [] without a trace or without the program's spans."""
    if not run["trace"]:
        return []
    try:
        from online_detection_tpu_torch.utils.telemetry import last_root
    except ImportError:
        return []
    return last_root(name)
