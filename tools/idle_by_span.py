#!/usr/bin/env python3
"""Device idle of a traced run, put down to the program's spans.

    python3 tools/idle_by_span.py bench_out/<cell>-<seed>/trace.json.gz [--json out.json]

Reads a ``torch.profiler`` Chrome trace (``benchmark/run.py --trace 1``
exports one a run; ``ODTPU_PROFILE_DIR`` another), takes the union of the
card's kernel, copy and fill intervals, and labels every gap between them
with the outermost ``bench.`` range and the innermost ``odtpu::`` span
(``utils/telemetry.py::annotate``) open on the host at the gap's midpoint,
"none" where there is none. Prints the idle seconds by label, largest
first, with each ``bench.`` range's total, and each span's count and host
seconds; unlike the benchmark's ``breakdown.idle_gaps`` it counts every
gap and skips the host operations inside a span.
"""

from __future__ import annotations

import argparse
import bisect
import gzip
import json
import sys
from typing import Dict, List, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def load(path: str) -> List[Dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def gaps_of(events: List[Dict]) -> Tuple[List[Tuple[float, float]], float]:
    """(gaps between the union of device intervals, busy us)."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    gaps, busy, end = [], 0.0, None
    for s, t in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        busy += max(0.0, t - max(s, end if end is not None else s))
        end = t if end is None else max(end, t)
    return gaps, busy


def idle_by_span(events: List[Dict]) -> Dict:
    gaps, busy = gaps_of(events)
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    bench = [r for r in ranges if r[2].startswith("bench.")]
    prog = sorted(r for r in ranges if r[2].startswith("odtpu::"))
    starts = [r[0] for r in prog]

    def label(mid: float) -> str:
        outer = [r for r in bench if r[0] <= mid <= r[1]]
        head = min(outer)[2] if outer else "bench.none"
        for s, t, name in reversed(prog[:bisect.bisect_right(starts, mid)]):
            if t >= mid:  # spans nest: the latest start that holds mid is the innermost
                return head + "/" + name
        return head + "/none"

    by: Dict[str, float] = {}
    for s, t in gaps:
        key = label(0.5 * (s + t))
        by[key] = by.get(key, 0.0) + (t - s) / 1e6
    per_bench: Dict[str, float] = {}
    for key, sec in by.items():
        head = key.split("/")[0]
        per_bench[head] = per_bench.get(head, 0.0) + sec
    spans: Dict[str, List[float]] = {}
    for s, t, name in prog:
        rec = spans.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (t - s) / 1e6
    return {"busy_s": busy / 1e6, "idle_s": sum(by.values()), "gaps": len(gaps),
            "by_bench": dict(sorted(per_bench.items(), key=lambda kv: -kv[1])),
            "by_span": [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])],
            "span_s": spans}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    out = idle_by_span(load(args.trace))
    print(f"busy {out['busy_s']:.4f} s, idle {out['idle_s']:.4f} s in {out['gaps']} gaps")
    for head, sec in out["by_bench"].items():
        print(f"{head}: {sec:.4f} s idle")
    for key, sec in out["by_span"]:
        print(f"  {key}: {sec:.4f} s")
    for name, (n, sec) in out["span_s"].items():
        print(f"{name}: {n} spans, {sec:.4f} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
