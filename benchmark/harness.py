"""One run of one cell: set-up, the measured window, the per-layer readers,
the check, and the result line.

Everything a cell is made of is found by name: the configuration's file
(``configs/<config>.json``, named in ``BENCHMARK.json``), the traffic mix
(``traffic/<traffic>.json``), the mix's kind (``kinds/<kind>.py``, which
makes the set-up, the window, the readers' inputs and the readings
compared), each per-layer metric's reader (``metrics/<metric>.py``, with a
``read(run)`` that returns a number or None) and the cell's limits
(``limits/<cell>.json``).
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import tracing

BENCH = Path(__file__).resolve().parent


def log(msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(spec: Dict, workload: str) -> Tuple[Dict, Dict, Dict]:
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    wl = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[wl["config"]]
    cfg = load_json(BENCH.parent / conf["file"])
    mix = load_json(BENCH / "traffic" / f"{wl['traffic']}.json")
    return wl, cfg, mix


def metrics_of(spec: Dict, workload: str) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and per-layer metrics this cell reports."""
    def here(m, moves_ok=True):
        return workload in m["workloads"] if "workloads" in m else moves_ok

    e2e = [m for m in spec["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if here(m, m["moves"] in names)]
    return e2e, per


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, loaded by its path."""
    mod_name = f"benchmark_{folder}_" + re.sub(r"[^0-9A-Za-z_]", "_", name)
    s = importlib.util.spec_from_file_location(mod_name, BENCH / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reader(name: str):
    return _module("metrics", name).read


def kind_of(name: str):
    """The module of a traffic mix's ``kind``: ``KERNELS``, ``setup``,
    ``window``, ``run_fields``, ``extra``, ``check`` and ``control`` (see
    ``README.md``)."""
    return _module("kinds", name)


def limits_of(workload: str) -> Dict[str, float]:
    return load_json(BENCH / "limits" / f"{workload}.json")


# ---------------------------------------------------------------- a run

def device_info(dev: torch.device, peak: int) -> Dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(spec: Dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[Dict] = None) -> Tuple[Dict, List[str]]:
    """-> (the result line's object, the lines of numbers compared)."""
    wl, cfg, mix = cell_spec(spec, workload)
    for key, val in (overrides or {}).items():  # tests shrink a cell to the CPU
        (cfg if key in cfg else mix)[key] = val
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kind = kind_of(mix["kind"])
    setup = kind.setup(cfg, mix, seed, dev)
    out = kind.window(setup, seconds, trace)
    log(f"set-up {out['t_first'] - t_start:.1f} s, window {out['window_s']:.1f} s, "
        f"{out['units']} units")
    e2e_defs, per_defs = metrics_of(spec, workload)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics = {}
    if not trace:
        vals = dict(out["e2e"], setup_s=out["t_first"] - t_start)
        for m in e2e_defs:  # ``<quantity>.<suffix>`` is ``<quantity>``, reported in its own cell
            metrics[m["name"]] = {"value": vals[m["name"].split(".")[0]], "unit": m["unit"]}
    red = None
    if trace:
        prof, wall = out["profile"]
        t_red = time.time()
        red = tracing.reduce(prof, wall)
        run_dir = BENCH.parent / "bench_out" / f"{workload}-{seed}"
        run_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(run_dir / "trace.json.gz"))
        log(f"trace reduced and written in {time.time() - t_red:.1f} s")
        run = {"cell": workload, "kind": mix["kind"], "cfg": cfg, "mix": mix, "trace": red,
               "records": out["records"], "traced_units": len(out["traced"]),
               **kind.run_fields(setup, out)}
        for m in per_defs:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = kind.extra(setup, out)
    units = out["units"]
    t_check = time.time()
    readings = kind.check(setup, out)
    del out
    log(f"check in {time.time() - t_check:.1f} s")
    limits = limits_of(workload)
    correct = all(math.isfinite(readings[k]) and readings[k] <= limits[k] for k in limits)
    extra["readings"] = {k: v for k, v in readings.items() if k not in limits}
    result = {"correct": bool(correct), "attempted": int(units), "failed": 0, "metrics": metrics, "device": device_info(dev, peak)}
    if red is not None:
        result["device"]["busy_s"] = red["busy_s"]
        result["device"]["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    result["extra"] = extra
    result["check"] = {k: {"value": readings[k] if math.isfinite(readings[k]) else "inf",
                           "limit": limits[k]} for k in limits}
    lines = [f"check {k}: {readings[k]!r} (limit {limits[k]!r})" for k in limits]
    return result, lines
