"""One run of one cell: set-up, the measured window, the per-layer readers,
the check, and the result line.

Everything a cell is made of is found by name: the configuration's file
(``configs/<config>.json``, named in ``BENCHMARK.json``), the traffic mix
(``traffic/<traffic>.json``; its ``kind`` picks the set-up and window in
``drivers.py``), each per-layer metric's reader (``metrics/<metric>.py``,
with a ``read(run)`` that returns a number or None) and the cell's limits
(``limits/<cell>.json``).
"""

from __future__ import annotations

import importlib.util
import json
import logging
import math
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import drivers, judge, tracing
from benchmark.reference import forward as ref
from benchmark.reference import train as ref_train

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


def reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + re.sub(r"[^0-9A-Za-z_]", "_", name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- the check

def check(setup: drivers.Setup, out: Dict) -> Dict[str, float]:
    """The numbers compared for this run (see ``judge.py``)."""
    seed, dev, cfg, mix = setup.seed, setup.dev, setup.cfg, setup.mix
    rng = np.random.default_rng(drivers.derive(seed, "check"))
    p = out["products"]
    pools = ref_train.pools_of(p["state"])
    prog = ref.models_of(p["online"])
    del p["online"]
    refm = judge.reference_models(pools, cfg["train"], drivers.derive(seed, "train", p["round"]),
                                  dev)
    return judge.teach_readings(setup.w, setup.teach, mix, cfg["train"], pools, p["batches"],
                                prog, refm, rng, dev)


def limits_of(workload: str) -> Dict[str, float]:
    return load_json(BENCH / "limits" / f"{workload}.json")


# ---------------------------------------------------------------- a run

def device_info(dev: torch.device, peak: int) -> Dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def pool_rows(state) -> Dict[str, int]:
    """Valid rows of the pools the counts of the training need (a host read
    after the window)."""
    return {"coxy": int(state.det_coxy.counts.sum()),
            "rpn_pos": 0 if state.rpn_pos is None else int(state.rpn_pos.counts.sum()),
            "det_neg_fill": [int(c) for c in state.det_neg.counts.tolist()]}


def run_cell(spec: Dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[Dict] = None) -> Tuple[Dict, List[str]]:
    """-> (the result line's object, the lines of numbers compared)."""
    wl, cfg, mix = cell_spec(spec, workload)
    for key, val in (overrides or {}).items():  # tests shrink a cell to the CPU
        (cfg if key in cfg else mix)[key] = val
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the pools' saturation is recorded in the result (``extra``), not logged
    logging.getLogger("online_detection_tpu_torch.device_pipeline").setLevel(logging.ERROR)
    setup = drivers.Setup(cfg, mix, seed, dev)
    kind = mix["kind"]
    out = drivers.DRIVERS[kind](setup, seconds, trace)
    log(f"set-up {out['t_first'] - t_start:.1f} s, window {out['window_s']:.1f} s, "
        f"{out['units']} units")
    e2e_defs, per_defs = metrics_of(spec, workload)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    metrics, extra = {}, {}
    if not trace:
        vals = dict(out["e2e"], setup_s=out["t_first"] - t_start)
        for m in e2e_defs:  # ``teach_s.icwt30`` is ``teach_s``, reported in its own cell
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
        run = {"cell": workload, "kind": kind, "cfg": cfg, "mix": mix, "trace": red,
               "records": out["records"], "traced_units": len(out["traced"]),
               "pools": pool_rows(out["products"]["state"])}
        for m in per_defs:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra["pool_fill"] = pool_rows(out["products"]["state"])["det_neg_fill"]
    extra["truncation"] = out["records"][-1]["truncation"]
    units = out["units"]
    t_check = time.time()
    readings = check(setup, out)
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
