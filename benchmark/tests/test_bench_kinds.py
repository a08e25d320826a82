"""A new kind of traffic is added by new files and entries alone: a copy of
the benchmark takes a toy kind (its configuration has no ``train`` key, its
products no pools, its check readings of its own) with its mix,
configuration, limits and one per-layer reader, and runs it through
``run_cell`` and ``control.readings`` with no file of the copy edited."""

import hashlib
import json
import shutil
import subprocess
import sys

from benchmark.tests.conftest import ROOT

TOY_KIND = '''"""A toy kind: the square of one float64 matrix made from the seed."""

import time

import numpy as np
import torch

from benchmark.drivers import derive, measure, sync

KERNELS = []


class Setup:
    def __init__(self, cfg, seed, dev):
        self.cfg, self.dev = cfg, torch.device(dev)
        g = torch.Generator(device=self.dev).manual_seed(derive(seed, "toy"))
        self.a = torch.randn(cfg["n"], cfg["n"], generator=g, device=self.dev,
                             dtype=torch.float64)


def setup(cfg, mix, seed, dev):
    return Setup(cfg, seed, dev)


def window(s, seconds, trace):
    last = {}

    def unit(i):
        last["square"] = s.a @ s.a
        sync(s.dev)

    unit(-1)
    t_first = time.time()
    win_s, n, prof, traced = measure(seconds, trace, unit, 1)
    return {"t_first": t_first, "window_s": win_s, "units": n, "records": [{}] * n,
            "profile": prof, "traced": traced, "e2e": {"toy_s": win_s / n},
            "products": last}


def run_fields(s, out):
    return {"squares": out["units"]}


def extra(s, out):
    return {"squares": out["units"]}


def check(s, out):
    a = s.a.cpu().numpy()
    want = a @ a
    got = out["products"]["square"].double().cpu().numpy()
    return {"toy_gap": float(np.abs(got - want).max() / np.abs(want).max()),
            "toy_n": float(s.cfg["n"])}


def control(cfg, mix, seed, side, dev):
    s = setup(cfg, mix, seed, dev)
    a = s.a if side == "program" else s.a.float()
    return check(s, {"products": {"square": a @ a}})
'''

TOY_READER = '''"""toy.squares: squares made in the window."""


def read(run):
    return float(run["squares"]) if run["trace"] else None
'''

DRIVE = '''
import json, time
from benchmark.control import readings
from benchmark.harness import run_cell
from benchmark.run import result_lines

spec = json.load(open("BENCHMARK.json"))
out = {}
for trace in (0, 1):
    result, lines = run_cell(spec, "toy.square", 2**31 + 11, 0.3, bool(trace), "cpu",
                             time.time())
    out[f"trace{trace}"] = [json.loads(l) for l in result_lines(result, lines)[0]]
    out[f"err{trace}"] = result_lines(result, lines)[1]
for side in ("program", "control"):
    out[side] = readings(spec, "toy.square", 2**31 + 11, side, "cpu")
print(json.dumps(out))
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_kind_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _digests(bench)

    (bench / "kinds" / "toy.py").write_text(TOY_KIND)
    (bench / "metrics" / "toy.squares.py").write_text(TOY_READER)
    (bench / "configs" / "toy.json").write_text(json.dumps({"n": 48}))
    (bench / "traffic" / "toy.json").write_text(json.dumps({"kind": "toy"}))
    (bench / "limits" / "toy.square.json").write_text(json.dumps({"toy_gap": 1e-12}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(spec))
    spec["configs"].append({"name": "toy", "source": "https://example.org/toy",
                            "file": "benchmark/configs/toy.json", "reduced": [],
                            "why": "a toy"})
    spec["workloads"].append({"name": "toy.square", "config": "toy", "traffic": "toy",
                              "chips": 1, "why": "a toy"})
    spec["end_to_end"].append({"name": "toy_s", "unit": "s", "better": "lower", "bound": 0.05,
                               "source": "host_clock", "workloads": ["toy.square"]})
    spec["per_layer"].append({"name": "toy.squares", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "toy", "moves": "toy_s",
                              "workloads": ["toy.square"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    p = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])

    plain, traced = out["trace0"][-1], out["trace1"][-1]
    for last in (plain, traced):
        assert list(last)[-1] == "check" and last["correct"] is True
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
        assert set(last["check"]) == {"toy_gap"} and last["attempted"] >= 1
    assert set(plain["metrics"]) == {"toy_s", "setup_s"}
    assert set(traced["metrics"]) == {"toy.squares"}
    assert traced["metrics"]["toy.squares"]["value"] >= 1
    assert {"busy_s", "window_s"} <= set(traced["device"])
    extra = out["trace0"][0]["extra"]
    assert extra["squares"] == plain["attempted"] and extra["readings"] == {"toy_n": 48.0}
    assert out["err0"] == [f"check toy_gap: {plain['check']['toy_gap']['value']!r} "
                           "(limit 1e-12)"]
    # the program's side passes its limit; float32 in its place does not
    assert out["program"]["toy_gap"] <= 1e-12 < out["control"]["toy_gap"]

    after = _digests(bench)
    assert {k: after.get(k) for k in before} == before
    # BENCHMARK.json only took entries: each list keeps the old ones first
    assert all(spec[k][:len(v)] == v if isinstance(v, list) else spec[k] == v
               for k, v in old.items())
