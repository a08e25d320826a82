"""Cells, configurations, traffic mixes, their kinds, limits and per-layer metrics are
found by name, and BENCHMARK.json keeps to its contract's shape."""

import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KIND_API = ("setup", "window", "run_fields", "extra", "check", "control")


def test_every_cell_finds_its_files(spec):
    for wl in spec["workloads"]:
        _, _, mix = harness.cell_spec(spec, wl["name"])
        assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").is_file()
        kind = harness.kind_of(mix["kind"])
        assert all(isinstance(k, str) for k in kind.KERNELS)
        assert all(callable(getattr(kind, f)) for f in KIND_API)
        limits = harness.limits_of(wl["name"])
        assert limits and all(v >= 0 for v in limits.values())
        assert wl["chips"] == 1


def test_every_metric_has_a_reader(spec):
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_cells_report_their_metrics(spec):
    for wl in spec["workloads"]:
        e2e, per = harness.metrics_of(spec, wl["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert per and all(m["moves"] in names for m in per)


def test_contract_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    assert spec["paths"] == ["benchmark"]
    for e in spec["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024


def test_unknown_cell_is_refused(spec):
    with pytest.raises(KeyError):
        harness.cell_spec(spec, "no.such.cell")


def test_reader_returns_nothing_without_a_trace(spec):
    _, cfg, mix = harness.cell_spec(spec, "icwt30.teach")
    run = {"cell": "icwt30.teach", "kind": "teach", "cfg": cfg, "mix": mix, "trace": None,
           "records": [], "traced_units": 0, "pools": None}
    for m in spec["per_layer"]:
        assert harness.reader(m["name"])(run) is None
