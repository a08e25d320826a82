"""``run.py`` as a check starts it: no result without a card or without
the port, and the shape of the result's last line."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT, tiny

ARGS = ["--workload", "ycbv.teach", "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"]


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_exits_nonzero_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_last_line_shape(spec):
    from benchmark.harness import run_cell
    from benchmark.run import result_lines

    result, lines = run_cell(spec, "icwt30.teach", 2**31 + 5, 0.5, False, "cpu", 0.0,
                             tiny(spec, "icwt30.teach"))
    out, err = result_lines(result, lines)
    last = json.loads(out[-1])
    assert list(last)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert set(last["metrics"]) == {"teach_s.icwt30", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(last["device"])
    assert set(last["check"]) == {"feat_gap", "neg_gap", "neg_count_off", "head_off", "rls_gap"}
    assert all(set(v) == {"value", "limit"} for v in last["check"].values())
    assert len(err) == 5 and all(line.startswith("check ") for line in err)
    assert last["correct"] is True and last["attempted"] >= 1


def test_traced_line_carries_the_per_layer_metrics(spec):
    from benchmark.harness import run_cell
    from benchmark.run import result_lines

    result, lines = run_cell(spec, "icwt30.teach", 2**31 + 6, 0.5, True, "cpu", 0.0,
                             tiny(spec, "icwt30.teach"))
    last = json.loads(result_lines(result, lines)[0][-1])
    per = {m["name"] for m in spec["per_layer"] if "icwt30.teach" in m["workloads"]}
    assert set(last["metrics"]) <= per
    # the CPU trace has no device kernels: the host-clock readers read
    assert {"teach.mfu.icwt30", "teach.train_s.icwt30"} <= set(last["metrics"])
    assert {"busy_s", "window_s"} <= set(last["device"])
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}


def test_teach_builds_the_four_libraries():
    """``run.py`` builds the kind's ``KERNELS`` before set-up: for ``teach``
    the libraries its rounds launch."""
    from benchmark.harness import kind_of

    assert kind_of("teach").KERNELS == ["gaussian_mmv", "stem_pool", "roi_align",
                                        "roi_align_fused2"]
