"""The reader of ``full_train.batch_staged_share`` on span trees recorded
under a CPU profiler: 0 where the steps' ``sgd.batch`` spans carry no
``sgd.batch_staged`` counter (a program that stages nothing), the staged
share of the last ``odtpu::sgd`` root's steps where they do, and nothing
without a trace or without an ``sgd.batch`` span."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from online_detection_tpu_torch.utils import telemetry
from online_detection_tpu_torch.utils.telemetry import annotate, count

NAME = "full_train.batch_staged_share"


def _round(staged):
    """An ``sgd`` root with one step a value of ``staged`` (None: no
    counter)."""
    with annotate("sgd"):
        for s in staged:
            with annotate("sgd.batch"):
                if s is not None:
                    count("sgd.batch_staged", s)
            with annotate("sgd.upload"):
                pass


@pytest.mark.parametrize("staged, share", [
    ([None] * 32, 0.0),
    ([0] + [1] * 31, 96.875),
    ([0, 1, 1, 0], 50.0),
], ids=["no_counter", "31_of_32", "2_of_4"])
def test_batch_staged_share_reads_the_last_round(spec, staged, share):
    cell = "ycbv_full_train.step"
    metric = next(m for m in spec["per_layer"] if m["name"] == NAME)
    assert metric["workloads"] == [cell] and metric["unit"] == "%"
    run = {"cell": cell, "kind": "full_train", "trace": {"busy_s": 1.0}, "records": [],
           "traced_units": 1}
    read = harness.reader(NAME)
    telemetry._RECORDS.clear()
    try:
        assert read(run) is None
        with profile(activities=[ProfilerActivity.CPU]):
            _round([1, 1])
            with annotate("sgd"):  # a call that ran no step
                pass
        assert read(run) is None
        with profile(activities=[ProfilerActivity.CPU]):
            _round([1] * 8)
            _round(staged)
        assert read(run) == pytest.approx(share)
        assert read(dict(run, trace=None)) is None
    finally:
        telemetry._RECORDS.clear()
