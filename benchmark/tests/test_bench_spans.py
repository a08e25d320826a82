"""The readers of the program's spans (``teach.harvest_host_ms_per_image``,
``teach.nms_sweeps_per_batch`` and their ``.icwt30`` twins) on spans
recorded under a CPU profiler: they read the last ``odtpu::harvest`` root
only, and nothing without a trace."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from online_detection_tpu_torch.utils import telemetry
from online_detection_tpu_torch.utils.telemetry import annotate, count


def _round(sweeps):
    """A harvest root with one batch a value of ``sweeps``."""
    with annotate("harvest"):
        for n in sweeps:
            with annotate("harvest.load"):
                with annotate("harvest.masks"):
                    pass
            with annotate("harvest.upload"):
                pass
            with annotate("harvest.trunk"):
                with annotate("trunk.propose"):
                    count("nms.sweeps", n)
        with annotate("harvest.finish"):
            pass


@pytest.mark.parametrize("cell", ["ycbv.teach", "icwt30.teach"])
def test_readers_take_the_last_round(spec, cell):
    _, cfg, mix = harness.cell_spec(spec, cell)
    run = {"cell": cell, "kind": "teach", "cfg": cfg, "mix": mix, "trace": {"busy_s": 1.0},
           "records": [], "traced_units": 1, "pools": None}
    suffix = "" if cell == "ycbv.teach" else ".icwt30"
    telemetry._RECORDS.clear()
    try:
        assert harness.reader("teach.nms_sweeps_per_batch" + suffix)(run) is None
        with profile(activities=[ProfilerActivity.CPU]):
            _round([9, 9])
            _round([3, 5, 7])
        assert harness.reader("teach.nms_sweeps_per_batch" + suffix)(run) == 5.0
        tree = telemetry.last_root("harvest")
        host_ns = sum(r.end_ns - r.start_ns for r in tree
                      if r.name in ("harvest.load", "harvest.upload"))
        got = harness.reader("teach.harvest_host_ms_per_image" + suffix)(run)
        assert got == pytest.approx(host_ns / 1e6 / mix["teach_images"]) and got > 0
        for name in ("teach.nms_sweeps_per_batch", "teach.harvest_host_ms_per_image"):
            assert harness.reader(name + suffix)(dict(run, trace=None)) is None
    finally:
        telemetry._RECORDS.clear()
