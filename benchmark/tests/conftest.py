"""Shared set-up of the benchmark's own tests.

Run from the root of the repository:

    python -m pytest benchmark/tests -q            # on any host (CPU)
    python -m pytest benchmark/tests -q -m chip    # the card's tests, on the card

The CPU tests drive the harness end to end on cells shrunk by ``tiny``
(full channel widths, one block a stage, 96x128 canvases, a dozen images)
with the program's plain kernel versions and its trunk in bf16, as on the
card.
"""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips where there is none")


@pytest.fixture(autouse=True)
def _bf16_trunk(monkeypatch):
    monkeypatch.setenv("ODTPU_COMPUTE_DTYPE", "bfloat16")


@pytest.fixture(scope="session")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny(spec, workload):
    """Overrides that shrink a cell to a CPU test's size (widths kept)."""
    from benchmark.harness import cell_spec

    _, cfg, mix = cell_spec(spec, workload)
    t = dict(cfg["train"], iterations=2, batch_size=40, rpn_m=16, det_m=16, segm_m=8,
             rpn_pos_cap=64, det_pos_cap=32, coxy_cap=256, segm_pos_cap=256,
             segm_batch_size=200)
    d = dict(cfg["detector"], pre_nms_top_n=60, post_nms_top_n=20, detections_per_img=10)
    return {"stages": [1, 1, 1, 1], "train": t, "detector": d, "min_size": 96, "max_size": 128,
            "teach_images": 12, "batch": 4, "image_hw": [96, 128], "canvas_hw": [96, 128],
            "object_sides": [24, 48], "check_images": 4, "probe_rows": 8, "check_neg_batches": 1}


@pytest.fixture
def tiny_of(spec):
    return lambda workload: tiny(spec, workload)
