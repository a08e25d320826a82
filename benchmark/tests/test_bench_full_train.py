"""The ``full_train`` kind and its cell ``ycbv_full_train.step``: a run
shrunk to the CPU (full widths, one block a stage, 96x128 scenes, rounds
of 2 steps, 16 RoIs a step) gives the result line's shape traced and
untraced and leaves every file the benchmark had before it as it was; the
control's two sides read; three faults planted in the program each fail a
limit, on the CPU at the shrunk size and, on a card, at the cell's own
size (``-m chip``)."""

import hashlib
import json
import math

import pytest
import torch

from benchmark.harness import cell_spec, limits_of, run_cell
from benchmark.run import result_lines
from benchmark.tests.conftest import ROOT

CELL = "ycbv_full_train.step"
SEED = 2**31 + 2021
CONTROL_SEEDS = (3100000401, 3100000402, 3100000403)

# sha256 (first 16 hex digits) of every file under benchmark/ before the
# full_train kind was added
BEFORE = {
    "README.md": "747da0efa399dd6e",
    "configs/icwt30.json": "3a4a50ace8e5de7e",
    "configs/ycbv.json": "e4d0da71bf0bcfe6",
    "control.py": "d3fd654b2cdbeb7b",
    "drivers.py": "debe07b14bc65fc3",
    "flops.py": "c23c16e0c454325a",
    "harness.py": "8e3a9bcff49ce940",
    "judge.py": "f2b6897f28cb5c5c",
    "kinds/teach.py": "a656c63fdbe0e1ea",
    "limits/icwt30.teach.json": "1ff9f98daab34b56",
    "limits/ycbv.teach.json": "c5abd78293ca281e",
    "metrics/b1.roofline.teach.icwt30.py": "24a8d01cf12a0a3b",
    "metrics/b1.roofline.teach.py": "9f0fd31d40761a82",
    "metrics/b4.roofline.teach.icwt30.py": "b44e0d434ece585c",
    "metrics/b4.roofline.teach.py": "fad4451f9e7474ba",
    "metrics/teach.harvest_host_ms_per_image.icwt30.py": "8080ea7bac69785c",
    "metrics/teach.harvest_host_ms_per_image.py": "5a6d429e3c628b86",
    "metrics/teach.harvest_ms_per_image.icwt30.py": "f8c44d64f7c6b852",
    "metrics/teach.harvest_ms_per_image.py": "4c2b5daa294ba593",
    "metrics/teach.idle_share.icwt30.py": "77be7a6aff9ea1f5",
    "metrics/teach.idle_share.py": "ae86c87c01764858",
    "metrics/teach.mfu.icwt30.py": "3c11daab60da5ecf",
    "metrics/teach.mfu.py": "b67201ea0004624c",
    "metrics/teach.nms_sweeps_per_batch.icwt30.py": "00088c2531801330",
    "metrics/teach.nms_sweeps_per_batch.py": "7e894b230e3d6807",
    "metrics/teach.train_s.icwt30.py": "10ff8828021178c3",
    "metrics/teach.train_s.py": "8e15242a51673174",
    "reference/forward.py": "3394e371702b67bf",
    "reference/train.py": "cf77a6c0f9a29019",
    "run.py": "a3f935afc579a1af",
    "spans.py": "c44cf49d25a7aefb",
    "tests/conftest.py": "5596aa012dd92253",
    "tests/test_bench_control.py": "424b53bdb83ae4da",
    "tests/test_bench_counts.py": "480eea8a3fa05d9a",
    "tests/test_bench_faults.py": "24c69b5e3ebffa92",
    "tests/test_bench_imports.py": "d2afe7acee6ea2a1",
    "tests/test_bench_kinds.py": "88762ea336c3e330",
    "tests/test_bench_reference.py": "00b43590348ded21",
    "tests/test_bench_run.py": "63e07f272453ab2e",
    "tests/test_bench_spans.py": "669ef6f37cd56749",
    "tests/test_bench_spec.py": "469e4563caee38fc",
    "tests/test_bench_traffic.py": "fcb894bf2eab69c0",
    "tracing.py": "6d047cffa3efb82a",
    "traffic.py": "a558a44b47cd7dd3",
    "traffic/teach.json": "831757ee10415dd5",
    "weights.py": "bf4bbbf40ebf31d8",
}


def shrunk(spec):
    _, cfg, _ = cell_spec(spec, CELL)
    return {"stages": [1, 1, 1, 1], "min_size": 96, "max_size": 128, "images": 6,
            "image_hw": [96, 128], "canvas_hw": [96, 128], "object_sides": [12, 28],
            "objects": [3, 5], "grid": [3, 4], "steps": 2,
            "sgd": dict(cfg["sgd"], roi_batch=16, post_nms_train=20)}


def _digests():
    bench = ROOT / "benchmark"
    return {k: hashlib.sha256((bench / k).read_bytes()).hexdigest()[:16]
            for k in BEFORE if (bench / k).is_file()}


@pytest.mark.parametrize("trace", [0, 1])
def test_shrunk_run_line_and_files(spec, trace):
    assert _digests() == BEFORE
    result, lines = run_cell(spec, CELL, SEED + trace, 0.1, bool(trace), "cpu", 0.0, shrunk(spec))
    out, err = result_lines(result, lines)
    last, extra = json.loads(out[-1]), json.loads(out[0])["extra"]
    assert list(last)[-1] == "check" and last["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    limits = limits_of(CELL)
    assert set(last["check"]) == set(limits) == {"loss_gap", "grad_gap", "update_gap",
                                                 "rpn_sample_off", "roi_sample_off"}
    assert len(err) == len(limits) and all(line.startswith("check ") for line in err)
    assert set(extra["readings"]) == {"iteration", "grad_norm"}
    # the judged step is the first of the last round: the run went on across rounds
    rounds = last["attempted"] + 1
    assert extra["iterations"] == 2 * rounds and len(extra["round_loss"]) == last["attempted"]
    assert extra["readings"]["iteration"] == 2 * (rounds - 1) > 0
    if trace:
        per = {m["name"] for m in spec["per_layer"] if CELL in m.get("workloads", [])}
        assert set(last["metrics"]) <= per
        # no device kernels on the CPU: the span, counter and host-clock readers read
        assert {"full_train.host_ms_per_step", "full_train.nms_sweeps_per_step",
                "full_train.mfu"} <= set(last["metrics"])
        assert last["metrics"]["full_train.nms_sweeps_per_step"]["value"] >= 1
        assert {"busy_s", "window_s"} <= set(last["device"])
    else:
        assert set(last["metrics"]) == {"teach_s", "setup_s"}
        assert all(m["value"] > 0 for m in last["metrics"].values())
    assert _digests() == BEFORE


def test_control_sides_read(spec):
    from benchmark.control import readings

    limits = limits_of(CELL)
    sides = {side: readings(spec, CELL, SEED, side, "cpu", shrunk(spec))
             for side in ("program", "control")}
    for r in sides.values():
        assert set(limits) <= set(r) and all(math.isfinite(r[k]) for k in limits)
    assert all(sides["program"][k] <= limits[k] for k in limits)
    assert sides["program"]["iteration"] == sides["control"]["iteration"] == 2


# ---------------------------------------------------------------- planted faults

def _b3_half(monkeypatch):
    """B3' (the RoIAlign backward) drops the gradient of every second RoI."""
    from online_detection_tpu_torch.ops import roi_align

    real = roi_align.roi_align_backward

    def broken(grad, rois, *args, **kwargs):
        keep = (torch.arange(grad.shape[1], device=grad.device) % 2 == 0).to(grad.dtype)
        return real(grad * keep[None, :, None, None, None], rois, *args, **kwargs)

    monkeypatch.setattr(roi_align, "roi_align_backward", broken)


def _no_mask_loss(monkeypatch):
    """The step leaves the mask loss out of its total."""
    from online_detection_tpu_torch.engine import losses

    real = losses.mask_head_loss
    monkeypatch.setattr(losses, "mask_head_loss", lambda *a, **k: real(*a, **k) * 0.0)


def _state_dropped(monkeypatch):
    """Each call restarts the optimizer and the iteration: momentum from
    zero, the learning rate and the image order from step 0."""
    from online_detection_tpu_torch.engine import trainer

    real = trainer.do_train

    def broken(params, dataset, canvas_hw, cfg, *args, run=None, **kwargs):
        if run is not None and run.started:
            cfg = cfg._replace(max_iter=cfg.max_iter - run.iteration)
            run.iteration = 0
            run.opt = torch.optim.SGD(run.trainable, lr=cfg.base_lr, momentum=cfg.momentum,
                                      weight_decay=cfg.weight_decay)
        return real(params, dataset, canvas_hw, cfg, *args, run=run, **kwargs)

    monkeypatch.setattr(trainer, "do_train", broken)


FAULTS = [_b3_half, _no_mask_loss, _state_dropped]
IDS = ["b3_backward_half", "mask_loss_left_out", "state_dropped"]


@pytest.mark.parametrize("plant", FAULTS, ids=IDS)
def test_fault_fails_a_limit(spec, monkeypatch, plant):
    plant(monkeypatch)
    result, _ = run_cell(spec, CELL, SEED, 0.1, False, "cpu", 0.0, shrunk(spec))
    assert result["correct"] is False, result["check"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("plant", FAULTS, ids=IDS)
def test_fault_fails_a_limit_at_the_cells_size(spec, monkeypatch, plant):
    _card()
    plant(monkeypatch)
    result, _ = run_cell(spec, CELL, SEED, 0.1, False, "cuda", 0.0)
    print(json.dumps({"fault": plant.__name__, "check": result["check"]}), flush=True)
    assert result["correct"] is False, result["check"]


@pytest.mark.chip
def test_control_fails_the_limits_at_the_cells_size(spec):
    _card()
    from benchmark.control import readings

    limits = limits_of(CELL)
    for seed in CONTROL_SEEDS:
        r = readings(spec, CELL, seed, "control", "cuda")
        assert any(not math.isfinite(r[k]) or r[k] > limits[k] for k in limits), (seed, r)
