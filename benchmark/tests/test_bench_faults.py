"""Each fault a cell can have, planted under a run at a tiny size on the
CPU (the harness's look for a card skipped), turns ``correct`` false under
the cell's own limits; the same run without it is correct."""

import pytest
import torch

from benchmark.harness import run_cell
from benchmark.tests.conftest import tiny

SEED = 2**31 + 77


def _run(spec, workload):
    return run_cell(spec, workload, SEED, 0.3, False, "cpu", 0.0, tiny(spec, workload))[0]


@pytest.mark.parametrize("workload", ["ycbv.teach", "icwt30.teach"])
def test_sound_run_is_correct(spec, workload):
    assert _run(spec, workload)["correct"] is True


def _models(monkeypatch, alter):
    from online_detection_tpu_torch.pipelines import device_pipeline

    real = device_pipeline.train_online_modules_device

    def broken(*args, **kwargs):
        online = real(*args, **kwargs)
        for head in (online.rpn, online.detector, online.mask):
            if head is not None:
                alter(head)
        return online

    monkeypatch.setattr(device_pipeline, "train_online_modules_device", broken)


def _zero_alpha(head):
    head.falkon.alpha = head.falkon.alpha * 0.0


def _zero_beta(head):
    if hasattr(head, "rls"):
        head.rls.beta = head.rls.beta * 0.0


@pytest.mark.parametrize("alter", [_zero_alpha, _zero_beta], ids=["falkon", "rls"])
def test_teach_state_unchanged(spec, monkeypatch, alter):
    """The training hands back models (the FALKON classifiers, or the RLS
    refiners) that never moved from their start."""
    _models(monkeypatch, alter)
    assert _run(spec, "ycbv.teach")["correct"] is False


def test_teach_answer_altered(spec, monkeypatch):
    def scaled(head):
        head.falkon.alpha = head.falkon.alpha * 1.5

    _models(monkeypatch, scaled)
    assert _run(spec, "ycbv.teach")["correct"] is False


def test_teach_negatives_ignore_the_overlap_rule(spec, monkeypatch):
    """The harvest samples a class's negatives from every row, its own
    objects' boxes included."""
    from online_detection_tpu_torch.engine import harvest

    real = harvest.harvest_detector

    def broken(*args, **kwargs):
        args = list(args)
        args[6] = args[6]._replace(det_neg_iou=1.01)
        return real(*args, **kwargs)

    monkeypatch.setattr(harvest, "harvest_detector", broken)
    assert _run(spec, "ycbv.teach")["correct"] is False


def test_teach_half_the_batch_left_out(spec, monkeypatch):
    from online_detection_tpu_torch.engine import device_accumulate

    real = device_accumulate.accumulate_batch

    def broken(state, chunks, img_valid, num_classes):
        half = torch.arange(img_valid.shape[0]) < (img_valid.shape[0] + 1) // 2
        return real(state, chunks, img_valid & half, num_classes)

    monkeypatch.setattr(device_accumulate, "accumulate_batch", broken)
    assert _run(spec, "ycbv.teach")["correct"] is False
