"""The frozen operation and byte counts against shapes worked by hand."""

import pytest

from benchmark import flops


def test_conv_and_bottleneck():
    assert flops.conv_flops(3, 64, 7, 2, 5) == 2 * 3 * 64 * 49 * 10
    # 1x1 -> 3x3 -> 1x1, plus the projection: 2 * (4*2 + 2*2*9 + 2*8 + 4*8) * 6 * 7
    assert flops._bottleneck(4, 2, 8, 6, 7, True) == 2 * (8 + 36 + 16 + 32) * 42


def test_b1_call_and_split():
    ops, nbytes = flops.b1_call(2, 3, 4, 5)
    assert ops == 2 * 2 * 3 * 4 * 6
    assert nbytes == 4 * (2 * 3 * 5 + 2 * 4 * 5 + 2 * 4 + 2 * 3)
    ops, nbytes = flops.b1_split(3, 4, 5)
    assert (ops, nbytes) == (5 * 60, 12 * 60 + 4 * 12)
    # one call's least time: the larger of its operations at 3xTF32 and its bytes
    t = flops.b1_least_s([(2, 3, 4, 5)])
    # the split of its 2 center sets of 4 x 5: 12 bytes an element and 4 a norm
    want = max(288 / flops.PEAK_3XTF32, 336 / flops.PEAK_BYTES) + (12 * 40 + 4 * 8) / flops.PEAK_BYTES
    assert t == pytest.approx(want, rel=1e-12)


def test_roi_bytes():
    # bf16: the map once, the pooled rows once, 4 floats a box
    assert flops.roi_bytes(2, 3, 4, 5, c=16, pooled=2) == 2 * 2 * 12 * 16 + 2 * 2 * 5 * 4 * 16 + 16 * 10


def test_training_work_by_hand():
    cfg = {"batch_size": 10, "iterations": 2, "rpn_pos_cap": 4, "det_pos_cap": 3,
           "segm_pos_cap": 5, "segm_batch_size": 7, "with_rpn": False, "with_segmentation": False,
           "num_classes": 3, "num_anchor_classes": 15, "det_m": 2, "solver_class_chunk": 2}
    calls, fp32 = flops.training_work(cfg, images=4, batch=1, coxy_rows=6, rpn_pos_rows=0)
    # pools: P = det_pos_cap + 20 a batch; windows of 2 over 3 classes: 2
    p, m, d = 3 + 20, 2, 2048
    assert calls == [(2, 20, 2, d)] * 2 + [(2, 20, 2, d)] * 2
    per = lambda live: 2.0 * m * m * d + 2.0 * live * m * d + 4.0 * live * m * m + 7.0 * m ** 3
    want = 2 * 2 * (per(p + 10) + per(p + 20))
    want += 2.0 * 6 * 2049 ** 2 + 3 * (2.0 / 3.0) * 2049 ** 3
    assert fp32 == pytest.approx(want, rel=1e-12)


def test_backbone_counts_frozen():
    # R-50-C4 at 608x800: the frozen copy agrees with the program's count
    from online_detection_tpu_torch.utils import flops as program_flops

    assert flops.backbone_c4(608, 800) == 60562636800.0
    assert flops.backbone_c4(608, 800) == program_flops.backbone_c4_flops(608, 800)
    assert flops.res5(7) == program_flops.res5_flops(7)
