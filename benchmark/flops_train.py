"""The work of one SGD step of Mask R-CNN R-50-C4 (the ``full_train``
kind), built on ``flops.py``'s frozen counts.

A step's least time counts, for every trainable convolution and product,
its forward, its input gradient and its weight gradient (three times the
forward's operations), less the stem's input gradient, which no step
needs; all at the IEEE fp32 rate the configuration states. The mask head
counts the positives' quota of the sample (a quarter of the RoIs), the
RoIs maskrcnn-benchmark runs it on. Kernel B3' (the RoIAlign backward) is
counted in bytes: the pooled gradient read, the boxes read and the C4
map's gradient written once, in fp32.
"""

from __future__ import annotations

from benchmark import flops


def step_forward(h: int, w: int, rois: int, classes: int, anchors: int = 15) -> float:
    """A step's forward operations on an h x w canvas with ``rois`` sampled
    RoIs and ``classes`` classes besides the background."""
    h16, w16 = h // 16, w // 16
    k = classes + 1
    mask_rois = rois // 4
    f = flops.backbone_c4(h, w) + flops.rpn_conv(h16, w16)
    f += flops.rpn_pretrained_heads(h16, w16, anchors)
    f += flops.res5(rois) + 2.0 * 2048 * 5 * k * rois  # box predictor: scores and deltas
    f += flops.mask_deconv(mask_rois) + 2.0 * 256 * k * 14 * 14 * mask_rois
    return f


def step_flops(h: int, w: int, rois: int, classes: int) -> float:
    stem = flops.conv_flops(3, 64, 7, h // 2, w // 2)
    return 3.0 * step_forward(h, w, rois, classes) - stem


def b3_backward_bytes(rois: int, h16: int, w16: int, c: int = 1024, pooled: int = 14) -> float:
    return 4.0 * rois * pooled * pooled * c + 16.0 * rois + 4.0 * h16 * w16 * c
