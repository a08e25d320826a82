"""Analytic FLOPs model of the conv trunk and heads, for MFU accounting
(counterpart of ``utils/flops.py``).

Counts multiply-accumulates x2 ("FLOPs") for every conv and matmul of the
R-50-C4 pipeline as ``models/resnet.py``, ``models/rpn.py``,
``models/heads.py`` and ``ops/roi_align.py`` build it; each ``*_flops``
function counts as the JAX package's does. ``mfu = flops_per_second /
peak``.

Peaks: the NVIDIA H100 SXM5 80GB (700 W) data sheet's dense tensor-core
rates, bf16 989 and TF32 495 TFLOP/s, and 67 TFLOP/s fp32 on the CUDA
cores. ``mfu`` defaults to the bf16 peak, since the trunk runs bf16 on the
card (``models/detector.py::resolve_compute_dtype``); the heads' Gaussian
mmv runs 3xTF32 (a third of the TF32 rate) and the solvers IEEE fp32.

Element-wise work (BN, ReLU, bilinear weights, softmax/sigmoid) is left
out: it is bound by memory, not by the tensor cores, and under 1 % of the
FLOP count.
"""

from __future__ import annotations

H100_PEAK_BF16_TFLOPS = 989.0
H100_PEAK_TF32_TFLOPS = 495.0
H100_PEAK_F32_TFLOPS = 67.0

# R-50 stage layout: (blocks, bottleneck_ch, out_ch), input ch of the stage
_STAGES = (
    ("res2", 3, 64, 256, 64),
    ("res3", 4, 128, 512, 256),
    ("res4", 6, 256, 1024, 512),
)


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def _bottleneck_flops(cin, mid, cout, h, w, downsample):
    f = conv_flops(cin, mid, 1, h, w)  # 2a (carries the stride: out res)
    f += conv_flops(mid, mid, 3, h, w)  # 2b
    f += conv_flops(mid, cout, 1, h, w)  # 2c
    if downsample:
        f += conv_flops(cin, cout, 1, h, w)  # branch1
    return f


def backbone_c4_flops(h: int, w: int) -> float:
    """Stem + res2..res4 on an [h, w] canvas (canvas dims divisible by 32)."""
    f = conv_flops(3, 64, 7, h // 2, w // 2)  # stem, stride 2
    sh, sw = h // 4, w // 4  # after maxpool
    for _name, blocks, mid, cout, cin in _STAGES:
        if _name != "res2":
            sh, sw = sh // 2, sw // 2
        f += _bottleneck_flops(cin, mid, cout, sh, sw, downsample=True)
        for _ in range(blocks - 1):
            f += _bottleneck_flops(cout, mid, cout, sh, sw, downsample=False)
    return f


def rpn_conv_flops(h16: int, w16: int, num_anchors: int = 15) -> float:
    """Pretrained RPN head: 3x3 conv + the 1x1 logits/bbox convs."""
    f = conv_flops(1024, 1024, 3, h16, w16)
    f += conv_flops(1024, num_anchors, 1, h16, w16)
    f += conv_flops(1024, 4 * num_anchors, 1, h16, w16)
    return f


def rpn_online_head_flops(h16: int, w16: int, num_anchors: int = 15,
                          m: int = 1000, d: int = 1024) -> float:
    """On-line RPN head: fused Gaussian mmv over all A anchor classifiers
    (one [HW, d] x [A*m, d] kernel matmul) + the batched RLS refiners."""
    hw = h16 * w16
    f = 2.0 * hw * (num_anchors * m) * d  # fused kernel mmv
    f += 2.0 * hw * (d + 1) * 4 * num_anchors  # block RLS deltas
    return f


def roi_align_flops(h16: int, w16: int, n_rois: int, c: int = 1024,
                    pooled: int = 14) -> float:
    """Separable formulation: A[P,H] @ F[H,W,C] then B[P,W] @ t[P,W,C]."""
    per_roi = 2.0 * pooled * h16 * w16 * c + 2.0 * pooled * w16 * pooled * c
    return per_roi * n_rois


def res5_flops(n_rois: int) -> float:
    """res5 x3 on pooled 14x14 RoIs (stride 2 -> 7x7), per the box head."""
    per_roi = _bottleneck_flops(1024, 512, 2048, 7, 7, downsample=True)
    per_roi += 2 * _bottleneck_flops(2048, 512, 2048, 7, 7, downsample=False)
    return per_roi * n_rois


def mask_deconv_flops(n_rois: int) -> float:
    """conv5_mask: ConvTranspose 2048->256, k2 s2, 7x7 -> 14x14, + 1x1-free
    per-pixel FALKON counted separately."""
    return 2.0 * 2048 * 256 * 2 * 2 * 7 * 7 * n_rois


def falkon_det_head_flops(n_rois: int, num_classes: int = 21, m: int = 1000,
                          d: int = 2048) -> float:
    """Fused per-class FALKON scoring + batched RLS refinement of the box head."""
    return 2.0 * n_rois * (num_classes * m) * d + 2.0 * n_rois * (d + 1) * 4 * num_classes


def falkon_mask_head_flops(n_rois: int, num_classes: int = 1, m: int = 500,
                           d: int = 256, pix: int = 14 * 14) -> float:
    """Per-pixel FALKON mask scoring. The inference path evaluates only
    each detection's OWN class (``heads.mask_predict_labels``), so the
    EXECUTED count uses num_classes=1; pass the real class count only for
    the all-class sweep variant (``heads.mask_predict``)."""
    return 2.0 * n_rois * pix * (num_classes * m) * d


def harvest_image_flops(h: int, w: int, n_props: int = 300, n_gt: int = 8,
                        num_anchors: int = 15) -> float:
    """One harvest-pass image: backbone + pretrained RPN (proposals) +
    RoIAlign/res5 over GT-prepended proposals + mask deconv on GT rows."""
    h16, w16 = h // 16, w // 16
    r = n_props + n_gt
    return (
        backbone_c4_flops(h, w)
        + rpn_conv_flops(h16, w16, num_anchors)
        + roi_align_flops(h16, w16, r)
        # + the GT rows' res5 once more for the mask head (harvest_trunk
        # runs res5 again on the G GT rows, as the JAX package does)
        + res5_flops(r + n_gt)
        + mask_deconv_flops(n_gt)
    )


def inference_image_flops(h: int, w: int, n_props: int = 300,
                          n_det: int = 100, num_classes: int = 21,
                          num_anchors: int = 15, with_online_rpn: bool = True,
                          with_masks: bool = True) -> float:
    """One on-line inference image: backbone + (on-line) RPN + box head with
    fused FALKON/RLS + mask head on the kept detections."""
    h16, w16 = h // 16, w // 16
    f = backbone_c4_flops(h, w) + rpn_conv_flops(h16, w16, num_anchors)
    if with_online_rpn:
        f += rpn_online_head_flops(h16, w16, num_anchors)
    f += roi_align_flops(h16, w16, n_props) + res5_flops(n_props)
    f += falkon_det_head_flops(n_props, num_classes)
    if with_masks:
        # mask branch as EXECUTED by detect/detect_batched: RoIAlign on the
        # kept detections + res5 feature map + deconv + own-class-only
        # per-pixel FALKON (heads.mask_predict_labels)
        f += roi_align_flops(h16, w16, n_det) + res5_flops(n_det)
        f += mask_deconv_flops(n_det) + falkon_mask_head_flops(n_det)
    return f


def mfu(flops_per_second: float, peak_tflops: float = H100_PEAK_BF16_TFLOPS) -> float:
    return flops_per_second / (peak_tflops * 1e12)
