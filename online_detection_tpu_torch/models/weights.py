"""Weight carry-over from the JAX package's parameter tree.

``params_from_jax`` takes the JAX schema with numpy (or array-like) leaves:

    backbone/stem/{w, scale, bias}, backbone/res2..res5 = [block, ...] with
    block = {branch2a, branch2b, branch2c[, branch1]}: {w, scale, bias},
    rpn/{conv_w, conv_b, cls_w, cls_b, bbox_w, bbox_b},
    mask_head/{w, b, logits_w, logits_b}

and builds the port's modules. Layouts change here and nowhere else:
conv kernels HWIO -> OIHW, the mask deconv [2, 2, I, O] -> [I, O, 2, 2].

``online_from_jax`` turns a JAX ``OnlineModelSet`` (its leaves as arrays)
into the port's, reading attributes by name.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.detector import DetectorParams, OnlineModelSet
from online_detection_tpu_torch.models.heads import (
    MaskHead,
    OnlineDetectorModels,
    OnlineMaskModels,
)
from online_detection_tpu_torch.models.rpn import OnlineRPNModels, RPNHead
from online_detection_tpu_torch.solvers.falkon import FalkonModel
from online_detection_tpu_torch.solvers.rls import RLSModel
from online_detection_tpu_torch.utils.stats import FeatureStats


def _t(x, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype))


def _oihw(w) -> torch.Tensor:  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w, np.float32),
                                                              (3, 2, 0, 1))))


def _conv_bn(p: Mapping[str, Any]) -> resnet.ConvBN:
    return resnet.ConvBN(_oihw(p["w"]), _t(p["scale"]), _t(p["bias"]))


def _stage(blocks, first_stride: int):
    return [
        resnet.Bottleneck(
            _conv_bn(b["branch2a"]), _conv_bn(b["branch2b"]), _conv_bn(b["branch2c"]),
            _conv_bn(b["branch1"]) if "branch1" in b else None,
            stride=first_stride if i == 0 else 1,
        )
        for i, b in enumerate(blocks)
    ]


def backbone_from_jax(bb: Mapping[str, Any]) -> resnet.ResNetC4:
    return resnet.ResNetC4(
        _conv_bn(bb["stem"]), _stage(bb["res2"], 1), _stage(bb["res3"], 2),
        _stage(bb["res4"], 2), _stage(bb["res5"], 2) if "res5" in bb else None,
    )


def params_from_jax(tree: Mapping[str, Any]) -> DetectorParams:
    """JAX parameter tree -> ``DetectorParams`` on the CPU."""
    rpn = tree["rpn"]
    mh = tree["mask_head"]
    mask_w = np.ascontiguousarray(np.transpose(np.asarray(mh["w"], np.float32), (2, 3, 0, 1)))
    return DetectorParams(
        backbone_from_jax(tree["backbone"]),
        RPNHead(_oihw(rpn["conv_w"]), _t(rpn["conv_b"]), _t(rpn["cls_w"]),
                _t(rpn["cls_b"]), _t(rpn["bbox_w"]), _t(rpn["bbox_b"])),
        MaskHead(torch.from_numpy(mask_w), _t(mh["b"]), _t(mh["logits_w"]),
                 _t(mh["logits_b"])),
    )


def _falkon(m) -> FalkonModel:
    return FalkonModel(_t(m.centers), _t(m.alpha), _t(m.exists, bool), float(m.sigma))


def _stats(s) -> FeatureStats:
    return FeatureStats(_t(s.mean), _t(s.std), _t(s.mean_norm))


def _rls(m) -> RLSModel:
    return RLSModel(_t(m.beta), _t(m.t_inv), _t(m.t), _t(m.mu), _t(m.exists, bool),
                    _t(m.mean_losses))


def online_from_jax(online) -> OnlineModelSet:
    """JAX ``OnlineModelSet`` -> the port's, on the CPU."""
    rpn = None
    if online.rpn is not None:
        rpn = OnlineRPNModels(_falkon(online.rpn.falkon), _rls(online.rpn.rls),
                              _stats(online.rpn.stats))
    det = OnlineDetectorModels(_falkon(online.detector.falkon), _rls(online.detector.rls),
                               _stats(online.detector.stats))
    mask = None
    if online.mask is not None:
        mask = OnlineMaskModels(_falkon(online.mask.falkon), _stats(online.mask.stats))
    return OnlineModelSet(rpn, det, mask)
