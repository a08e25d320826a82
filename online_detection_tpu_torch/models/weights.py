"""Weights: checkpoint files, and carry-over from the JAX package's tree.

``params_from_jax`` takes the JAX schema with numpy (or array-like) leaves:

    backbone/stem/{w, scale, bias}, backbone/res2..res5 = [block, ...] with
    block = {branch2a, branch2b, branch2c[, branch1]}: {w, scale, bias},
    rpn/{conv_w, conv_b, cls_w, cls_b, bbox_w, bbox_b},
    mask_head/{w, b, logits_w, logits_b} (may be empty),
    box_predictor/{cls_w, cls_b, bbox_w, bbox_b} (optional)

and builds the port's modules. Layouts change here and nowhere else:
conv kernels HWIO -> OIHW, the mask deconv [2, 2, I, O] -> [I, O, 2, 2];
``tree_from_params`` inverts it.

Checkpoint files (counterpart of the JAX package's ``models/weights.py``):
``load_checkpoint`` reads a Detectron/Caffe2 ``.pkl`` (blob names) or a
maskrcnn-benchmark ``.pth`` (state-dict names) onto the CPU.
``params_from_caffe2`` and ``params_from_torch_state_dict`` build the JAX
schema with numpy leaves, as the JAX converters do, and hand it to
``params_from_jax``:

- Caffe2 conv blobs are [O, I, kh, kw]; FC blobs [O, I]; BN blobs arrive
  folded (``_s``, ``_b``); the deconv ``conv5_mask_w`` is [I, O, kh, kw].
- A torch ``FrozenBatchNorm2d`` keeps weight, bias, running mean and
  variance; it folds in float64 with no eps (``scale = w / sqrt(rv)``,
  ``bias = b - rm * scale``), then rounds to float32.
- The 1x1 heads become [I, A] and [I, 4A] matrices.

``export_caffe2_blobs`` / ``export_torch_state_dict`` write the port's
modules back into both formats (random-weight round trips of
``experiments/weights_smoke.py --selftest``), and ``activation_checksums``
records per-stage statistics of a fixed synthetic image.

``online_from_jax`` turns a JAX ``OnlineModelSet`` (its leaves as arrays)
into the port's, reading attributes by name.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.detector import DetectorParams, OnlineModelSet
from online_detection_tpu_torch.models.heads import (
    BoxPredictor,
    MaskHead,
    OnlineDetectorModels,
    OnlineMaskModels,
    mask_deconv,
)
from online_detection_tpu_torch.models.rpn import (
    OnlineRPNModels,
    RPNHead,
    rpn_features,
    rpn_pretrained,
)
from online_detection_tpu_torch.ops.roi_align import roi_align
from online_detection_tpu_torch.solvers.falkon import FalkonModel
from online_detection_tpu_torch.solvers.rls import RLSModel
from online_detection_tpu_torch.utils.device import ieee_fp32, resolve_device
from online_detection_tpu_torch.utils.stats import FeatureStats

R50_STAGE_BLOCKS = {"res2": 3, "res3": 4, "res4": 6, "res5": 3}


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
    """JAX parameter tree -> ``DetectorParams`` on the CPU. An empty
    ``mask_head`` gives ``mask_head=None``; ``box_predictor`` is carried when
    the tree has one."""
    rpn = tree["rpn"]
    mask_head = None
    mh = tree.get("mask_head")
    if mh:
        mask_w = np.transpose(np.asarray(mh["w"], np.float32), (2, 3, 0, 1))
        mask_head = MaskHead(torch.from_numpy(np.ascontiguousarray(mask_w)), _t(mh["b"]),
                             _t(mh["logits_w"]), _t(mh["logits_b"]))
    box_predictor = None
    bp = tree.get("box_predictor")
    if bp:
        box_predictor = BoxPredictor(_t(bp["cls_w"]), _t(bp["cls_b"]), _t(bp["bbox_w"]),
                                     _t(bp["bbox_b"]))
    return DetectorParams(
        backbone_from_jax(tree["backbone"]),
        RPNHead(_oihw(rpn["conv_w"]), _t(rpn["conv_b"]), _t(rpn["cls_w"]),
                _t(rpn["cls_b"]), _t(rpn["bbox_w"]), _t(rpn["bbox_b"])),
        mask_head, box_predictor,
    )


def _np(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of the module's memory)."""
    return np.array(t.detach().cpu())


def _hwio(w) -> np.ndarray:  # [O, I, kh, kw] -> [kh, kw, I, O]
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _conv_bn_tree(p: resnet.ConvBN) -> Dict[str, np.ndarray]:
    return {"w": _hwio(_np(p.weight)), "scale": _np(p.scale), "bias": _np(p.bias)}


def tree_from_params(params: DetectorParams) -> Dict[str, Any]:
    """``DetectorParams`` -> the JAX schema with numpy leaves (the inverse of
    ``params_from_jax``; an absent mask head is an empty dict, an absent box
    predictor no key)."""
    bb = params.backbone
    backbone: Dict[str, Any] = {"stem": _conv_bn_tree(bb.stem)}
    for stage in ("res2", "res3", "res4", "res5"):
        blocks = []
        for blk in getattr(bb, stage):
            p = {br: _conv_bn_tree(getattr(blk, br))
                 for br in ("branch2a", "branch2b", "branch2c")}
            if blk.branch1 is not None:
                p["branch1"] = _conv_bn_tree(blk.branch1)
            blocks.append(p)
        if blocks:
            backbone[stage] = blocks
    r = params.rpn
    tree: Dict[str, Any] = {
        "backbone": backbone,
        "rpn": {"conv_w": _hwio(_np(r.conv_w)), "conv_b": _np(r.conv_b), "cls_w": _np(r.cls_w),
                "cls_b": _np(r.cls_b), "bbox_w": _np(r.bbox_w), "bbox_b": _np(r.bbox_b)},
        "mask_head": {},
    }
    mh = params.mask_head
    if mh is not None:
        tree["mask_head"] = {"w": np.transpose(_np(mh.w), (2, 3, 0, 1)), "b": _np(mh.b),
                             "logits_w": _np(mh.logits_w), "logits_b": _np(mh.logits_b)}
    bp = params.box_predictor
    if bp is not None:
        tree["box_predictor"] = {"cls_w": _np(bp.cls_w), "cls_b": _np(bp.cls_b),
                                 "bbox_w": _np(bp.bbox_w), "bbox_b": _np(bp.bbox_b)}
    return tree


# ---------------------------------------------------------------------------
# checkpoint files


def load_caffe2_pickle(path: str) -> Dict[str, np.ndarray]:
    """A Detectron pickle -> its blobs (``_momentum`` blobs dropped)."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items() if not k.endswith("_momentum")}


def _caffe2_tree(blobs: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Detectron blob names -> the JAX schema with numpy leaves. A missing
    blob raises ``KeyError``; the mask head and the box predictor are taken
    when their blobs are there."""

    def conv_bn(prefix_w, prefix_bn):
        return {"w": _hwio(blobs[prefix_w + "_w"]), "scale": np.asarray(blobs[prefix_bn + "_s"]),
                "bias": np.asarray(blobs[prefix_bn + "_b"])}

    backbone: Dict[str, Any] = {"stem": conv_bn("conv1", "res_conv1_bn")}
    for stage, n_blocks in R50_STAGE_BLOCKS.items():
        sid = stage[3]  # '2'..'5'
        blocks = []
        for b in range(n_blocks):
            p = {}
            for br in ("branch2a", "branch2b", "branch2c"):
                base = f"res{sid}_{b}_{br}"
                p[br] = conv_bn(base, base + "_bn")
            b1 = f"res{sid}_{b}_branch1"
            if b1 + "_w" in blobs:
                p["branch1"] = conv_bn(b1, b1 + "_bn")
            blocks.append(p)
        backbone[stage] = blocks

    rpn = {
        "conv_w": _hwio(blobs["conv_rpn_w"]),
        "conv_b": np.asarray(blobs["conv_rpn_b"]),
        "cls_w": _hwio(blobs["rpn_cls_logits_w"])[0, 0],  # 1x1 -> [I, A]
        "cls_b": np.asarray(blobs["rpn_cls_logits_b"]),
        "bbox_w": _hwio(blobs["rpn_bbox_pred_w"])[0, 0],
        "bbox_b": np.asarray(blobs["rpn_bbox_pred_b"]),
    }
    mask_head = {}
    if "conv5_mask_w" in blobs:
        mask_head = {
            # the Caffe2 deconv blob is [I, O, kh, kw]
            "w": np.transpose(blobs["conv5_mask_w"], (2, 3, 0, 1)),
            "b": np.asarray(blobs["conv5_mask_b"]),
            "logits_w": _hwio(blobs["mask_fcn_logits_w"])[0, 0],
            "logits_b": np.asarray(blobs["mask_fcn_logits_b"]),
        }
    tree = {"backbone": backbone, "rpn": rpn, "mask_head": mask_head}
    if "cls_score_w" in blobs:
        tree["box_predictor"] = {
            "cls_w": np.transpose(blobs["cls_score_w"]),
            "cls_b": np.asarray(blobs["cls_score_b"]),
            "bbox_w": np.transpose(blobs["bbox_pred_w"]),
            "bbox_b": np.asarray(blobs["bbox_pred_b"]),
        }
    return tree


def params_from_caffe2(blobs: Mapping[str, np.ndarray]) -> DetectorParams:
    return params_from_jax(_caffe2_tree(blobs))


# maskrcnn-benchmark module prefixes of the R-50-C4 stages (res5 lives in the
# box head's feature extractor)
_TORCH_STAGE_PREFIX = {
    "res2": "backbone.body.layer1",
    "res3": "backbone.body.layer2",
    "res4": "backbone.body.layer3",
    "res5": "roi_heads.box.feature_extractor.head.layer4",
}


def _torch_tree(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """maskrcnn-benchmark state-dict names (tensors or arrays) -> the JAX
    schema with numpy leaves; BN folded as ``FrozenBatchNorm2d`` folds."""

    def t(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def frozen_bn(prefix):
        w = t(sd[prefix + ".weight"]).astype(np.float64)
        b = t(sd[prefix + ".bias"]).astype(np.float64)
        rm = t(sd[prefix + ".running_mean"]).astype(np.float64)
        rv = t(sd[prefix + ".running_var"]).astype(np.float64)
        scale = w / np.sqrt(rv)  # FrozenBatchNorm2d: no eps
        return scale.astype(np.float32), (b - rm * scale).astype(np.float32)

    def conv_bn(conv_key, bn_key):
        s, b = frozen_bn(bn_key)
        return {"w": _hwio(t(sd[conv_key + ".weight"])), "scale": s, "bias": b}

    backbone: Dict[str, Any] = {
        "stem": conv_bn("backbone.body.stem.conv1", "backbone.body.stem.bn1")}
    for stage, n_blocks in R50_STAGE_BLOCKS.items():
        pre = _TORCH_STAGE_PREFIX[stage]
        blocks = []
        for i in range(n_blocks):
            p = {"branch2a": conv_bn(f"{pre}.{i}.conv1", f"{pre}.{i}.bn1"),
                 "branch2b": conv_bn(f"{pre}.{i}.conv2", f"{pre}.{i}.bn2"),
                 "branch2c": conv_bn(f"{pre}.{i}.conv3", f"{pre}.{i}.bn3")}
            if f"{pre}.{i}.downsample.0.weight" in sd:
                p["branch1"] = conv_bn(f"{pre}.{i}.downsample.0", f"{pre}.{i}.downsample.1")
            blocks.append(p)
        backbone[stage] = blocks

    rpn = {
        "conv_w": _hwio(t(sd["rpn.head.conv.weight"])),
        "conv_b": t(sd["rpn.head.conv.bias"]),
        "cls_w": _hwio(t(sd["rpn.head.cls_logits.weight"]))[0, 0],
        "cls_b": t(sd["rpn.head.cls_logits.bias"]),
        "bbox_w": _hwio(t(sd["rpn.head.bbox_pred.weight"]))[0, 0],
        "bbox_b": t(sd["rpn.head.bbox_pred.bias"]),
    }
    mask_head = {}
    mp = "roi_heads.mask.predictor."
    if mp + "conv5_mask.weight" in sd:
        mask_head = {
            # ConvTranspose2d weights are [I, O, kh, kw]
            "w": np.transpose(t(sd[mp + "conv5_mask.weight"]), (2, 3, 0, 1)),
            "b": t(sd[mp + "conv5_mask.bias"]),
            "logits_w": _hwio(t(sd[mp + "mask_fcn_logits.weight"]))[0, 0],
            "logits_b": t(sd[mp + "mask_fcn_logits.bias"]),
        }
    tree = {"backbone": backbone, "rpn": rpn, "mask_head": mask_head}
    bp = "roi_heads.box.predictor."
    if bp + "cls_score.weight" in sd:
        tree["box_predictor"] = {
            "cls_w": t(sd[bp + "cls_score.weight"]).T,
            "cls_b": t(sd[bp + "cls_score.bias"]),
            "bbox_w": t(sd[bp + "bbox_pred.weight"]).T,
            "bbox_b": t(sd[bp + "bbox_pred.bias"]),
        }
    return tree


def params_from_torch_state_dict(sd: Mapping[str, Any]) -> DetectorParams:
    return params_from_jax(_torch_tree(sd))


def _inv_conv(w) -> np.ndarray:  # HWIO -> [O, I, kh, kw]
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def export_caffe2_blobs(params: DetectorParams) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_caffe2``: the port's modules -> Detectron
    blob names and layouts."""
    tree = tree_from_params(params)

    def put_conv_bn(blobs, prefix_w, prefix_bn, p):
        blobs[prefix_w + "_w"] = _inv_conv(p["w"])
        blobs[prefix_bn + "_s"] = np.asarray(p["scale"])
        blobs[prefix_bn + "_b"] = np.asarray(p["bias"])

    blobs: Dict[str, np.ndarray] = {}
    bb = tree["backbone"]
    put_conv_bn(blobs, "conv1", "res_conv1_bn", bb["stem"])
    for stage, n_blocks in R50_STAGE_BLOCKS.items():
        sid = stage[3]
        for b in range(n_blocks):
            blk = bb[stage][b]
            for br in ("branch2a", "branch2b", "branch2c"):
                base = f"res{sid}_{b}_{br}"
                put_conv_bn(blobs, base, base + "_bn", blk[br])
            if "branch1" in blk:
                b1 = f"res{sid}_{b}_branch1"
                put_conv_bn(blobs, b1, b1 + "_bn", blk["branch1"])

    rpn = tree["rpn"]
    blobs["conv_rpn_w"] = _inv_conv(rpn["conv_w"])
    blobs["conv_rpn_b"] = rpn["conv_b"]
    # the 1x1 heads are [I, A]; Caffe2 stores [A, I, 1, 1]
    blobs["rpn_cls_logits_w"] = rpn["cls_w"].T[:, :, None, None]
    blobs["rpn_cls_logits_b"] = rpn["cls_b"]
    blobs["rpn_bbox_pred_w"] = rpn["bbox_w"].T[:, :, None, None]
    blobs["rpn_bbox_pred_b"] = rpn["bbox_b"]
    if tree["mask_head"]:
        mh = tree["mask_head"]
        blobs["conv5_mask_w"] = np.transpose(mh["w"], (2, 3, 0, 1))  # [I, O, kh, kw]
        blobs["conv5_mask_b"] = mh["b"]
        blobs["mask_fcn_logits_w"] = mh["logits_w"].T[:, :, None, None]
        blobs["mask_fcn_logits_b"] = mh["logits_b"]
    if "box_predictor" in tree:
        bp = tree["box_predictor"]
        blobs["cls_score_w"] = bp["cls_w"].T
        blobs["cls_score_b"] = bp["cls_b"]
        blobs["bbox_pred_w"] = bp["bbox_w"].T
        blobs["bbox_pred_b"] = bp["bbox_b"]
    return blobs


def export_torch_state_dict(params: DetectorParams) -> Dict[str, np.ndarray]:
    """Inverse of ``params_from_torch_state_dict``. The BN fold is not
    uniquely invertible: the export writes running mean 0 and variance 1,
    so the fold gives scale and bias back exactly."""
    tree = tree_from_params(params)

    def put_conv_bn(sd, conv_key, bn_key, p):
        sd[conv_key + ".weight"] = _inv_conv(p["w"])
        n = p["scale"].shape[0]
        sd[bn_key + ".weight"] = p["scale"]
        sd[bn_key + ".bias"] = p["bias"]
        sd[bn_key + ".running_mean"] = np.zeros((n,), np.float32)
        sd[bn_key + ".running_var"] = np.ones((n,), np.float32)

    sd: Dict[str, np.ndarray] = {}
    bb = tree["backbone"]
    put_conv_bn(sd, "backbone.body.stem.conv1", "backbone.body.stem.bn1", bb["stem"])
    for stage, n_blocks in R50_STAGE_BLOCKS.items():
        pre = _TORCH_STAGE_PREFIX[stage]
        for i in range(n_blocks):
            blk = bb[stage][i]
            put_conv_bn(sd, f"{pre}.{i}.conv1", f"{pre}.{i}.bn1", blk["branch2a"])
            put_conv_bn(sd, f"{pre}.{i}.conv2", f"{pre}.{i}.bn2", blk["branch2b"])
            put_conv_bn(sd, f"{pre}.{i}.conv3", f"{pre}.{i}.bn3", blk["branch2c"])
            if "branch1" in blk:
                put_conv_bn(sd, f"{pre}.{i}.downsample.0", f"{pre}.{i}.downsample.1",
                            blk["branch1"])

    rpn = tree["rpn"]
    sd["rpn.head.conv.weight"] = _inv_conv(rpn["conv_w"])
    sd["rpn.head.conv.bias"] = rpn["conv_b"]
    sd["rpn.head.cls_logits.weight"] = rpn["cls_w"].T[:, :, None, None]
    sd["rpn.head.cls_logits.bias"] = rpn["cls_b"]
    sd["rpn.head.bbox_pred.weight"] = rpn["bbox_w"].T[:, :, None, None]
    sd["rpn.head.bbox_pred.bias"] = rpn["bbox_b"]
    mp = "roi_heads.mask.predictor."
    if tree["mask_head"]:
        mh = tree["mask_head"]
        sd[mp + "conv5_mask.weight"] = np.transpose(mh["w"], (2, 3, 0, 1))
        sd[mp + "conv5_mask.bias"] = mh["b"]
        sd[mp + "mask_fcn_logits.weight"] = mh["logits_w"].T[:, :, None, None]
        sd[mp + "mask_fcn_logits.bias"] = mh["logits_b"]
    bp = "roi_heads.box.predictor."
    if "box_predictor" in tree:
        p = tree["box_predictor"]
        sd[bp + "cls_score.weight"] = p["cls_w"].T
        sd[bp + "cls_score.bias"] = p["cls_b"]
        sd[bp + "bbox_pred.weight"] = p["bbox_w"].T
        sd[bp + "bbox_pred.bias"] = p["bbox_b"]
    return sd


@ieee_fp32()
@torch.inference_mode()
def activation_checksums(params: DetectorParams, seed: int = 0, hw=(128, 160),
                         device=None) -> Dict[str, Dict[str, Any]]:
    """Per-stage statistics (shape, mean, std, absmax, in float64) of the
    forward pass on a fixed synthetic float32 image from ``seed``: two
    checkpoints that convert alike give the same rows, and a layout or BN
    fold fault shifts the row of its stage. The trunk runs on the float32
    image as given (no compute-dtype cast), so on the card the stem kernel
    takes its fp32 route. ``device`` defaults to the card; ``params`` must
    already live there."""
    dev = resolve_device(device)
    if params.rpn.conv_w.device.type != dev.type:
        raise ValueError(f"params are on {params.rpn.conv_w.device}; move them to {dev}")
    h, w = hw
    rng = np.random.default_rng(seed)
    image = torch.from_numpy(rng.uniform(-120, 120, size=(1, h, w, 3)).astype(np.float32))
    image = image.to(dev)
    out: Dict[str, Dict[str, Any]] = {}

    def record(name, x):
        x = x.detach().cpu().numpy().astype(np.float64)
        out[name] = {"shape": tuple(x.shape), "mean": float(x.mean()), "std": float(x.std()),
                     "absmax": float(np.abs(x).max())}

    c4 = resnet.backbone_c4(params.backbone, image)
    record("backbone_c4", c4)
    t = rpn_features(params.rpn, c4)
    record("rpn_conv", t)
    logits, deltas = rpn_pretrained(params.rpn, t)
    record("rpn_logits", logits)
    record("rpn_deltas", deltas)
    boxes = torch.tensor([[0.0, 0.0, w / 2, h / 2], [w / 4, h / 4, w - 1.0, h - 1.0]],
                         dtype=torch.float32, device=dev)
    pooled = roi_align(c4[0], boxes, 14, 1.0 / 16.0)
    record("roi_align_14x14", pooled)
    feats = resnet.res5_head(params.backbone, pooled)
    record("res5_avgpool_2048", feats)
    if params.mask_head is not None:
        res5map = resnet.res5_feature_map(params.backbone, pooled)
        record("mask_deconv_256", mask_deconv(params.mask_head, res5map))
    if params.box_predictor is not None:
        bp = params.box_predictor
        record("cls_logits", feats @ bp.cls_w + bp.cls_b)
    return out


def load_checkpoint(path: str) -> DetectorParams:
    """A ``.pkl`` (Caffe2 Detectron blobs) or any other file as a torch
    checkpoint (a state dict, or a dict holding it under ``"model"``; a
    ``module.`` prefix is dropped) -> ``DetectorParams`` on the CPU. The
    file is unpickled in full (``weights_only=False``, as the JAX package
    reads it): load only checkpoints you trust."""
    if path.endswith(".pkl"):
        return params_from_caffe2(load_caffe2_pickle(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    return params_from_torch_state_dict(sd)


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
