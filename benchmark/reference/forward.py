"""Plain PyTorch forward pass of the harvest, the benchmark's frozen
reference for the features the teaching cells harvest.

It follows the published R-50-C4 Mask R-CNN trunk of
hsp-iit/online-detection: ResNet-50-C4 with frozen BN, RoIAlign 14x14 on
C4, res5 and the spatial mean; beside it the on-line heads' Gaussian kernel
and RLS prediction, and the legacy (+1) box IoU and clip.

It imports nothing of the program. Weights come from ``benchmark/weights.py``
as plain tensors; the on-line models as plain dicts of tensors
(``models_of``). Each function writes out its arithmetic in the order the
configuration states it: the trunk in bf16 (products summed in fp32), the
heads in IEEE fp32 (TF32 off). ``Precision`` lowers both one step for the
control: the trunk to fp8 (e4m3, one scale a tensor) and the fp32 parts to
TF32.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

PIXEL_MEAN_BGR = (102.9801, 115.9465, 122.7750)
FP8_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """``trunk``: "bf16" (as configured) or "fp8"; ``heads``: "ieee" (fp32,
    as configured) or "tf32"."""

    trunk: str = "bf16"
    heads: str = "ieee"


CONFIGURED = Precision()
CONTROL = Precision("fp8", "tf32")


@contextlib.contextmanager
def fp32_mode(prec: Precision):
    """TF32 off for the configured precision, on for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = prec.heads == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to e4m3 with one scale a tensor (its largest magnitude maps to
    448), and back to bf16."""
    amax = t.abs().amax().float().clamp(min=1e-12)
    s = FP8_MAX / amax
    return ((t.float() * s).to(torch.float8_e4m3fn).float() / s).to(torch.bfloat16)


def _operands(x: torch.Tensor, w: torch.Tensor, prec: Precision):
    if prec.trunk == "fp8":
        return _fp8(x), _fp8(w)
    return x, w.to(x.dtype)


# ---------------------------------------------------------------- the trunk

def normalize(canvas_u8: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., 3] -> f32 BGR minus the pixel means."""
    bgr = canvas_u8.flip(-1).to(torch.float32)
    return bgr - torch.as_tensor(PIXEL_MEAN_BGR, device=canvas_u8.device)


def stem(x: torch.Tensor, p: Dict, prec: Precision) -> torch.Tensor:
    """NHWC bf16 images -> NHWC [B, H/4, W/4, 64]: conv7x7/2 from bf16
    operands summed in fp32, BN affine and ReLU in fp32, maxpool3x3/2, one
    rounding to bf16."""
    xo, wo = _operands(x, p["w"], prec)
    y = F.conv2d(xo.float().permute(0, 3, 1, 2), wo.float(), stride=2, padding=3)
    y = torch.relu(y * p["scale"][:, None, None] + p["bias"][:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_bn(x: torch.Tensor, p: Dict, stride: int, relu: bool, prec: Precision):
    xo, wo = _operands(x, p["w"], prec)
    out = F.conv2d(xo, wo, stride=stride, padding=p["w"].shape[-1] // 2).to(x.dtype)
    out = out * p["scale"].to(x.dtype)[:, None, None] + p["bias"].to(x.dtype)[:, None, None]
    return torch.relu(out) if relu else out


def bottleneck(x: torch.Tensor, blk: Dict, prec: Precision) -> torch.Tensor:
    s = blk["stride"]
    short = x if blk["branch1"] is None else conv_bn(x, blk["branch1"], s, False, prec)
    out = conv_bn(x, blk["a"], s, True, prec)
    out = conv_bn(out, blk["b"], 1, True, prec)
    out = conv_bn(out, blk["c"], 1, False, prec)
    return torch.relu(out + short)


def stage(x: torch.Tensor, blocks, prec: Precision) -> torch.Tensor:
    for blk in blocks:
        x = bottleneck(x, blk, prec)
    return x


def backbone_c4(w: Dict, images_u8: torch.Tensor, prec: Precision) -> torch.Tensor:
    """uint8 canvases [B, H, W, 3] -> C4 [B, H/16, W/16, 1024] in bf16."""
    x = normalize(images_u8).to(torch.bfloat16)
    x = stem(x, w["stem"], prec).permute(0, 3, 1, 2)
    for name in ("res2", "res3", "res4"):
        x = stage(x, w[name], prec)
    return x.permute(0, 2, 3, 1)


def res5_map(w: Dict, rois: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[R, 14, 14, C] -> [R, 7, 7, 2048] (NHWC)."""
    return stage(rois.permute(0, 3, 1, 2), w["res5"], prec).permute(0, 2, 3, 1)


# ------------------------------------------------------------- RoIAlign

def interp_matrix(start, size, pooled: int, dim: int, max_samples: int = 8):
    """[R] starts and sizes -> [R, pooled, dim] averaged bilinear weights."""
    dev = start.device
    bin_size = (size / pooled)[:, None, None]
    n = torch.clamp(torch.ceil(bin_size), 1, max_samples)
    p = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(max_samples, dtype=torch.float32, device=dev)[None, None, :]
    coord = start[:, None, None] + (p + (s + 0.5) / n) * bin_size
    keep = (coord >= -1.0) & (coord <= dim) & (s < n)
    c = coord.clamp(0.0, dim - 1.0)
    low = torch.floor(c)
    frac = c - low
    grid = torch.arange(dim, dtype=torch.float32, device=dev)
    wts = ((grid == low[..., None]) * (1.0 - frac[..., None])
           + (grid == (low[..., None] + 1.0)) * frac[..., None])
    return (wts * keep[..., None]).sum(dim=2) / n


def roi_align(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
              scale: float = 1.0 / 16.0) -> torch.Tensor:
    """features [B, H, W, C], rois [B, R, 4] -> [B, R, P, P, C] in the
    features' dtype, summed in fp32."""
    _, h, wd, _ = features.shape
    outs = []
    for f, r in zip(features, rois):
        r = r.float()
        sw, sh = r[:, 0] * scale, r[:, 1] * scale
        a = interp_matrix(sh, torch.clamp(r[:, 3] * scale - sh, min=1.0), pooled, h)
        b = interp_matrix(sw, torch.clamp(r[:, 2] * scale - sw, min=1.0), pooled, wd)
        t = torch.einsum("rqw,hwc->rhqc", b, f.float())
        outs.append(torch.einsum("rph,rhqc->rpqc", a, t).to(features.dtype))
    return torch.stack(outs)


# ------------------------------------------------------------- boxes

def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def clip_two_sided(boxes, size):
    w, h = size[..., 0:1], size[..., 1:2]
    x = torch.minimum(boxes[..., 0::2].clamp(min=0.0), w - 1)
    y = torch.minimum(boxes[..., 1::2].clamp(min=0.0), h - 1)
    return torch.stack([x, y], -1).reshape(*boxes.shape[:-1], -1)


# ------------------------------------------------------------- on-line heads

def gaussian_kernel(x, c, sigma: float):
    sq = ((x * x).sum(-1)[..., :, None] + (c * c).sum(-1)[..., None, :]
          - 2.0 * torch.matmul(x, c.transpose(-1, -2)))
    return torch.exp(-sq.clamp(min=0.0) / (2.0 * sigma * sigma))


def rls_predict(rls: Dict, x):
    """[N, d] -> [N, C, 4]; zero where a class has no model."""
    yw = torch.einsum("nd,cdk->nck", x, rls["beta"][:, :-1]) + rls["beta"][:, -1][None]
    out = torch.einsum("nck,ckl->ncl", yw, rls["t_inv"]) + rls["mu"][None]
    return torch.where(rls["exists"][None, :, None], out, torch.zeros_like(out))


def models_of(online) -> Dict:
    """The on-line models as plain dicts of tensors, read from the program's
    trained-model objects by field name (the benchmark judges them with the
    reference's own arithmetic)."""
    def falkon(f):
        return {"centers": f.centers, "alpha": f.alpha, "exists": f.exists, "sigma": f.sigma}

    def rls(r):
        return {k: getattr(r, k) for k in ("beta", "t_inv", "t", "mu", "exists")}

    def stats(s):
        return {"mean": s.mean, "mean_norm": s.mean_norm}

    out = {"detector": {"falkon": falkon(online.detector.falkon),
                        "rls": rls(online.detector.rls), "stats": stats(online.detector.stats)}}
    out["rpn"] = None if online.rpn is None else {
        "falkon": falkon(online.rpn.falkon), "rls": rls(online.rpn.rls),
        "stats": stats(online.rpn.stats)}
    out["mask"] = None if online.mask is None else {
        "falkon": falkon(online.mask.falkon), "stats": stats(online.mask.stats)}
    return out


def box_features(w: Dict, c4: torch.Tensor, boxes: torch.Tensor,
                 prec: Precision = CONFIGURED) -> torch.Tensor:
    """The harvest's row features: RoIAlign of each image's boxes [B, R, 4]
    on its C4 map, res5, spatial mean in f32 -> [B, R, 2048]."""
    with fp32_mode(prec):
        pooled = roi_align(c4, boxes)
        b, r = pooled.shape[:2]
        m = res5_map(w, pooled.reshape((b * r,) + pooled.shape[2:]), prec)
        return m.float().mean(dim=(1, 2)).reshape(b, r, -1)


def gt_features(w: Dict, images_u8, gt_boxes, prec: Precision = CONFIGURED):
    """The harvest's GT-row features of canvases [B, H, W, 3] -> [B, G, 2048]."""
    with fp32_mode(prec):
        return box_features(w, backbone_c4(w, images_u8, prec), gt_boxes, prec)
