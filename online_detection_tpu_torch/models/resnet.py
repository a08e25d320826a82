"""ResNet-50-C4 backbone + res5 stage (counterpart of ``models/resnet.py``).

Detectron/Caffe2 conventions: frozen BN folded into ``x * scale + bias``,
the stride of a bottleneck on its first 1x1 conv, BGR 0-255 mean-subtracted
input. Weights are OIHW buffers of ``nn.Module``s.

Public functions take and return NHWC tensors, the JAX package's layout.
Inside the trunk, activations are NCHW views of channels-last memory, which
is the layout cuDNN wants: ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC
tensor is such a view, so no copy is made at the boundaries.

Convs follow the activation dtype (bf16 on the card by default, f32 on the
CPU), as in the JAX package: the weight is cast to the input's dtype and the
frozen-BN affine is applied in that dtype.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from online_detection_tpu_torch.ops.stem_pool import stem_fused

R50_STAGES = (3, 4, 6, 3)
STAGE_CHANNELS = ((64, 256), (128, 512), (256, 1024), (512, 2048))


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBN(nn.Module):
    """A conv (OIHW weight, no bias) followed by a frozen BN affine."""

    def __init__(self, weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW conv with torch's ``padding = k // 2``; output in x's dtype."""
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=w.shape[-1] // 2)


def frozen_bn(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """NCHW affine in x's dtype."""
    return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def conv_bn(x: torch.Tensor, p: ConvBN, stride: int = 1, relu: bool = True) -> torch.Tensor:
    out = frozen_bn(conv(x, p.weight, stride), p.scale, p.bias)
    return torch.relu(out) if relu else out


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 -> 1x1, plus a shortcut (projected when given)."""

    def __init__(self, branch2a: ConvBN, branch2b: ConvBN, branch2c: ConvBN,
                 branch1: Optional[ConvBN] = None, stride: int = 1):
        super().__init__()
        self.branch2a, self.branch2b, self.branch2c = branch2a, branch2b, branch2c
        self.branch1 = branch1
        self.stride = stride


def bottleneck(x: torch.Tensor, p: Bottleneck) -> torch.Tensor:
    shortcut = x if p.branch1 is None else conv_bn(x, p.branch1, p.stride, relu=False)
    out = conv_bn(x, p.branch2a, p.stride)  # stride_in_1x1
    out = conv_bn(out, p.branch2b, 1)
    out = conv_bn(out, p.branch2c, 1, relu=False)
    return torch.relu(out + shortcut)


def stage(x: torch.Tensor, blocks: nn.ModuleList) -> torch.Tensor:
    for b in blocks:
        x = bottleneck(x, b)
    return x


def stem(x: torch.Tensor, p: ConvBN) -> torch.Tensor:
    """NHWC images -> NHWC [B, H/4, W/4, 64]: the fused stem (kernel B2 on
    the card, its plain version on the CPU)."""
    return stem_fused(x, p.weight, p.scale, p.bias)


class ResNetC4(nn.Module):
    """The trunk (stem, res2..res4) and the res5 head stage."""

    def __init__(self, stem: ConvBN, res2: List[Bottleneck], res3: List[Bottleneck],
                 res4: List[Bottleneck], res5: Optional[List[Bottleneck]] = None):
        super().__init__()
        self.stem = stem
        self.res2 = nn.ModuleList(res2)
        self.res3 = nn.ModuleList(res3)
        self.res4 = nn.ModuleList(res4)
        self.res5 = nn.ModuleList(res5 or [])


def backbone_c4(net: ResNetC4, images: torch.Tensor) -> torch.Tensor:
    """images [N, H, W, 3] (BGR, mean-subtracted) -> C4 [N, H/16, W/16, C]."""
    x = to_nchw(stem(images, net.stem))
    for blocks in (net.res2, net.res3, net.res4):
        x = stage(x, blocks)
    return to_nhwc(x)


def res5_feature_map(net: ResNetC4, rois: torch.Tensor) -> torch.Tensor:
    """Pooled RoIs [R, 14, 14, C] -> res5 map [R, 7, 7, 2048] (NHWC)."""
    return to_nhwc(stage(to_nchw(rois), net.res5))


def res5_head(net: ResNetC4, rois: torch.Tensor) -> torch.Tensor:
    """Pooled RoIs -> res5 -> global average pool [R, 2048]."""
    return stage(to_nchw(rois), net.res5).mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# parameter construction


def _conv_bn(rng: np.random.Generator, kh, kw, cin, cout) -> ConvBN:
    w = rng.standard_normal((cout, cin, kh, kw), dtype=np.float32)
    w *= np.float32((2.0 / (kh * kw * cin)) ** 0.5)
    return ConvBN(torch.from_numpy(w), torch.ones(cout), torch.zeros(cout))


def init_resnet50_params(seed: int = 0, include_res5: bool = True,
                         stages=R50_STAGES, channels=STAGE_CHANNELS) -> ResNetC4:
    """Random (He) init of the R-50 trunk from a numpy seed, on the CPU.

    As in the JAX package: the stem weight is divided by 64 (inputs are
    0-255 with no std division, and this keeps random-init activations at
    unit scale), and each ``branch2c`` scale is 0.1 so the residual adds do
    not grow activations exponentially without trained BN statistics."""
    rng = np.random.default_rng(seed)
    stem_p = _conv_bn(rng, 7, 7, 3, 64)
    stem_p.weight /= 64.0
    cin = 64
    built = []
    for si, (n_blocks, (mid, cout)) in enumerate(zip(stages, channels)):
        if si == 3 and not include_res5:
            break
        blocks = []
        for bi in range(n_blocks):
            c2 = _conv_bn(rng, 1, 1, mid, cout)
            c2.scale *= 0.1
            blocks.append(Bottleneck(
                _conv_bn(rng, 1, 1, cin, mid),
                _conv_bn(rng, 3, 3, mid, mid),
                c2,
                _conv_bn(rng, 1, 1, cin, cout) if bi == 0 else None,
                stride=2 if (bi == 0 and si > 0) else 1,
            ))
            cin = cout
        built.append(blocks)
    return ResNetC4(stem_p, *built)
