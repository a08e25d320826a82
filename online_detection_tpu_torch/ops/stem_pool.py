"""Fused ResNet stem: conv7x7/2 + frozen BN + ReLU + maxpool3x3/2.

Counterpart of the JAX package's ``ops/stem_pool.py``. ``stem_fused`` takes
NHWC images and returns the pooled NHWC map; a CUDA tensor goes through the
hand-written kernel ``csrc/stem_pool.cu`` (any H and W), a CPU tensor through
``stem_reference``, the plain PyTorch version.

Both compute the conv in fp32 from inputs and weights rounded to the input's
dtype (bf16 products are exact in fp32, as on the TPU's MXU), apply scale,
bias and ReLU in fp32, pool, and round once to the input's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from online_detection_tpu_torch.ops import _build

_KERNEL = "stem_pool"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pooled_size(h: int, w: int):
    """(H4, W4) of the stem output: conv /2 (pad 3), then pool /2 (pad 1)."""
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (h2 - 1) // 2 + 1, (w2 - 1) // 2 + 1


def stem_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version. x [B, H, W, 3]; w [64, 3, 7, 7] (OIHW) -> [B, H4, W4, 64]."""
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.to(x.dtype).float()
    y = F.conv2d(xf, wf, stride=2, padding=3)
    y = torch.relu(y * scale.float()[:, None, None] + bias.float()[:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _stem_cuda(x, w, scale, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the stem kernel takes float32 or bfloat16, not {x.dtype}")
    b, h, wd, cin = x.shape
    if cin != 3 or tuple(w.shape) != (64, 3, 7, 7):
        raise ValueError(f"stem shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x = x.contiguous()
    wk = w.to(x.dtype).float().permute(2, 3, 1, 0).contiguous()  # OIHW -> HWIO
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    h4, w4 = pooled_size(h, wd)
    out = torch.empty((b, h4, w4, 64), device=x.device, dtype=x.dtype)
    fn = _build.load(_KERNEL).odt_stem_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    status = fn(x.data_ptr(), wk.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                out.data_ptr(), b, h, wd, _DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "odt_stem_fused")
    _build.LAUNCHES[_KERNEL] += 1
    return out


def stem_fused(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Fused stem -> [B, H4, W4, 64] NHWC in x's dtype."""
    if x.is_cuda:
        return _stem_cuda(x, w, scale, bias)
    return stem_reference(x, w, scale, bias)
