"""RoIAlign with legacy-Detectron semantics (counterpart of ``ops/roi_align.py``).

- ``roi_start = coord * spatial_scale`` (no half-pixel shift),
- ``roi_size = max(end - start, 1)``,
- adaptive ``n = clip(ceil(roi_size / pooled), 1, max_samples)`` samples per
  bin and axis, each interpolated bilinearly and averaged,
- a sample with coordinate < -1 or > dim contributes 0; otherwise the
  coordinate is clamped to [0, dim - 1].

``roi_align_batched`` is the entry the inference path calls: a CUDA tensor
goes through the hand-written kernel ``csrc/roi_align.cu`` (direct per-bin
sampling), a CPU tensor through ``roi_align_reference``, the plain separable
form ``A @ F @ B^T`` with per-RoI interpolation matrices. Both accumulate in
fp32 and round once to the features' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from online_detection_tpu_torch.ops import _build

_KERNEL = "roi_align"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SAMPLES = 8


def interp_matrix(start: torch.Tensor, size: torch.Tensor, pooled: int, dim: int,
                  max_samples: int = MAX_SAMPLES) -> torch.Tensor:
    """[R] starts and sizes -> [R, pooled, dim] averaged-bilinear weights for
    one axis."""
    dev = start.device
    bin_size = (size / pooled)[:, None, None]  # [R, 1, 1]
    n = torch.clamp(torch.ceil(bin_size), 1, max_samples)
    p = torch.arange(pooled, dtype=torch.float32, device=dev)[None, :, None]
    s = torch.arange(max_samples, dtype=torch.float32, device=dev)[None, None, :]
    coord = start[:, None, None] + (p + (s + 0.5) / n) * bin_size  # [R, P, S]
    keep = (coord >= -1.0) & (coord <= dim) & (s < n)
    c = coord.clamp(0.0, dim - 1.0)
    low = torch.floor(c)
    frac = c - low
    grid = torch.arange(dim, dtype=torch.float32, device=dev)
    w = ((grid == low[..., None]) * (1.0 - frac[..., None])
         + (grid == (low[..., None] + 1.0)) * frac[..., None])
    w = w * keep[..., None]  # [R, P, S, D]
    return w.sum(dim=2) / n


def _matrices(rois: torch.Tensor, pooled: int, h: int, w: int, spatial_scale: float):
    rois = rois.float()
    start_w = rois[:, 0] * spatial_scale
    start_h = rois[:, 1] * spatial_scale
    size_w = torch.clamp(rois[:, 2] * spatial_scale - start_w, min=1.0)
    size_h = torch.clamp(rois[:, 3] * spatial_scale - start_h, min=1.0)
    return (interp_matrix(start_h, size_h, pooled, h),
            interp_matrix(start_w, size_w, pooled, w))


def roi_align_reference(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                        spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Plain version. features [B, H, W, C], rois [B, R, 4] -> [B, R, P, P, C]."""
    _, h, w, _ = features.shape
    outs = []
    for f, r in zip(features, rois):  # one image at a time bounds the intermediate
        a, b = _matrices(r, pooled, h, w, spatial_scale)  # [R, P, H], [R, P, W]
        t = torch.einsum("rqw,hwc->rhqc", b, f.float())
        outs.append(torch.einsum("rph,rhqc->rpqc", a, t).to(features.dtype))
    return torch.stack(outs)


def _roi_align_cuda(features, rois, pooled, spatial_scale):
    if features.dtype not in _DTYPES:
        raise TypeError(f"the RoIAlign kernel takes float32 or bfloat16, not {features.dtype}")
    b, h, w, c = features.shape
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois {tuple(rois.shape)} for features {tuple(features.shape)}")
    if rois.device != features.device:
        raise ValueError(f"rois are on {rois.device}, features on {features.device}")
    r = rois.shape[1]
    features = features.contiguous()
    rois = rois.float().contiguous()
    out = torch.empty((b, r, pooled, pooled, c), device=features.device, dtype=features.dtype)
    fn = _build.load(_KERNEL).odt_roi_align
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(features.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c,
                pooled, float(spatial_scale), _DTYPES[features.dtype],
                torch.cuda.current_stream(features.device).cuda_stream)
    _build.check(status, "odt_roi_align")
    _build.LAUNCHES[_KERNEL] += 1
    return out


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                      spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Batched RoIAlign: [B, H, W, C] x [B, R, 4] -> [B, R, P, P, C]."""
    if features.is_cuda:
        return _roi_align_cuda(features, rois, pooled, spatial_scale)
    return roi_align_reference(features, rois, pooled, spatial_scale)


def roi_align(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
              spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """One image: [H, W, C] x [R, 4] -> [R, P, P, C]."""
    return roi_align_batched(features[None], rois[None], pooled, spatial_scale)[0]
