"""RoIAlign with legacy-Detectron semantics (counterpart of ``ops/roi_align.py``).

- ``roi_start = coord * spatial_scale`` (no half-pixel shift),
- ``roi_size = max(end - start, 1)``,
- adaptive ``n = clip(ceil(roi_size / pooled), 1, max_samples)`` samples per
  bin and axis, each interpolated bilinearly and averaged,
- a sample with coordinate < -1 or > dim contributes 0; otherwise the
  coordinate is clamped to [0, dim - 1].

``roi_align_batched`` (kernel B3) is the entry the inference path calls,
``roi_align_fused2`` (kernel B4) the one the harvest pass calls. On a CUDA
tensor each launches its own kernel, ``csrc/roi_align.cu`` and
``csrc/roi_align_fused2.cu``, which share one body
(``csrc/roi_align_common.cuh``: a warp per pooled row and 256-channel tile
contracts H, then W) and keep two launch counters. On a CPU tensor each
takes its plain version: ``roi_align_reference``, the separable form
``A @ F @ B^T`` with per-RoI interpolation matrices, and
``roi_align_fused2_reference``, the same function computed as the JAX
package's ``roi_align_fused2`` computes it (stage 1 contracts H, stage 2 W).

All of them accumulate in fp32 and round once to the features' dtype.

``roi_align_batched`` and ``roi_align`` are differentiable in ``features``
(``RoIAlignFunction``) when autograd records: the forward is the same call,
the backward ``roi_align_backward``, the transpose ``dF = sum_r A_r^T g_r
B_r``: kernel ``csrc/roi_align_backward.cu`` on a CUDA tensor (its own launch
counter), ``roi_align_backward_reference`` on a CPU tensor. The kernel reads
g from device memory once: persistent blocks bring each (RoI, 128-channel
tile) slab of g into a shared-memory ring by TMA while their consumer warps
contract the previous slab in registers and add it into dF with one atomic
per cell the RoI touches and channel vector. The boxes get no gradient:
the JAX trainer stops the proposals' gradient, and GT boxes are constants.
A call that autograd does not record (no grad, or ``inference_mode``) takes
the forward alone, as before.
"""

from __future__ import annotations

import ctypes

import torch

from online_detection_tpu_torch.ops import _build

_KERNEL = "roi_align"
_FUSED2 = "roi_align_fused2"
_BACKWARD = "roi_align_backward"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SAMPLES = 8
# what the kernels take (roi::MAX_POOLED and roi::MAX_DIM in
# csrc/roi_align_common.cuh): pooled <= 32, H and W <= 128, C a whole number
# of 16-byte vectors, 16-byte aligned features
MAX_POOLED = 32
MAX_DIM = 128
VECTOR_BYTES = 16


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
    """Plain version. features [B, H, W, C], rois [B, R, 4] -> [B, R, P, P, C]
    (float64 features are summed in float64)."""
    _, h, w, _ = features.shape
    ct = torch.promote_types(features.dtype, torch.float32)
    outs = []
    for f, r in zip(features, rois):  # one image at a time bounds the intermediate
        a, b = _matrices(r, pooled, h, w, spatial_scale)  # [R, P, H], [R, P, W]
        t = torch.einsum("rqw,hwc->rhqc", b.to(ct), f.to(ct))
        outs.append(torch.einsum("rph,rhqc->rpqc", a.to(ct), t).to(features.dtype))
    return torch.stack(outs)


def check_kernel_args(features: torch.Tensor, rois: torch.Tensor, pooled: int) -> None:
    """Raise on what kernels B3 and B4 do not take: ``TypeError`` for a dtype
    other than float32 or bfloat16, ``ValueError`` for mismatched shapes or
    devices, ``pooled`` outside [1, 32], H or W outside [1, 128], a C that is
    not a whole number of 16-byte vectors, or features that are not
    contiguous and 16-byte aligned."""
    if features.dtype not in _DTYPES:
        raise TypeError(f"the RoIAlign kernels take float32 or bfloat16, not {features.dtype}")
    if features.dim() != 4:
        raise ValueError(f"features must be [B, H, W, C], not {tuple(features.shape)}")
    b, h, w, c = features.shape
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[2] != 4:
        raise ValueError(f"rois {tuple(rois.shape)} for features {tuple(features.shape)}")
    if rois.device != features.device:
        raise ValueError(f"rois are on {rois.device}, features on {features.device}")
    if not 1 <= pooled <= MAX_POOLED:
        raise ValueError(f"the RoIAlign kernels take pooled <= {MAX_POOLED}, not {pooled}")
    if not (1 <= h <= MAX_DIM and 1 <= w <= MAX_DIM):
        raise ValueError(f"the RoIAlign kernels take H and W <= {MAX_DIM}, not {h}x{w}")
    vec = VECTOR_BYTES // features.element_size()
    if c < vec or c % vec:
        raise ValueError(f"the RoIAlign kernels take C a multiple of {vec} for "
                         f"{features.dtype}, not {c}")
    if not features.is_contiguous() or features.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"the RoIAlign kernels take contiguous features aligned to "
                         f"{VECTOR_BYTES} bytes")


def _launch(name: str, features, rois, pooled, spatial_scale):
    """Kernel ``name`` (``roi_align`` or ``roi_align_fused2``) on CUDA tensors."""
    features = features.contiguous()
    check_kernel_args(features, rois, pooled)
    b, h, w, c = features.shape
    r = rois.shape[1]
    rois = rois.float().contiguous()
    out = torch.empty((b, r, pooled, pooled, c), device=features.device, dtype=features.dtype)
    fn = getattr(_build.load(name), f"odt_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    status = fn(features.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c,
                pooled, float(spatial_scale), _DTYPES[features.dtype],
                torch.cuda.current_stream(features.device).cuda_stream)
    _build.check(status, f"odt_{name}")
    _build.LAUNCHES[name] += 1
    return out


def _forward(features, rois, pooled, spatial_scale):
    if features.is_cuda:
        return _launch(_KERNEL, features, rois, pooled, spatial_scale)
    return roi_align_reference(features, rois, pooled, spatial_scale)


def roi_align_backward_reference(grad: torch.Tensor, rois: torch.Tensor, h: int, w: int,
                                 pooled: int = 14, spatial_scale: float = 1.0 / 16.0,
                                 roi_chunk: int = 64) -> torch.Tensor:
    """Plain version of the backward: grad [B, R, P, P, C], rois [B, R, 4] ->
    dF [B, H, W, C] f32 (f64 for a float64 grad), ``dF = sum_r A_r^T g_r
    B_r`` with the forward's interpolation matrices, ``roi_chunk`` RoIs at a
    time (the intermediate is [chunk, P, W, C])."""
    b, r = rois.shape[:2]
    ct = torch.promote_types(grad.dtype, torch.float32)
    out = grad.new_zeros((b, h, w, grad.shape[-1]), dtype=ct)
    for i in range(b):
        for r0 in range(0, r, roi_chunk):
            a, bm = _matrices(rois[i, r0:r0 + roi_chunk], pooled, h, w, spatial_scale)
            t = torch.einsum("rpqc,rqw->rpwc", grad[i, r0:r0 + roi_chunk].to(ct), bm.to(ct))
            out[i] += torch.einsum("rph,rpwc->hwc", a.to(ct), t)
    return out


def roi_align_backward(grad: torch.Tensor, rois: torch.Tensor, h: int, w: int,
                       pooled: int = 14, spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """The gradient of RoIAlign in the features: grad [B, R, P, P, C] f32,
    rois [B, R, 4] -> dF [B, H, W, C] f32. Kernel ``roi_align_backward`` on a
    CUDA tensor, ``roi_align_backward_reference`` on a CPU tensor."""
    if not grad.is_cuda:
        return roi_align_backward_reference(grad, rois, h, w, pooled, spatial_scale)
    if grad.dtype != torch.float32:
        raise TypeError(f"the RoIAlign backward kernel takes float32, not {grad.dtype}")
    grad = grad.contiguous()
    b, r, p, p2, c = grad.shape
    if p != pooled or p2 != pooled or rois.shape[:2] != (b, r):
        raise ValueError(f"grad {tuple(grad.shape)} for rois {tuple(rois.shape)} and "
                         f"pooled {pooled}")
    if grad.data_ptr() % VECTOR_BYTES:
        raise ValueError(f"the RoIAlign backward kernel takes grad aligned to {VECTOR_BYTES} bytes")
    out = torch.zeros((b, h, w, c), device=grad.device, dtype=torch.float32)
    # the forward's limits; the output takes the features' place
    check_kernel_args(out, rois, pooled)
    rois = rois.float().contiguous()
    fn = getattr(_build.load(_BACKWARD), f"odt_{_BACKWARD}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    status = fn(grad.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c, pooled,
                float(spatial_scale), torch.cuda.current_stream(grad.device).cuda_stream)
    _build.check(status, f"odt_{_BACKWARD}")
    _build.LAUNCHES[_BACKWARD] += 1
    return out


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign differentiable in the features (not in the boxes)."""

    @staticmethod
    def forward(ctx, features, rois, pooled, spatial_scale):
        ctx.save_for_backward(rois)
        ctx.meta = (features.shape[1], features.shape[2], pooled, spatial_scale, features.dtype)
        return _forward(features, rois, pooled, spatial_scale)

    @staticmethod
    def backward(ctx, grad):
        (rois,) = ctx.saved_tensors
        h, w, pooled, spatial_scale, dtype = ctx.meta
        dfeat = roi_align_backward(grad, rois.detach(), h, w, pooled, spatial_scale)
        return dfeat.to(dtype), None, None, None


def roi_align_batched(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                      spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Batched RoIAlign: [B, H, W, C] x [B, R, 4] -> [B, R, P, P, C];
    differentiable in ``features`` when autograd records."""
    if features.requires_grad and torch.is_grad_enabled():
        return RoIAlignFunction.apply(features, rois, pooled, spatial_scale)
    return _forward(features, rois, pooled, spatial_scale)


def roi_align(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
              spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """One image: [H, W, C] x [R, 4] -> [R, P, P, C]."""
    return roi_align_batched(features[None], rois[None], pooled, spatial_scale)[0]


def roi_align_nchw(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                   spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """The reference's NCHW layout: [C, H, W] x [R, 4] -> [R, C, P, P], over
    ``roi_align`` (kernel B3 on the card)."""
    out = roi_align(features.permute(1, 2, 0).contiguous(), rois, pooled, spatial_scale)
    return out.permute(0, 3, 1, 2)


def roi_align_fused2_reference(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                               spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Plain version of kernel B4: per image and tile of 16 RoIs (the TPU
    kernel's), stage 1 ``A [16*P, H] @ F [H, W*C]``, then stage 2 contracts W
    with each RoI's ``B``. features [B, H, W, C], rois [B, R, 4] ->
    [B, R, P, P, C]."""
    roi_tile = 16
    b, h, w, c = features.shape
    r = rois.shape[1]
    out = features.new_empty((b, r, pooled, pooled, c))
    for i in range(b):
        f = features[i].float().reshape(h, w * c)
        for r0 in range(0, r, roi_tile):
            a, bm = _matrices(rois[i, r0:r0 + roi_tile], pooled, h, w, spatial_scale)
            t1 = (a.reshape(-1, h) @ f).reshape(a.shape[0], pooled, w, c)
            out[i, r0:r0 + roi_tile] = torch.einsum("rqw,rpwc->rpqc", bm, t1).to(out.dtype)
    return out


def roi_align_fused2(features: torch.Tensor, rois: torch.Tensor, pooled: int = 14,
                     spatial_scale: float = 1.0 / 16.0) -> torch.Tensor:
    """Batched RoIAlign by separable contractions (kernel B4):
    [B, H, W, C] x [B, R, 4] -> [B, R, P, P, C]."""
    if features.is_cuda:
        return _launch(_FUSED2, features, rois, pooled, spatial_scale)
    return roi_align_fused2_reference(features, rois, pooled, spatial_scale)
