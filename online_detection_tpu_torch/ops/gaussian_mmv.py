"""Gaussian-kernel matrix-vector products: ``K(X, C) @ V``.

``K(x, c) = exp(-||x - c||^2 / (2 sigma^2))``, with the squared distance
expanded as ``||x||^2 + ||c||^2 - 2 x.c``. Counterpart of the JAX package's
``ops/gaussian_mmv.py``.

``mmv_grouped`` is the one entry every caller uses. It scores G groups of
rows, each against one center set picked by ``set_idx``; a CUDA tensor goes
through the hand-written kernels of ``csrc/gaussian_mmv.cu``, a CPU tensor
through ``mmv_reference``, the plain PyTorch version of the same function.

The cross term and ``K @ v`` cancel, so they run at fp32 accuracy (a single
reduced-precision pass cost det mAP 0.92 -> 0.50 on the TPU): on the card as
3xTF32 on the tensor cores (``split_tf32`` splits each operand into two
tf32 halves, ``x.c ~ x_hi.c_hi + x_hi.c_lo + x_lo.c_hi``; the tensor cores
sum 32 columns of d at a time, and the partials are added in IEEE fp32),
in the plain version as IEEE fp32.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from online_detection_tpu_torch.ops import _build

_KERNEL = "gaussian_mmv"
_SPLIT = "tf32_split"  # the split kernel, built from the same source
# bound on the [chunk, N, M] kernel block the plain version materialises
_REF_BLOCK_BYTES = 1 << 30


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * x, dim=-1)


def gaussian_kernel(x: torch.Tensor, c: torch.Tensor, sigma: float) -> torch.Tensor:
    """Dense K(x, c): [..., N, d] x [..., M, d] -> [..., N, M]."""
    sq = (
        _sq_norms(x)[..., :, None]
        + _sq_norms(c)[..., None, :]
        - 2.0 * torch.matmul(x, c.transpose(-1, -2))
    )
    return torch.exp(-sq.clamp(min=0.0) / (2.0 * sigma * sigma))


def _groups(x: torch.Tensor, centers: torch.Tensor, set_idx: Optional[torch.Tensor]):
    if set_idx is None:
        set_idx = torch.arange(centers.shape[0], device=centers.device, dtype=torch.int32)
    g = set_idx.shape[0]
    if x.dim() == 3 and x.shape[0] != g:
        raise ValueError(f"x has {x.shape[0]} groups, set_idx {g}")
    return set_idx, g


def mmv_reference(
    x: torch.Tensor,
    centers: torch.Tensor,
    v: torch.Tensor,
    sigma: float,
    set_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch grouped mmv. x: [N, d] shared by every group, or
    [G, N, d]; centers [S, M, d]; v [S, M]; set_idx [G] (default: one group
    per center set) -> [G, N]."""
    set_idx, g = _groups(x, centers, set_idx)
    idx = set_idx.long()
    n, m = x.shape[-2], centers.shape[1]
    chunk = max(1, _REF_BLOCK_BYTES // max(1, 4 * n * m))
    outs = []
    for g0 in range(0, g, chunk):
        sel = idx[g0:g0 + chunk]
        xg = x if x.dim() == 2 else x[g0:g0 + chunk]
        k = gaussian_kernel(xg, centers[sel], sigma)  # [c, N, M]
        outs.append(torch.matmul(k, v[sel][..., None])[..., 0])
    return torch.cat(outs, dim=0)


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 (10 mantissa bits; ties away from zero), as
    ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the magnitude,
    then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_reference(t: torch.Tensor):
    """Plain version of the split kernel, for t [..., d]: ``hi = tf32(t)``,
    ``lo = tf32(t - hi)`` (``hi + lo`` is within 2^-22 of ``t``, relative)
    and the squared norms [...] over the last axis, in fp32."""
    hi = _round_tf32(t)
    return hi, _round_tf32(t - hi), _sq_norms(t)


def split_tf32(t: torch.Tensor):
    """(hi, lo, squared norms) of an fp32 [..., d] tensor, as
    ``split_tf32_reference``: a CUDA tensor launches the split kernel, a CPU
    tensor takes the plain version."""
    if not t.is_cuda:
        return split_tf32_reference(t)
    if t.dtype != torch.float32:
        raise TypeError("the split kernel takes float32")
    d = t.shape[-1]
    if d % 4:
        raise ValueError(f"the split kernel takes a last axis divisible by 4, not {d}")
    t = t.contiguous()
    if t.data_ptr() % 16:  # read as float4
        t = t.clone()
    hi, lo = torch.empty_like(t), torch.empty_like(t)
    sq = torch.empty(t.shape[:-1], device=t.device, dtype=torch.float32)
    if t.numel() == 0:
        return hi, lo, sq
    fn = _build.load(_KERNEL).odt_split_tf32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    status = _build.launch(fn, t.device, t.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                           sq.data_ptr(), t.numel() // d, d)
    _build.check(status, "odt_split_tf32")
    _build.LAUNCHES[_SPLIT] += 1
    return hi, lo, sq


def _mmv_cuda(x, centers, v, sigma, set_idx, g):
    if x.dtype != torch.float32 or centers.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("the mmv kernel takes float32 x, centers and v")
    dev = x.device
    for name, t in (("centers", centers), ("v", v), ("set_idx", set_idx)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    s, m, d = centers.shape
    n = x.shape[-2]
    if x.shape[-1] != d or v.shape != (s, m):
        raise ValueError(f"shapes x {tuple(x.shape)} centers {tuple(centers.shape)} "
                         f"v {tuple(v.shape)} do not agree")
    if d % 4:
        raise ValueError(f"the mmv kernel takes a feature width divisible by 4, not {d}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # TMA reads from 16-byte aligned rows
        x = x.clone()
    v = v.contiguous()
    set_idx = set_idx.to(torch.int32).contiguous()
    c_hi, c_lo, cs = split_tf32(centers)  # |x|^2 is summed in the mmv kernel
    out = torch.empty((g, n), device=dev, dtype=torch.float32)
    fn = _build.load(_KERNEL).odt_mmv_grouped
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    shared = x.dim() == 2
    status = _build.launch(
        fn, dev, x.data_ptr(), n if shared else g * n, 0 if shared else n,
        c_hi.data_ptr(), c_lo.data_ptr(), s * m, cs.data_ptr(),
        v.data_ptr(), set_idx.data_ptr(), out.data_ptr(), g, n, m, d, float(sigma),
    )
    _build.check(status, "odt_mmv_grouped")
    _build.LAUNCHES[_KERNEL] += 1
    return out


def mmv_grouped(
    x: torch.Tensor,
    centers: torch.Tensor,
    v: torch.Tensor,
    sigma: float,
    set_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped K(x, C_s) @ v_s -> [G, N] (see ``mmv_reference`` for shapes).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    set_idx, g = _groups(x, centers, set_idx)
    if x.is_cuda:
        return _mmv_cuda(x, centers, v, sigma, set_idx, g)
    return mmv_reference(x, centers, v, sigma, set_idx)


def mmv(x: torch.Tensor, c: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """K(x, c) @ v for one center set: x [N, d], c [M, d], v [M] -> [N]."""
    return mmv_grouped(x, c[None], v[None], sigma)[0]
