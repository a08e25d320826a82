"""Fused ResNet stem: conv7x7/2 + frozen BN + ReLU + maxpool3x3/2.

Counterpart of the JAX package's ``ops/stem_pool.py``. ``stem_fused`` takes
NHWC images and returns the pooled NHWC map; a CUDA tensor goes through the
hand-written kernel ``csrc/stem_pool.cu`` (any H and W), a CPU tensor through
``stem_reference``, the plain PyTorch version.

Both compute the conv in fp32 from inputs and weights rounded to the input's
dtype (bf16 products are exact in fp32, as on the TPU's MXU), apply scale,
bias and ReLU in fp32, pool, and round once to the input's dtype.

The kernel's bf16 route is an implicit GEMM on the tensor cores over K = 160
slots: the 147 (ky, kx, ci) taps and 13 of zero weight, in the order that
``STEM_QUADS`` fixes (the same table as the kernel's). ``stem_weight_matrix``
gives the [160, 64] weights in that order, ``k_slots`` each slot's tap, and
``pack_stem_weights`` the matrix in the order in which the kernel's
``mma.sync`` B fragments read it.

``stem_fused`` is differentiable in ``w``, ``scale`` and ``bias`` when
autograd records (``StemFunction``; the images get no gradient): the forward
is the same call, the backward ``stem_backward``, which recomputes the
pre-pool map with a plain conv and differentiates the frozen-BN affine, the
ReLU and the max-pool. The JAX package differentiates its XLA stem and has no
backward kernel, so neither has the port.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from online_detection_tpu_torch.ops import _build

_KERNEL = "stem_pool"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


#: K order of the bf16 kernel (``csrc/stem_pool.cu``, ``quad``): quad q holds
#: slots 8q .. 8q + 7; its thread t (0..3) holds the pair of elements
#: (2p, 2p + 1) of filter row ky, with (ky, p) = (ky0 + t, p0) when ``down``
#: else (ky0, p0 + t). Element j of a filter row is (kx, ci) = divmod(j, 3);
#: kx = 7 carries zero weight.
STEM_QUADS = tuple([(0, p, 1) for p in range(11)]
                   + [(ky, p, 0) for ky in (4, 5, 6) for p in (0, 4, 8)])
K_SLOTS = 8 * len(STEM_QUADS)  # 160


def k_slots() -> np.ndarray:
    """[160, 3] int: (ky, kx, ci) of each K slot; kx == 7 has zero weight."""
    out = np.zeros((K_SLOTS, 3), np.int64)
    for q, (ky0, p0, down) in enumerate(STEM_QUADS):
        for t in range(4):
            ky, p = (ky0 + t, p0) if down else (ky0, p0 + t)
            for e in range(2):
                out[8 * q + 2 * t + e] = (ky, *divmod(2 * p + e, 3))
    return out


def stem_weight_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW [64, 3, 7, 7] -> [160, 64] in ``k_slots`` order, rounded to dtype,
    zero rows where kx == 7."""
    ky, kx, ci = (torch.from_numpy(c) for c in k_slots().T)
    real = (kx < 7).to(w.device)
    cols = w.to(dtype)[:, ci.clamp(max=2), ky, kx.clamp(max=6)]  # [64, 160]
    return torch.where(real, cols, torch.zeros((), dtype=dtype, device=w.device)).T.contiguous()


def fragment_index() -> np.ndarray:
    """Flat [160 * 64] index into the [160, 64] weight matrix, in the order the
    kernel reads B: [k16 step s][n16 pair jp][lane][8], where lane = 4g + t
    holds B[16s + 2t + {0, 1, 8, 9}][16jp + g] and then the same for n + 8
    (the m16n8k16 B fragments of n tiles 2jp and 2jp + 1)."""
    s, jp, lane, e = np.meshgrid(np.arange(K_SLOTS // 16), np.arange(4), np.arange(32),
                                 np.arange(8), indexing="ij")
    g, t = lane // 4, lane % 4
    k = 16 * s + 2 * t + (e & 1) + 8 * ((e >> 1) & 1)
    n = 16 * jp + 8 * (e >> 2) + g
    return (k * 64 + n).reshape(-1)


def pack_stem_weights(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel's bf16 weights: ``stem_weight_matrix`` in fragment order,
    flat [10240]."""
    idx = torch.from_numpy(fragment_index()).to(w.device)
    return stem_weight_matrix(w, dtype).reshape(-1)[idx]


#: id(w) -> (weak reference to w, w's version, its packed weights)
_PACKED = {}


def _packed_weights(w: torch.Tensor) -> torch.Tensor:
    """``pack_stem_weights(w)``, kept while ``w`` lives and is not changed in
    place (its version counter). A tensor made under ``inference_mode`` has
    no version counter and is packed anew on every call."""
    try:
        version = w._version
    except RuntimeError:
        return pack_stem_weights(w)
    key = id(w)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == version:
        return hit[2]
    packed = pack_stem_weights(w)
    _PACKED[key] = (weakref.ref(w, lambda _: _PACKED.pop(key, None)), version, packed)
    return packed


def pooled_size(h: int, w: int):
    """(H4, W4) of the stem output: conv /2 (pad 3), then pool /2 (pad 1)."""
    h2, w2 = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    return (h2 - 1) // 2 + 1, (w2 - 1) // 2 + 1


def stem_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Plain version. x [B, H, W, 3]; w [64, 3, 7, 7] (OIHW) -> [B, H4, W4, 64]
    (float64 inputs are computed in float64)."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(ct)
    y = F.conv2d(xf, wf, stride=2, padding=3)
    y = torch.relu(y * scale.to(ct)[:, None, None] + bias.to(ct)[:, None, None])
    y = F.max_pool2d(y, kernel_size=3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _stem_cuda(x, w, scale, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"the stem kernel takes float32 or bfloat16, not {x.dtype}")
    b, h, wd, cin = x.shape
    if cin != 3 or tuple(w.shape) != (64, 3, 7, 7) or scale.numel() != 64 \
            or bias.numel() != 64:
        raise ValueError(f"stem shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"scale {tuple(scale.shape)} bias {tuple(bias.shape)}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x = x.contiguous()
    if x.dtype == torch.bfloat16:  # the tensor-core route
        wk = _packed_weights(w)
    else:  # the fp32 route takes HWIO fp32
        wk = w.float().permute(2, 3, 1, 0).contiguous()
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    h4, w4 = pooled_size(h, wd)
    out = torch.empty((b, h4, w4, 64), device=x.device, dtype=x.dtype)
    fn = _build.load(_KERNEL).odt_stem_fused
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    status = _build.launch(fn, x.device, x.data_ptr(), wk.data_ptr(), sc.data_ptr(),
                           bi.data_ptr(), out.data_ptr(), b, h, wd, _DTYPES[x.dtype])
    _build.check(status, "odt_stem_fused")
    _build.LAUNCHES[_KERNEL] += 1
    return out


def _forward(x, w, scale, bias):
    if x.is_cuda:
        return _stem_cuda(x, w, scale, bias)
    return stem_reference(x, w, scale, bias)


def stem_backward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  grad: torch.Tensor):
    """Gradients of the stem in (w, scale, bias) for the output gradient
    ``grad`` [B, H4, W4, 64], from torch ops on x's device: the pre-pool map
    ``y = conv(x, w)`` is recomputed in fp32 (float64 for float64 inputs;
    from inputs and weights rounded to x's dtype, as the forward takes
    them), and ``z = y * scale + bias``, ``relu(z)`` and the 3x3/2 max-pool
    are differentiated by hand. The pool's gradient goes to the first
    maximum of each window (torch's pool index); two windows that share
    their maximum both add to it. ReLU's gradient is 0 at z = 0, as
    ``jax.nn.relu``'s is."""
    ct = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(ct).permute(0, 3, 1, 2)
    wf = w.to(x.dtype).to(ct)
    y = F.conv2d(xf, wf, stride=2, padding=3)
    s, b = scale.to(ct)[:, None, None], bias.to(ct)[:, None, None]
    z = y * s + b
    _, idx = F.max_pool2d(torch.relu(z), kernel_size=3, stride=2, padding=1, return_indices=True)
    g = grad.to(ct).permute(0, 3, 1, 2)
    dr = torch.zeros_like(z).flatten(2).scatter_add_(2, idx.flatten(2), g.flatten(2))
    dz = dr.view_as(z) * (z > 0)
    dw = torch.nn.grad.conv2d_weight(xf, wf.shape, dz * s, stride=2, padding=3)
    return (dw.to(w.dtype), (dz * y).sum(dim=(0, 2, 3)).to(scale.dtype),
            dz.sum(dim=(0, 2, 3)).to(bias.dtype))


class StemFunction(torch.autograd.Function):
    """The fused stem, differentiable in its weights, scale and bias."""

    @staticmethod
    def forward(ctx, x, w, scale, bias):
        ctx.save_for_backward(x, w, scale, bias)
        return _forward(x, w, scale, bias)

    @staticmethod
    def backward(ctx, grad):
        x, w, scale, bias = ctx.saved_tensors
        return (None, *stem_backward(x, w, scale, bias, grad))


def stem_fused(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Fused stem -> [B, H4, W4, 64] NHWC in x's dtype; differentiable in
    ``w``, ``scale`` and ``bias`` when autograd records."""
    if torch.is_grad_enabled() and (w.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return StemFunction.apply(x, w, scale, bias)
    return _forward(x, w, scale, bias)
