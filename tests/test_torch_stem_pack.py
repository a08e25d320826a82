"""The bf16 stem kernel's K order and weight packing, held on the CPU.

The kernel (``online_detection_tpu_torch/csrc/stem_pool.cu``,
``stem_kernel_mma``) cannot run here, so this file emulates its arithmetic
with the same tables the wrapper hands it: per block of 8 x 16 pooled
outputs, the input patch with rows of ``RS`` elements, A gathered at each
conv position's patch corner plus the quads' offsets, a GEMM with the
[160, 64] weight matrix, the epilogue (scale, bias, ReLU, zero outside the
conv map, rounding to the input's dtype) and the 3x3/2 max. It must equal
``stem_reference``: within 1 bf16 ulp + 1e-5 max|ref| for bf16 (fp32 sums in
another order, then one rounding), within 1e-5 max|ref| for f32. The
fragment packing is checked against the m16n8k16 B-fragment layout of the
PTX ISA, and the quad table against the kernel's source."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from online_detection_tpu_torch.ops import stem_pool as sp

torch.set_num_threads(2)

SRC = Path(sp.__file__).resolve().parent.parent / "csrc" / "stem_pool.cu"
TPH, TPW, RS = 8, 16, 240
CH, CW = 2 * TPH + 1, 2 * TPW + 1
IH, PW = 2 * (CH - 1) + 7, 2 * (CW - 1) + 8


def _kernel_constant(name):
    """A constant of the bf16 route (namespace tc of the source)."""
    text = SRC.read_text()
    text = text[text.index("namespace tc {"):]
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_quad_table_and_tile_match_the_kernel_source():
    text = SRC.read_text()
    table = text[text.index("QUADS-BEGIN"):text.index("QUADS-END")]
    quads = tuple(tuple(int(v) for v in m) for m in
                  re.findall(r"\{(\d+), (\d+), (\d+)\}", table))
    assert quads == sp.STEM_QUADS
    assert (_kernel_constant("TPH"), _kernel_constant("TPW"), _kernel_constant("RS")) == (
        TPH, TPW, RS)


def test_k_slots_cover_every_tap_once():
    slots = sp.k_slots()
    real = slots[slots[:, 1] < 7]
    assert len(slots) == 160 and len(real) == 147
    assert {tuple(r) for r in real} == {(ky, kx, ci) for ky in range(7) for kx in range(7)
                                        for ci in range(3)}
    assert set(slots[slots[:, 1] == 7, 1]) == {7}  # the zero-weight slots read column 7


def _quad_offsets():
    """Patch offset of each K slot as the kernel forms it: the quad's
    constant, plus 2t (along a row) or RS*t (down the rows), plus e."""
    off = np.zeros(160, np.int64)
    for q, (ky0, p0, down) in enumerate(sp.STEM_QUADS):
        for t in range(4):
            for e in range(2):
                off[8 * q + 2 * t + e] = ky0 * RS + 2 * p0 + (RS * t if down else 2 * t) + e
    return off


def test_quad_offsets_address_the_slot_taps():
    ky, kx, ci = sp.k_slots().T
    np.testing.assert_array_equal(_quad_offsets(), ky * RS + 3 * kx + ci)


def test_packed_weights_follow_the_b_fragment_layout(rng):
    w = torch.from_numpy(rng.normal(size=(64, 3, 7, 7)).astype(np.float32))
    mat = sp.stem_weight_matrix(w, torch.bfloat16)
    packed = sp.pack_stem_weights(w).reshape(10, 4, 32, 8)  # [k16 step][n16][lane][8]
    got = torch.zeros_like(mat)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for half in range(2):  # n tiles 2jp and 2jp + 1 in one 16-byte load
            regs = packed[:, :, lane, 4 * half:4 * half + 4]  # b0 = (k 2t, 2t+1), b1 = +8
            for i, dk in enumerate((0, 1, 8, 9)):
                for jp in range(4):
                    got[16 * torch.arange(10) + 2 * t + dk, 16 * jp + 8 * half + g] = \
                        regs[:, jp, i]
    assert torch.equal(got, mat)
    ky, kx, ci = sp.k_slots().T
    real = kx < 7
    want = w.to(torch.bfloat16)[:, ci[real], ky[real], kx[real]].T
    assert torch.equal(mat[torch.from_numpy(real)], want)
    assert not mat[torch.from_numpy(~real)].any()


def emulate_kernel(x, w, scale, bias):
    """The bf16 kernel's arithmetic, block by block (see the module note)."""
    b, h, wd, _ = x.shape
    h2, w2 = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    h4, w4 = sp.pooled_size(h, wd)
    mat = sp.stem_weight_matrix(w, x.dtype).float()
    koff = torch.from_numpy(_quad_offsets())
    m = torch.arange(CH * CW)
    corner = 2 * (m // CW) * RS + 6 * (m % CW)
    rows = x.float().reshape(b, h, wd * 3)
    out = torch.zeros((b, h4, w4, 64), dtype=x.dtype)
    for ph0 in range(0, h4, TPH):
        for pw0 in range(0, w4, TPW):
            cy0, cx0 = 2 * ph0 - 1, 2 * pw0 - 1
            iy0, ix0 = 2 * cy0 - 3, 2 * cx0 - 3
            gy = torch.arange(IH)[:, None] + iy0
            ge = torch.arange(PW * 3)[None, :] + 3 * ix0
            inside = (gy >= 0) & (gy < h) & (ge >= 0) & (ge < wd * 3)
            patch = torch.zeros((b, IH, RS))
            patch[:, :, :PW * 3] = torch.where(
                inside, rows[:, gy.clamp(0, h - 1), ge.clamp(0, wd * 3 - 1)], 0.0)
            a = patch.reshape(b, -1)[:, corner[:, None] + koff[None, :]]  # [b, 561, 160]
            acc = a @ mat
            v = torch.relu(acc * scale.float() + bias.float())
            cy, cx = cy0 + m // CW, cx0 + m % CW
            in_map = (cy >= 0) & (cy < h2) & (cx >= 0) & (cx < w2)
            conv = torch.where(in_map[None, :, None], v, 0.0).to(x.dtype).reshape(b, CH, CW, 64)
            pooled = conv[:, 0:2 * TPH - 1:2, 0:2 * TPW - 1:2]
            for dy in range(3):
                for dx in range(3):
                    pooled = torch.maximum(
                        pooled, conv[:, dy:dy + 2 * TPH - 1:2, dx:dx + 2 * TPW - 1:2])
            nh, nw = min(TPH, h4 - ph0), min(TPW, w4 - pw0)
            out[:, ph0:ph0 + nh, pw0:pw0 + nw] = pooled[:, :nh, :nw]
    return out


def _ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp(min=1e-30))) - 7)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 37, 53, 3), (2, 70, 141, 3)])
def test_tiled_im2col_gemm_matches_stem_reference(rng, shape, dtype):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 3).to(dtype)
    w = torch.from_numpy(rng.normal(size=(64, 3, 7, 7)).astype(np.float32) * 0.1)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, size=64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=64).astype(np.float32) * 0.1)
    got = emulate_kernel(x, w, scale, bias).float()
    ref = sp.stem_reference(x, w, scale, bias).float()
    assert got.shape == ref.shape
    tol = 1e-5 * ref.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + _ulp(ref)
    assert bool(((got - ref).abs() <= tol).all()), float((got - ref).abs().max())


def test_packed_weights_are_kept_until_the_weights_change(rng):
    w = torch.from_numpy(rng.normal(size=(64, 3, 7, 7)).astype(np.float32))
    first = sp._packed_weights(w)
    assert sp._packed_weights(w) is first
    w.mul_(2.0)  # in place: the version counter moves
    second = sp._packed_weights(w)
    assert second is not first and torch.equal(second, sp.pack_stem_weights(w))
    with torch.inference_mode():  # no version counter: packed anew each call
        wi = torch.from_numpy(rng.normal(size=(64, 3, 7, 7)).astype(np.float32))
        assert sp._packed_weights(wi) is not sp._packed_weights(wi)
    key = id(w)
    del w
    assert key not in sp._PACKED


def test_emulated_kernel_within_one_ulp_of_the_pallas_stem(rng):
    """The kernel's arithmetic on bf16 inputs against the JAX package's
    ``stem_fused`` (Pallas, interpret mode) on the same inputs."""
    import jax.numpy as jnp

    from online_detection_tpu.ops.stem_pool import stem_fused as j_stem_fused

    x = rng.normal(size=(1, 40, 72, 3)).astype(np.float32)
    w_hwio = (rng.normal(size=(7, 7, 3, 64)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = emulate_kernel(xb, torch.from_numpy(np.transpose(w_hwio, (3, 2, 0, 1)).copy()),
                         torch.from_numpy(scale), torch.from_numpy(bias)).float()
    want = torch.from_numpy(np.asarray(j_stem_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_hwio, jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(bias), interpret=True), np.float32))
    assert got.shape == want.shape == (1, 10, 18, 64)
    assert bool(((got - want).abs() <= _ulp(want) + 1e-5 * want.abs().max()).all())
