"""Gradients of the port's two differentiable kernel entries on the CPU,
where they take their plain versions:

- ``roi_align`` in the features against ``jax.grad`` of the JAX package's
  ``roi_align`` (zero-area boxes and boxes past both edges among them; one
  box repeated 512 times; 64 boxes past the whole map with 8 samples per
  bin; the smoke's 512 adversarial and 512 object-sized boxes), and the backward's plain version against a dense float64
  evaluation;
- ``chip_smoke.roi_footprint`` (the cells the backward kernel adds into a
  RoI, which the smoke reports) against the taps of every sample, worked
  out one by one;
- ``stem_fused`` in ``w``, ``scale`` and ``bias`` against ``jax.grad`` of the
  JAX package's f32 ``resnet.stem`` (its XLA path) at even, odd and ragged
  sizes;
- ``torch.autograd.gradcheck`` of both Functions in float64.

Tolerances: float32 sums in other orders, 2e-5 of the gradient's largest
magnitude for RoIAlign and 1e-4 for the stem, whose weight gradient sums
over every pixel of the image."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from online_detection_tpu.models import resnet as jresnet
from online_detection_tpu.ops.roi_align import roi_align as jroi_align
from online_detection_tpu_torch.ops import roi_align as proi
from online_detection_tpu_torch.ops.stem_pool import StemFunction, stem_fused

torch.set_num_threads(2)


def adversarial_rois(rng, n, h, w, scale=16.0):
    """Boxes in image coordinates of an [h, w] map at stride 16: ordinary,
    zero-area, inverted, past the left/top and the right/bottom edges, whole
    image and larger."""
    hi = np.array([w, h, w, h], np.float32) * scale
    x1 = rng.uniform(-0.2, 0.9, n) * hi[0]
    y1 = rng.uniform(-0.2, 0.9, n) * hi[1]
    boxes = np.stack([x1, y1, x1 + rng.uniform(0, 0.6, n) * hi[0],
                      y1 + rng.uniform(0, 0.6, n) * hi[1]], -1).astype(np.float32)
    special = np.array([
        [40.0, 40.0, 40.0, 40.0],  # zero area
        [100.0, 60.0, 80.0, 50.0],  # inverted
        [-90.0, -70.0, 30.0, 20.0],  # past the left and top edges
        [hi[0] - 40, hi[1] - 30, hi[0] + 120, hi[1] + 90],  # past the right and bottom
        [-50.0, -50.0, hi[0] + 50, hi[1] + 50],  # the whole map and more
        [0.0, 0.0, hi[0] - 1, hi[1] - 1],
        [-400.0, -400.0, -300.0, -300.0],  # wholly outside
    ], np.float32)
    boxes[: len(special)] = special
    return boxes


def dense_backward(grad, rois, h, w, pooled=14, scale=1.0 / 16.0):
    """dF by the forward's matrices, one RoI at a time, in float64."""
    out = np.zeros((h, w, grad.shape[-1]))
    for r in range(rois.shape[0]):
        a, b = proi._matrices(torch.from_numpy(rois[r:r + 1]), pooled, h, w, scale)
        a, b = a[0].double().numpy(), b[0].double().numpy()
        out += np.einsum("ph,pqc,qw->hwc", a, grad[r].astype(np.float64), b)
    return out


@pytest.mark.parametrize("hw,c,r", [((8, 12), 16, 24), ((38, 50), 8, 40), ((5, 3), 4, 9)])
def test_roi_align_grad_matches_jax(hw, c, r):
    rng = np.random.default_rng(hw[0] * 100 + c)
    h, w = hw
    feats = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    rois = adversarial_rois(rng, r, h, w)
    ct = rng.normal(0, 1, (r, 14, 14, c)).astype(np.float32)

    want = jax.grad(lambda f: jnp.sum(jroi_align(f, jnp.asarray(rois)) * ct))(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = proi.roi_align(f, torch.from_numpy(rois))
    assert out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())

    dense = dense_backward(ct, rois, h, w)
    got = proi.roi_align_backward_reference(torch.from_numpy(ct)[None],
                                            torch.from_numpy(rois)[None], h, w)[0]
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=2e-6 * np.abs(dense).max())


def stress_rois(kind, rng, h, w, scale=16.0):
    """The backward kernel's stress layouts on an [h, w] map at stride 16:
    512 copies of one box (every RoI's atomics on the same cells), 64 boxes
    past the whole map with bins over 7 cells a side (8 samples per bin and
    axis, every cell touched), or one of the smoke's 512-box layouts of
    ``chip_smoke.backward_stress_rois`` (adversarial; object-sized)."""
    if kind in ("adversarial x512", "object-sized x512"):
        return chip_smoke.backward_stress_rois(rng, 512, h, w)[kind][0]
    if kind == "one box x512":
        box = np.array([w * 0.25, h * 0.25, w * 0.55, h * 0.6], np.float32) * scale
        return np.tile(box[None], (512, 1))
    lo = -rng.uniform(0, 25, size=(64, 2)) * scale
    hi = (np.array([w, h]) + rng.uniform(110, 150, size=(64, 2))) * scale
    return np.concatenate([lo, hi], -1).astype(np.float32)


STRESS = ["one box x512", "whole map x64", "adversarial x512", "object-sized x512"]


@pytest.mark.parametrize("kind", STRESS)
def test_roi_align_grad_stress_layouts_match_jax(kind):
    rng = np.random.default_rng(len(kind))
    h, w, c = 38, 50, 8
    feats = rng.normal(0, 1, (h, w, c)).astype(np.float32)
    rois = stress_rois(kind, rng, h, w)
    r = rois.shape[0]
    ct = rng.normal(0, 1, (r, 14, 14, c)).astype(np.float32)
    if kind == "whole map x64":  # 8 samples per bin and axis: the widest footprint
        n = np.ceil(np.maximum(rois[:, 2:] - rois[:, :2], 16.0) / 16.0 / 14)
        assert (n >= 8).all()
        assert (chip_smoke.roi_footprint(torch.from_numpy(rois), h, w) == h * w).all()

    want = jax.grad(lambda f: jnp.sum(jroi_align(f, jnp.asarray(rois)) * ct))(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    (proi.roi_align(f, torch.from_numpy(rois)) * torch.from_numpy(ct)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())

    dense = dense_backward(ct, rois, h, w)
    got = proi.roi_align_backward_reference(torch.from_numpy(ct)[None],
                                            torch.from_numpy(rois)[None], h, w)[0]
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=2e-6 * np.abs(dense).max())


def footprint_by_samples(rois, h, w, pooled=14, scale=np.float32(1.0 / 16.0)):
    """Per RoI: rows x columns between some bin's first and last tap, every
    sample's coordinate worked out one by one in float32."""
    f32 = np.float32
    out = []
    for x1, y1, x2, y2 in rois:
        count = 1
        for lo, hi, dim in ((y1, y2, h), (x1, x2, w)):
            start = f32(lo) * scale
            bin_size = f32(max(f32(f32(hi) * scale - start), f32(1.0)) / f32(pooled))
            n = int(min(max(np.ceil(bin_size), 1), 8))
            hit = np.zeros(dim, bool)
            for p in range(pooled):
                taps = []
                for s in range(n):
                    coord = f32(start + f32(f32(p) + f32(f32(s + 0.5) / f32(n))) * bin_size)
                    low = int(np.floor(min(max(coord, f32(0)), f32(dim - 1))))
                    taps += [low, min(low + 1, dim - 1)]
                hit[min(taps):max(taps) + 1] = True
            count *= int(hit.sum())
        out.append(count)
    return np.array(out)


@pytest.mark.parametrize("kind", ["adversarial"] + STRESS)
def test_roi_footprint_matches_taps(kind):
    rng = np.random.default_rng(5)
    h, w = 38, 50
    rois = adversarial_rois(rng, 40, h, w) if kind == "adversarial" else \
        stress_rois(kind, rng, h, w)
    got = chip_smoke.roi_footprint(torch.from_numpy(rois), h, w)
    np.testing.assert_array_equal(got.numpy(), footprint_by_samples(rois, h, w))
    # every cell with a non-zero weight is in it
    a, b = proi._matrices(torch.from_numpy(rois), 14, h, w, 1.0 / 16.0)
    nonzero = (a != 0).any(1).sum(-1) * (b != 0).any(1).sum(-1)
    assert (got >= nonzero).all()
    assert chip_smoke.roi_footprint(torch.from_numpy(rois[None]), h, w).shape == (1, len(rois))


def test_roi_align_batched_grad_and_untracked_calls():
    rng = np.random.default_rng(7)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 6, 9, 8)).astype(np.float32))
    rois = torch.from_numpy(np.stack([adversarial_rois(rng, 10, 6, 9) for _ in range(2)]))
    ct = torch.from_numpy(rng.normal(0, 1, (2, 10, 14, 14, 8)).astype(np.float32))
    f = feats.clone().requires_grad_(True)
    (proi.roi_align_batched(f, rois) * ct).sum().backward()
    for i in range(2):  # the batched gradient is the per-image one
        fi = feats[i].clone().requires_grad_(True)
        (proi.roi_align(fi, rois[i]) * ct[i]).sum().backward()
        np.testing.assert_allclose(f.grad[i].numpy(), fi.grad.numpy(), rtol=1e-6, atol=1e-6)
    # no graph without grad, under no_grad, and under inference_mode
    assert proi.roi_align_batched(feats, rois).grad_fn is None
    with torch.no_grad():
        assert proi.roi_align_batched(f, rois).grad_fn is None
    with torch.inference_mode():
        assert proi.roi_align_batched(feats, rois).grad_fn is None


def jax_stem_params(w, scale, bias):
    return {"w": jnp.asarray(np.transpose(w, (2, 3, 1, 0))), "scale": jnp.asarray(scale),
            "bias": jnp.asarray(bias)}


@pytest.mark.parametrize("hw", [(32, 48), (33, 47), (34, 45), (29, 64)])
def test_stem_grad_matches_jax(hw):
    rng = np.random.default_rng(hw[0] + hw[1])
    h, w = hw
    x = rng.normal(0, 60, (2, h, w, 3)).astype(np.float32)
    wt = (rng.normal(0, 1, (64, 3, 7, 7)) * (2.0 / 147) ** 0.5 / 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.normal(0, 0.5, 64).astype(np.float32)
    ho, wo = (((h - 1) // 2) // 2 + 1, ((w - 1) // 2) // 2 + 1)
    ct = rng.normal(0, 1, (2, ho, wo, 64)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jresnet.stem(jnp.asarray(x), p) * ct)

    gj = jax.grad(jloss)(jax_stem_params(wt, scale, bias))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (wt, scale, bias)]
    out = stem_fused(torch.from_numpy(x), *leaves)
    assert out.shape == ct.shape and out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    pairs = ((leaves[0].grad.numpy(), np.transpose(np.asarray(gj["w"]), (3, 2, 0, 1))),
             (leaves[1].grad.numpy(), np.asarray(gj["scale"])),
             (leaves[2].grad.numpy(), np.asarray(gj["bias"])))
    for got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    with torch.inference_mode():
        assert stem_fused(torch.from_numpy(x), *leaves).grad_fn is None


def test_gradcheck_float64():
    rng = np.random.default_rng(11)
    h, w = 5, 7
    feats = torch.from_numpy(rng.normal(0, 1, (1, h, w, 4))).requires_grad_(True)
    rois = torch.from_numpy(adversarial_rois(rng, 9, h, w)[None])
    assert torch.autograd.gradcheck(
        lambda f: proi.RoIAlignFunction.apply(f, rois, 3, 1.0 / 16.0), (feats,))

    x = torch.from_numpy(rng.normal(0, 1, (1, 9, 11, 3)))
    wt = torch.from_numpy(rng.normal(0, 0.2, (64, 3, 7, 7))).requires_grad_(True)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 64)).requires_grad_(True)
    bias = torch.from_numpy(rng.normal(0, 0.5, 64)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, s, b: StemFunction.apply(x, a, s, b),
                                    (wt, scale, bias))
