"""The port's SGD losses (``online_detection_tpu_torch/engine/losses.py``)
against the JAX package's, on the CPU, with inputs made by numpy from a seed
and the JAX samplers' uniforms injected into the port's: masks and indices
equal, losses within 1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.engine import losses as jl
from online_detection_tpu_torch.engine import losses as pl
from online_detection_tpu_torch.models.anchors import grid_anchors

torch.set_num_threads(2)

RTOL = 1e-6


def jax_uniforms(key, n):
    """The two uniform vectors ``balanced_sample`` draws from ``key``."""
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,))))


def t(a):
    return torch.from_numpy(np.array(a))


def random_boxes(rng, n, hw=(128, 192), min_side=4.0):
    h, w = hw
    x1 = rng.uniform(-20, w - min_side, n)
    y1 = rng.uniform(-20, h - min_side, n)
    x2 = x1 + rng.uniform(min_side, w / 2, n)
    y2 = y1 + rng.uniform(min_side, h / 2, n)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def gt_set(rng, g=6, valid=4):
    boxes = random_boxes(rng, g, min_side=16.0)
    labels = rng.integers(1, 6, g).astype(np.int32)
    return boxes, labels, np.arange(g) < valid


def test_smooth_l1_matches_jax():
    x = np.random.default_rng(0).normal(0, 1, (64, 4)).astype(np.float32)
    for beta in (1.0, 1.0 / 9.0):
        np.testing.assert_allclose(pl.smooth_l1(t(x), beta).numpy(),
                                   np.asarray(jl.smooth_l1(jnp.asarray(x), beta)), rtol=RTOL)


@pytest.mark.parametrize("low_quality", [True, False])
def test_match_boxes_matches_jax_with_ties(low_quality):
    rng = np.random.default_rng(1)
    iou = rng.choice(np.float32([0.0, 0.1, 0.3, 0.5, 0.65, 0.7, 0.9]), (5, 40))
    iou[3] = -1.0  # an invalid GT
    iou[:, 7] = 0.9  # a column tied across GTs
    got = pl.match_boxes(t(iou), 0.7, 0.3, low_quality)
    want = jl.match_boxes(jnp.asarray(iou), 0.7, 0.3, low_quality)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("num,frac", [(16, 0.5), (64, 0.25), (300, 0.5)])
def test_balanced_sample_matches_jax(num, frac):
    rng = np.random.default_rng(num)
    labels = rng.choice([-1, 0, 1], 257, p=[0.2, 0.7, 0.1]).astype(np.int32)
    key = jax.random.key(num)
    want = jl.balanced_sample(key, jnp.asarray(labels), num, frac)
    got = pl.balanced_sample(t(labels), num, frac, uniforms=tuple(map(t, jax_uniforms(key, 257))))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # drawn from a generator instead: the same pool sizes
    pos, neg = pl.balanced_sample(t(labels), num, frac, generator=torch.Generator().manual_seed(0))
    assert int(pos.sum()) == int(want[0].sum()) and int(neg.sum()) == int(want[1].sum())


def test_rpn_loss_matches_jax():
    rng = np.random.default_rng(2)
    anchors = grid_anchors(8, 12)
    n = anchors.shape[0]
    logits = rng.normal(0, 2, n).astype(np.float32)
    deltas = rng.normal(0, 0.3, (n, 4)).astype(np.float32)
    vis = rng.random(n) < 0.8
    gb, _, gv = gt_set(rng)
    key = jax.random.key(3)
    want = jl.rpn_loss(key, *map(jnp.asarray, (logits, deltas, anchors, vis, gb, gv)))
    got = pl.rpn_loss(*map(t, (logits, deltas, anchors, vis, gb, gv)),
                      uniforms=tuple(map(t, jax_uniforms(key, n))))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def roi_inputs(seed):
    rng = np.random.default_rng(seed)
    gb, gl, gv = gt_set(rng)
    props = random_boxes(rng, 60)
    # a few proposals near the GT, so that there are positives
    props[:6] = gb + rng.normal(0, 2, gb.shape).astype(np.float32)
    pv = rng.random(60) < 0.9
    return (np.concatenate([props, gb]), np.concatenate([pv, gv]), gb, gl, gv)


@pytest.mark.parametrize("batch", [8, 32, 128])
def test_sample_rois_matches_jax(batch):
    inputs = roi_inputs(batch)
    key = jax.random.key(batch)
    want = jl.sample_rois(key, *map(jnp.asarray, inputs), batch_per_image=batch)
    got = pl.sample_rois(*map(t, inputs), batch_per_image=batch,
                         uniforms=tuple(map(t, jax_uniforms(key, len(inputs[0])))))
    for name in pl.ROISample._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert int(got.is_pos.sum()) > 0


def test_compact_idx_matches_jax():
    mask = np.random.default_rng(4).random(50) < 0.3
    for n_out in (5, 50, 80):
        got = pl._compact_idx(t(mask), n_out)
        want = jl._compact_idx(jnp.asarray(mask), n_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_box_and_mask_head_losses_match_jax():
    inputs = roi_inputs(5)
    key = jax.random.key(5)
    sample = jl.sample_rois(key, *map(jnp.asarray, inputs), batch_per_image=32)
    psample = pl.ROISample(*(t(np.asarray(f)) for f in sample))
    psample = psample._replace(labels=psample.labels.long(), matched_gt=psample.matched_gt.long())
    rng = np.random.default_rng(6)
    n_cls = 6
    cls_logits = rng.normal(0, 2, (32, n_cls)).astype(np.float32)
    box_deltas = rng.normal(0, 0.5, (32, 4 * n_cls)).astype(np.float32)
    gb = inputs[2]
    want = jl.box_head_loss(jnp.asarray(cls_logits), jnp.asarray(box_deltas), sample,
                            jnp.asarray(gb))
    got = pl.box_head_loss(t(cls_logits), t(box_deltas), psample, t(gb))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)

    mask_logits = rng.normal(0, 3, (32, 14, 14, n_cls)).astype(np.float32)
    gt14 = (rng.random((32, 14, 14)) < 0.4).astype(np.float32)
    want = jl.mask_head_loss(jnp.asarray(mask_logits), sample, jnp.asarray(gt14))
    got = pl.mask_head_loss(t(mask_logits), psample, t(gt14))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
