"""Port's box geometry, anchors, NMS (ties included) and the RPN proposal
stage vs the JAX package. Integer-valued inputs keep every comparison exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.models import anchors as janchors
import importlib

# the JAX ops package re-exports a function named `nms`, so fetch the module
jnms = importlib.import_module("online_detection_tpu.ops.nms")
from online_detection_tpu.utils import boxes as jboxes
from online_detection_tpu_torch.models import anchors
from online_detection_tpu_torch.ops import nms
from online_detection_tpu_torch.utils import boxes

torch.set_num_threads(2)


def _boxes(rng, n, hi=100):
    xy = rng.integers(0, hi, size=(n, 2)).astype(np.float32)
    wh = rng.integers(1, 40, size=(n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1)


def test_anchors_equal_jax():
    np.testing.assert_array_equal(anchors.base_anchors(), janchors.base_anchors())
    np.testing.assert_array_equal(anchors.grid_anchors(5, 7), janchors.grid_anchors(5, 7))


def test_box_ops_match_jax(rng):
    a, b = _boxes(rng, 9), _boxes(rng, 6)
    np.testing.assert_allclose(boxes.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jboxes.box_iou(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    deltas = rng.normal(size=(9, 12)).astype(np.float32) * 2
    size = np.array([80.0, 60.0], np.float32)
    for clip in (True, False):
        want = jboxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(a), clip_exp=clip)
        got = boxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(a), clip_exp=clip)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            boxes.clip_boxes_one_sided(got, torch.from_numpy(size)).numpy(),
            np.asarray(jboxes.clip_boxes_one_sided(want, size)), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(
            boxes.clip_boxes_to_image(got, torch.from_numpy(size)).numpy(),
            np.asarray(jboxes.clip_boxes_to_image(want, size)), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        boxes.remove_small_boxes_mask(torch.from_numpy(a), 20.0).numpy(),
        np.asarray(jboxes.remove_small_boxes_mask(jnp.asarray(a), 20.0)))


@pytest.mark.parametrize("thr", [0.3, 0.7])
def test_nms_with_tied_scores_matches_jax(rng, thr):
    n = 60
    bx = _boxes(rng, n, hi=60)
    scores = rng.integers(0, 6, size=n).astype(np.float32)  # many ties
    valid = rng.uniform(size=n) > 0.15
    want = jnms.nms(jnp.asarray(bx), jnp.asarray(scores), jnp.asarray(valid), thr, 40)
    got = nms.nms(torch.from_numpy(bx), torch.from_numpy(scores), torch.from_numpy(valid),
                  thr, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_class_nms_matches_jax(rng):
    c_, n = 4, 30
    bx = np.stack([_boxes(rng, n, hi=50) for _ in range(c_)])
    scores = rng.integers(0, 4, size=(c_, n)).astype(np.float32)
    valid = rng.uniform(size=(c_, n)) > 0.2
    want = jnms.batched_class_nms(jnp.asarray(bx), jnp.asarray(scores), jnp.asarray(valid),
                                  0.3, 50)  # max_out > n: padded rows
    got = nms.nms(torch.from_numpy(bx), torch.from_numpy(scores), torch.from_numpy(valid),
                  0.3, 50)  # leading class axis
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _nan_cases():
    """(boxes, scores, valid) with NaN scores: a NaN sorts after every number
    and after the invalid rows in the JAX package."""
    three = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], np.float32)
    rng = np.random.default_rng(11)
    bx = _boxes(rng, 24, hi=40)
    sc = rng.integers(0, 5, size=24).astype(np.float32)
    sc[[3, 9, 17]] = np.nan
    valid = rng.uniform(size=24) > 0.25
    cls_bx = np.stack([_boxes(rng, 20, hi=40) for _ in range(3)])
    cls_sc = rng.integers(0, 4, size=(3, 20)).astype(np.float32)
    cls_sc[1] = np.nan  # a class whose fit failed: every score NaN
    cls_sc[2, [0, 5]] = np.nan
    return {
        "three_boxes": (three, np.array([0.9, np.nan, 0.3], np.float32), np.ones(3, bool)),
        "nan_disjoint": (three, np.array([0.2, 0.9, np.nan], np.float32), np.ones(3, bool)),
        "nan_and_invalid": (bx, sc, valid),
        "batched_classes": (cls_bx, cls_sc, rng.uniform(size=(3, 20)) > 0.2),
    }


@pytest.mark.parametrize("case", list(_nan_cases()))
def test_nms_with_nan_scores_matches_jax(case):
    bx, sc, valid = _nan_cases()[case]
    args = (torch.from_numpy(bx), torch.from_numpy(sc), torch.from_numpy(valid))
    jargs = (jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(valid))
    if bx.ndim == 3:
        want_mask = jax.vmap(jnms.nms_mask, in_axes=(0, 0, 0, None))(*jargs, 0.3)
        want = jnms.batched_class_nms(*jargs, 0.3, 8)
    else:
        want_mask = jnms.nms_mask(*jargs, 0.3)
        want = jnms.nms(*jargs, 0.3, 8)
    np.testing.assert_array_equal(nms.nms_mask(*args, 0.3).numpy(), np.asarray(want_mask))
    for g, w in zip(nms.nms(*args, 0.3, 8), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_top_k_breaks_ties_by_lower_index():
    vals, idx = nms.top_k(torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]]), 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 2.0, 3.0]), 4)
    assert idx[0].tolist() == np.asarray(ji).tolist()


def test_propose_matches_jax(rng):
    from online_detection_tpu.models.rpn import propose as j_propose
    from online_detection_tpu_torch.models.rpn import propose

    h, w = 6, 8
    anc = anchors.grid_anchors(h, w)
    n = anc.shape[0]
    sizes = np.array([[w * 16, h * 16], [w * 16 - 20, h * 16 - 10]], np.float32)
    scores = (rng.integers(0, 50, size=(2, n)) / 8).astype(np.float32)  # ties
    deltas = (rng.normal(size=(2, n, 4)) * 0.2).astype(np.float32)
    got = propose(torch.from_numpy(scores), torch.from_numpy(deltas), torch.from_numpy(anc),
                  torch.from_numpy(sizes), pre_nms_top_n=300, post_nms_top_n=60)
    for i in range(2):
        want = j_propose(jnp.asarray(scores[i]), jnp.asarray(deltas[i]), jnp.asarray(anc),
                         jnp.asarray(sizes[i]), pre_nms_top_n=300, post_nms_top_n=60)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]), atol=1e-3)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]), rtol=1e-6)
