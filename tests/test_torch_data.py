"""Port's host-side data helpers (copies of the JAX package's numpy code:
``CanvasLoader``'s synchronous path, ``harvest_annotation``,
``project_masks_for_image``, ``anchor_visibility``) and the box encoder vs
the JAX package. The copies must agree exactly; the float32 encoder within
1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.data import datasets as jdatasets
from online_detection_tpu.data import loader as jloader
from online_detection_tpu.data import mask_project as jmask
from online_detection_tpu.models import anchors as janchors
from online_detection_tpu.utils import boxes as jboxes
from online_detection_tpu_torch.data import datasets, loader, mask_project
from online_detection_tpu_torch.models import anchors
from online_detection_tpu_torch.utils import boxes

torch.set_num_threads(2)


class _Images:
    def __init__(self, rng):
        self.images = [rng.integers(0, 256, size=(80, 112, 3), dtype=np.uint8),
                       rng.integers(0, 256, size=(100, 150, 3), dtype=np.uint8)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def get_annotation(self, i):
        return ("generic", i)


class _WithHarvest(_Images):
    def harvest_annotation(self, i):
        return ("harvest", i)


def test_canvas_loader_and_annotation_dispatch_match_jax(rng):
    ds = _Images(rng)
    with loader.CanvasLoader(ds, (96, 160), 80, 400) as ld, \
            jloader.CanvasLoader(ds, (96, 160), 80, 400) as jld:
        for i in range(len(ds)):
            got, want = ld.get(i), jld.get(i)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    for d in (ds, _WithHarvest(rng)):
        assert datasets.harvest_annotation(d, 1) == jdatasets.harvest_annotation(d, 1)


def test_project_masks_for_image_matches_jax(rng):
    masks = (rng.uniform(size=(3, 60, 80)) < 0.5).astype(np.float32)
    boxes_canvas = np.array([[4, 6, 50, 40], [0, 0, 119, 89], [30, 20, 31, 21]], np.float32)
    got = mask_project.project_masks_for_image(masks, boxes_canvas, 1.5, 5)
    want = jmask.project_masks_for_image(masks, boxes_canvas, 1.5, 5)
    assert got.shape == (5, 14, 14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(1, 7), (2, 2), (37, 53), (600, 800)])
def test_mask_rows_equal_the_blas_product(rng, hw):
    """The projection's first product, taken from the two rows each output
    row reads, is the BLAS product bit for bit, boxes past the mask's edges
    and on whole pixels included."""
    h, w = hw
    mask = (rng.uniform(size=(h, w)) < 0.4).astype(np.float32)
    for y1, y2 in [(-5.0, h + 5.0), (0.0, h - 1.0), (h - 1.0, h - 1.0),
                   tuple(sorted(rng.uniform(-3, h + 3, 2)))]:
        wy = mask_project._axis_weights(y1, max(y2 - y1 + 1.0, 1.0), h, 14)
        np.testing.assert_array_equal(mask_project._rows(wy, mask), wy @ mask)


@pytest.mark.parametrize("straddle", [0.0, 10.0, -1.0])
def test_anchor_visibility_matches_jax(straddle):
    a = anchors.grid_anchors(4, 6)
    np.testing.assert_array_equal(anchors.anchor_visibility(a, (90, 60), straddle),
                                  janchors.anchor_visibility(a, (90, 60), straddle))


def test_encode_and_masked_iou_match_jax(rng):
    gt = rng.uniform(0, 80, size=(7, 4)).astype(np.float32)
    gt[:, 2:] += gt[:, :2]
    props = gt + rng.normal(size=(7, 4)).astype(np.float32) * 5
    props[3] = [10, 10, 5, 5]  # inverted: the 1e-6 width floor
    got = boxes.encode_boxes(torch.from_numpy(gt), torch.from_numpy(props)).numpy()
    want = np.asarray(jboxes.encode_boxes(jnp.asarray(gt), jnp.asarray(props)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    va, vb = rng.uniform(size=7) < 0.6, rng.uniform(size=7) < 0.6
    got = boxes.box_iou_masked(*map(torch.from_numpy, (gt, va, props, vb))).numpy()
    want = np.asarray(jboxes.box_iou_masked(*map(jnp.asarray, (gt, va, props, vb))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
