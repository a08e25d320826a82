"""Port's preprocessing (a copy of the JAX package's size arithmetic, and the
torch ``normalize_canvas``) vs the JAX package. Integer sizes and uint8
pixels make every comparison exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.data import transforms as jt
from online_detection_tpu_torch.data import transforms

torch.set_num_threads(2)


@pytest.mark.parametrize("w,h,min_size,max_size",
                         [(640, 480, 600, 1333), (480, 640, 600, 1333), (600, 400, 600, 1000),
                          (2000, 300, 600, 1333), (800, 600, 600, 1333), (333, 1000, 480, 800)])
def test_size_arithmetic_matches_jax(w, h, min_size, max_size):
    assert transforms.resize_scale(w, h, min_size, max_size) == \
        jt.resize_scale(w, h, min_size, max_size)
    assert transforms.scaled_size(w, h, min_size, max_size) == \
        jt.scaled_size(w, h, min_size, max_size)
    assert transforms.canvas_size(w, h, min_size, max_size) == \
        jt.canvas_size(w, h, min_size, max_size)
    boxes = np.array([[1.5, 2.0, 30.0, 44.25]], np.float32)
    s = transforms.resize_scale(w, h, min_size, max_size)
    np.testing.assert_array_equal(transforms.scale_boxes(boxes, s), jt.scale_boxes(boxes, s))


def test_normalize_canvas_matches_jax(rng):
    canvas = rng.integers(0, 256, size=(2, 8, 12, 3), dtype=np.uint8)
    got = transforms.normalize_canvas(torch.from_numpy(canvas))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt.normalize_canvas(jnp.asarray(canvas))))
    already = torch.randn(2, 3, 3)
    assert transforms.normalize_canvas(already) is already


@pytest.mark.parametrize("hw,canvas", [((96, 128), (96, 128)), ((120, 170), (96, 160))])
def test_preprocess_image_u8_matches_jax(rng, hw, canvas):
    """No resize (sizes equal, exact), and a PIL resize (the same call on both
    sides, exact) padded into a smaller canvas."""
    rgb = rng.integers(0, 256, size=hw + (3,), dtype=np.uint8)
    got = transforms.preprocess_image_u8(rgb, canvas, 96, 400)
    want = jt.preprocess_image_u8(rgb, canvas, 96, 400)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] and got[0].dtype == np.uint8
