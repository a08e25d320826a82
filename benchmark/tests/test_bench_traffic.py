"""The traffic generator: the same seed gives the same inputs."""

import numpy as np

from benchmark.traffic import SyntheticSet


def _set(seed):
    return SyntheticSet(10, (96, 128), 4, seed, (24, 48), "cpu")


def test_same_seed_same_inputs():
    a, b = _set(2**31 + 7), _set(2**31 + 7)
    assert np.array_equal(a.images, b.images)
    assert np.array_equal(a.masks, b.masks)
    assert all(np.array_equal(x, y) for x, y in zip(a.boxes, b.boxes))


def test_other_seed_other_inputs():
    assert not np.array_equal(_set(1).images, _set(2).images)


def test_objects_inside_their_boxes_classes_in_turn():
    s = _set(5)
    assert [int(s.get_annotation(i).labels[0]) for i in range(10)] == [i % 4 + 1 for i in range(10)]
    for i in range(len(s)):
        x1, y1, x2, y2 = s.get_annotation(i).boxes[0]
        assert 24 <= x2 - x1 < 48 and 24 <= y2 - y1 < 48
        assert 0 <= x1 and x2 <= 128 and 0 <= y1 and y2 <= 96
        ys, xs = np.nonzero(s.masks[i])
        assert xs.min() >= x1 and xs.max() <= x2 and ys.min() >= y1 and ys.max() <= y2
        assert s.load_masks(i).shape == (1, 96, 128)
        assert s.load_image(i).dtype == np.uint8
