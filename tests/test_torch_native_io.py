"""The port's native IO binding (``online_detection_tpu_torch/utils/
native_io.py``) and the prefetching ``CanvasLoader`` (``data/loader.py``).

The binding and the JAX package's call the same library
(``native/libodtpu_io.so``), so each function, and the prefetcher, must give
the JAX binding's output byte for byte; those cases skip only where the JAX
package's own tests do (the library does not load). Where the library cannot
load, the port raises the loader's ``OSError`` (a missing library is
simulated by pointing the binding elsewhere).

``CanvasLoader(prefetch="threads")`` runs the synchronous PIL path on a
thread pool, so its canvases, scales and sizes equal ``prefetch=None``'s
byte for byte, on a JPEG and a PNG tree written with PIL, in order, out of
order and repeated, and the loader closes mid-stream. ``"native"`` equals
the JAX ``CanvasLoader``'s native path and raises on a file it cannot read;
a bad mode raises."""

import os

import numpy as np
import pytest
import torch

from online_detection_tpu.data.loader import CanvasLoader as JCanvasLoader
from online_detection_tpu.utils import native_io as jnio
from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset
from online_detection_tpu_torch.data.loader import CanvasLoader
from online_detection_tpu_torch.utils import native_io as nio
from tests.fixtures import make_synthetic_icwt

torch.set_num_threads(2)

needs_library = pytest.mark.skipif(not jnio.available(), reason="native library not built")
HW, MIN, MAX = (128, 192), 128, 320


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nio") / "ycbv_synth")
    make_synthetic_icwt(root, n_train=4, n_test=1)
    return root


def _jpg(root, i):
    return os.path.join(root, "Images", f"train_{i:04d}.jpg")


def _assert_same_canvas(got, want):
    assert got[0].dtype == want[0].dtype == np.uint8
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and tuple(got[2]) == tuple(want[2])


@needs_library
def test_decode_matches_jax_binding(synth):
    for path in (_jpg(synth, 0), os.path.join(synth, "Masks", "train_0000.png")):
        got, want = nio.decode_image(path), jnio.decode_image(path)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@needs_library
def test_prepare_canvas_matches_jax_binding(synth):
    for i in range(4):
        _assert_same_canvas(nio.prepare_canvas(_jpg(synth, i), HW, MIN, MAX),
                            jnio.prepare_canvas(_jpg(synth, i), HW, MIN, MAX))


@needs_library
def test_parse_voc_xml_matches_jax_binding(synth):
    ds = ICubWorldDataset(synth, "Main", "train")
    path = os.path.join(synth, "Annotations", ds.get_annotation(0).image_id + ".xml")
    got, want = nio.parse_voc_xml(path), jnio.parse_voc_xml(path)
    assert got[:2] == want[:2] and got[3] == want[3]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[4], want[4])
    assert got[2].dtype == np.float32 and got[4].dtype == bool


@needs_library
def test_prefetcher_matches_jax_binding(synth):
    paths = [_jpg(synth, i) for i in range(4)]
    pf = nio.Prefetcher(paths, HW, MIN, MAX, n_threads=2, window=2)
    jpf = jnio.Prefetcher(paths, HW, MIN, MAX, n_threads=2, window=2)
    for idx in (2, 0, 3, 1):  # out of order: the ready and space conditions
        _assert_same_canvas(pf.get(idx), jpf.get(idx))
    with pytest.raises(ValueError, match="read already"):  # the library freed it
        pf.get(2)
    with pytest.raises(IndexError):
        pf.get(4)
    pf.close()
    jpf.close()
    with pytest.raises(ValueError, match="closed"):
        pf.get(0)


@needs_library
def test_binding_raises_on_an_unreadable_file(tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    for fn in (lambda: nio.decode_image(str(bad)),
               lambda: nio.prepare_canvas(str(bad), HW, MIN, MAX),
               lambda: nio.parse_voc_xml(str(tmp_path / "missing.xml"))):
        with pytest.raises(OSError, match="native IO"):
            fn()
    assert jnio.decode_image(str(bad)) is None  # where the JAX binding returns None


def test_missing_library_raises_the_loaders_error(monkeypatch, tmp_path):
    missing = str(tmp_path / "libodtpu_io.so")
    monkeypatch.setattr(nio, "LIB_PATH", missing)
    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_error", None)
    assert not nio.available()
    with pytest.raises(OSError, match="cannot be loaded") as err:
        nio.decode_image("x.jpg")
    assert missing in str(err.value)
    with pytest.raises(OSError, match="cannot be loaded"):
        CanvasLoader(_FileSet([str(tmp_path / "a.jpg")]), HW, MIN, MAX, prefetch="native")


class _FileSet:
    """Images read from files with PIL, as the datasets read them."""

    def __init__(self, paths):
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def image_path(self, i):
        return self.paths[i]

    def load_image(self, i):
        from PIL import Image

        return np.asarray(Image.open(self.paths[i]).convert("RGB"))


@pytest.fixture(scope="module", params=["JPEG", "PNG"])
def file_set(tmp_path_factory, request):
    """8 noise images with a rectangle each, in sizes that need a resize
    (both orientations) and one that needs none, written with PIL."""
    from PIL import Image

    rng = np.random.default_rng(3)
    tmp = tmp_path_factory.mktemp(request.param.lower())
    paths = []
    for i, (h, w) in enumerate([(120, 160), (160, 120), (128, 192), (90, 200)] * 2):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        img[h // 4: h // 2, w // 3: w // 2] = [200, 30 * i, 90]
        path = str(tmp / f"im{i}.{'jpg' if request.param == 'JPEG' else 'png'}")
        Image.fromarray(img).save(path, request.param, **(
            {"quality": 95} if request.param == "JPEG" else {}))
        paths.append(path)
    return _FileSet(paths)


@pytest.mark.parametrize("order", [list(range(8)), [3, 0, 7, 1, 2, 2, 6, 5, 4]],
                         ids=["in_order", "out_of_order"])
def test_threads_prefetch_is_byte_equal_to_sync(file_set, order):
    with CanvasLoader(file_set, HW, MIN, MAX) as sync, \
            CanvasLoader(file_set, HW, MIN, MAX, prefetch="threads", workers=3,
                         window=2) as pre:
        assert not pre.native and pre.prefetch == "threads"
        for i in order:
            _assert_same_canvas(pre.get(i), sync.get(i))


def test_threads_prefetch_closes_mid_stream(file_set):
    loader = CanvasLoader(file_set, HW, MIN, MAX, prefetch="threads", workers=2, window=4)
    _assert_same_canvas(loader.get(0), CanvasLoader(file_set, HW, MIN, MAX).get(0))
    assert len(loader._pending) == 4  # items 1..4 submitted ahead
    loader.close()
    assert loader._pool is None and not loader._pending
    loader.close()  # a second close is a no-op


def test_unknown_prefetch_mode_raises(file_set):
    with pytest.raises(ValueError, match="prefetch="):
        CanvasLoader(file_set, HW, MIN, MAX, prefetch="processes")


@needs_library
def test_native_prefetch_matches_the_jax_loader(synth):
    ds = ICubWorldDataset(synth, "Main", "train")
    from online_detection_tpu.data.datasets.icubworld import ICubWorldDataset as JDataset

    jds = JDataset(synth, "Main", "train")
    with CanvasLoader(ds, HW, MIN, MAX, prefetch="native", workers=2, window=2) as loader, \
            JCanvasLoader(jds, HW, MIN, MAX, n_threads=2, window=2) as jloader:
        assert loader.native and jloader.native
        for i in (1, 0, 3, 2):
            _assert_same_canvas(loader.get(i), jloader.get(i))


@needs_library
def test_native_prefetch_raises_on_an_unreadable_file(file_set, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 truncated")
    ds = _FileSet([file_set.paths[0], str(bad)])
    with CanvasLoader(ds, HW, MIN, MAX, prefetch="native", workers=2) as loader:
        loader.get(0)
        with pytest.raises(OSError, match="prefetching item 1"):
            loader.get(1)
