"""The feature caches of ``utils/checkpoint.py`` (``save_features``,
``load_features``, ``rebatch_negatives_shuffled``) through both packages on
the CPU: each package reads the other's caches, both read the reference's
extensionless ``torch.save`` caches alike, and the load-time re-batching and
subsampling draw the same rows from the same NumPy generator.

Tolerance: none. The caches are NumPy arrays and both packages run the same
NumPy code on them, so every comparison is bit for bit."""

import os

import numpy as np
import pytest
import torch

from online_detection_tpu.utils import checkpoint as jck
from online_detection_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(2)

A, C, I, B = 4, 3, 3, 6
DIMS = {"rpn": 5, "det": 7, "mask": 4}


def _head(rng, n_cls, dim, n_iter, batch, p_cap=8, coxy=True):
    """A ``finalize``-shaped head with ragged valid rows, a class without
    positives and an empty negative batch."""
    pos_valid = np.arange(p_cap) < rng.integers(0, p_cap + 1, size=(n_cls, 1))
    pos_valid[1] = False
    neg_valid = np.arange(batch) < rng.integers(0, batch + 1, size=(n_cls, n_iter, 1))
    neg_valid[0, n_iter - 1] = False
    head = {"pos": rng.normal(size=(n_cls, p_cap, dim)).astype(np.float32),
            "pos_valid": pos_valid,
            "neg": rng.normal(size=(n_cls, n_iter, batch, dim)).astype(np.float32),
            "neg_valid": neg_valid}
    if coxy:
        n = int(rng.integers(5, 12))
        head["coxy"] = {"X": rng.normal(size=(n, dim)).astype(np.float32),
                        "Y": rng.normal(size=(n, 4)).astype(np.float32),
                        "C": rng.integers(1, n_cls + 1, size=n).astype(np.float32)}
    return head


def _harvest(seed=0):
    rng = np.random.default_rng(seed)
    return {"rpn": _head(rng, A, DIMS["rpn"], I, B),
            "det": _head(rng, C, DIMS["det"], I, B),
            "mask": _head(rng, C, DIMS["mask"], 2, 10, coxy=False),
            "average_recall": 0.5}


def _assert_same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


_WRITERS = {"port": ck.save_features, "jax": jck.save_features}
_LOADS = {
    "plain": dict(),
    "shuffled": dict(det_shuffle_negatives=True, rpn_shuffle_negatives=True, iterations=4,
                     batch_size=5),
    "rpn_shuffled": dict(rpn_shuffle_negatives=True, iterations=2, batch_size=9),
    "segm_subsampled": dict(sampling_ratio_segmentation=0.3),
}


def _load_both(cache, kw, seed=4):
    mine = ck.load_features(cache, rng=np.random.default_rng(seed), **kw)
    theirs = jck.load_features(cache, rng=np.random.default_rng(seed), **kw)
    return mine, theirs


@pytest.mark.parametrize("load", sorted(_LOADS))
@pytest.mark.parametrize("writer", sorted(_WRITERS))
def test_caches_cross_read_bit_equal(tmp_path, writer, load):
    """Either package writes the cache; both load it into the same arrays,
    and the two writers write the same files with the same arrays."""
    harvest = _harvest()
    _WRITERS[writer](str(tmp_path / "w"), harvest)
    other = "jax" if writer == "port" else "port"
    _WRITERS[other](str(tmp_path / "o"), harvest)
    for sub in ("features_RPN", "features_detector", "features_segmentation"):
        names = sorted(os.listdir(tmp_path / "w" / sub))
        assert names == sorted(os.listdir(tmp_path / "o" / sub))
        for n in names:
            np.testing.assert_array_equal(np.load(tmp_path / "w" / sub / n),
                                          np.load(tmp_path / "o" / sub / n), err_msg=n)
    mine, theirs = _load_both(str(tmp_path / "w"), _LOADS[load])
    _assert_same(mine, theirs)


def test_plain_load_gives_back_the_saved_rows(tmp_path):
    """With the flags off, each class's positives and each negative batch are
    the saved valid rows; the segmentation negatives pool into one batch."""
    harvest = _harvest(1)
    ck.save_features(str(tmp_path), harvest)
    got = ck.load_features(str(tmp_path))
    for head in ("rpn", "det", "mask"):
        saved, back = harvest[head], got[head]
        for c in range(saved["pos"].shape[0]):
            np.testing.assert_array_equal(back["pos"][c][back["pos_valid"][c]],
                                          saved["pos"][c][saved["pos_valid"][c]])
            batches = [saved["neg"][c, b][saved["neg_valid"][c, b]]
                       for b in range(saved["neg"].shape[1])]
            if head == "mask":
                batches = [np.concatenate(batches)]
            for b, rows in enumerate(batches):
                np.testing.assert_array_equal(back["neg"][c, b][back["neg_valid"][c, b]], rows)
        if "coxy" in saved:
            _assert_same(back["coxy"], saved["coxy"])
    assert "coxy" not in got["mask"]


def test_shuffled_load_is_a_permutation_of_the_saved_rows(tmp_path):
    harvest = _harvest(2)
    ck.save_features(str(tmp_path), harvest)
    got = ck.load_features(str(tmp_path), det_shuffle_negatives=True, iterations=I,
                           batch_size=B, rng=np.random.default_rng(0))
    saved, back = harvest["det"], got["det"]
    for c in range(C):
        want = saved["neg"][c][saved["neg_valid"][c]]
        rows = back["neg"][c][back["neg_valid"][c]]
        assert rows.shape == want.shape
        np.testing.assert_array_equal(np.sort(rows, axis=0), np.sort(want, axis=0))


def test_save_features_writes_only_the_heads_asked_for(tmp_path):
    harvest = _harvest(3)
    for save in (ck.save_features, jck.save_features):
        d = tmp_path / save.__module__.split(".")[0]
        save(str(d), harvest, heads={"rpn"})
        assert sorted(os.listdir(d)) == ["features_RPN"]
    mine, theirs = _load_both(str(tmp_path / "online_detection_tpu_torch"), {})
    _assert_same(mine, theirs)
    assert list(mine) == ["rpn"]


def _reference_cache(d, rng):
    """Extensionless ``torch.save`` tensors with the reference's names: two
    positive batches for class 0 (a spill), float64 rows, the COXY split in
    two batches and the labels as a column."""
    os.makedirs(d)

    def put(name, a):
        torch.save(torch.from_numpy(np.asarray(a)), os.path.join(d, name))

    put("positives_cl_0_batch_0", rng.normal(size=(3, 6)).astype(np.float32))
    put("positives_cl_0_batch_1", rng.normal(size=(2, 6)))  # float64: read as f32
    put("positives_cl_1_batch_0", np.zeros((0, 6), np.float32))
    for c in range(2):
        for b in range(3):
            put(f"negatives_cl_{c}_batch_{b}", rng.normal(size=(4 + b, 6)).astype(np.float32))
    for i, n in enumerate((3, 4)):
        put(f"reg_x_batch_{i}", rng.normal(size=(n, 6)).astype(np.float32))
        put(f"reg_c_batch_{i}", rng.integers(1, 3, size=(n, 1)).astype(np.float32))
        put(f"reg_y_batch_{i}", rng.normal(size=(n, 4)).astype(np.float32))


@pytest.mark.parametrize("load", ["plain", "shuffled"])
def test_reference_torch_save_caches_read_alike(tmp_path, load):
    rng = np.random.default_rng(5)
    for sub in ("features_detector", "features_segmentation"):
        _reference_cache(str(tmp_path / sub), rng)
    mine, theirs = _load_both(str(tmp_path), _LOADS[load])
    _assert_same(mine, theirs)
    det = mine["det"]
    assert det["pos"].dtype == np.float32 and det["pos_valid"].sum(1).tolist() == [5, 0]
    assert det["coxy"]["X"].shape == (7, 6) and det["coxy"]["C"].shape == (7,)


@pytest.mark.parametrize("batch_size,num_batches", [(4, 3), (5, None), (None, 2), (3, 8)])
def test_rebatch_negatives_shuffled_same_batches(batch_size, num_batches):
    rng = np.random.default_rng(6)
    batches = [rng.normal(size=(n, 3)).astype(np.float32) for n in (4, 4, 2)]

    def perm_fn(n):
        return np.random.default_rng(9).permutation(n)

    got = ck.rebatch_negatives_shuffled(batches, batch_size, num_batches, perm_fn)
    want = jck.rebatch_negatives_shuffled(batches, batch_size, num_batches, perm_fn)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ratio", [0.3, 0.75, 1.0])
def test_segmentation_subsampling_equal(tmp_path, ratio):
    """The segmentation pools are drawn with replacement at the ratio, from
    the same generator in both packages: the same rows and counts."""
    harvest = _harvest(7)
    ck.save_features(str(tmp_path), harvest)
    mine, theirs = _load_both(str(tmp_path), {"sampling_ratio_segmentation": ratio}, seed=11)
    _assert_same(mine["mask"], theirs["mask"])
    saved = harvest["mask"]
    for c in range(C):
        n_pos = int(saved["pos_valid"][c].sum())
        n_neg = int(saved["neg_valid"][c].sum())
        want_pos = int(n_pos * ratio) if ratio < 1 else n_pos
        assert int(mine["mask"]["pos_valid"][c].sum()) == want_pos
        assert int(mine["mask"]["neg_valid"][c].sum()) == (int(n_neg * ratio) if ratio < 1
                                                           else n_neg)
