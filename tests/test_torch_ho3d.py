"""The HO-3D -> iCWT converter (``data/ho3d_to_icwt.py``) of the port beside
the JAX package's, on the synthetic HO-3D trees of
``tests/test_demo_tools.py`` (one sequence with a 120x160 ``seg`` render
that is resized to 640x480, and five sequences of 480x640 renders split
into the reference's curated image sets): ``convert``, ``write_imagesets``,
``write_reference_imagesets`` and ``main`` write trees that are equal file
by file, byte for byte; ``_resize_bilinear_cv2`` is bit-equal on a grid of
shapes and scales; the port's dataset reader reads what its converter
wrote."""

import filecmp
import os

import numpy as np
import pytest
import torch

from online_detection_tpu.data import ho3d_to_icwt as j_ho3d
from online_detection_tpu_torch.data import ho3d_to_icwt as p_ho3d
from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset

torch.set_num_threads(2)


def _one_sequence(root, rng):
    from PIL import Image

    src = root / "HO3D" / "train" / "MC1"
    (src / "rgb").mkdir(parents=True)
    (src / "seg").mkdir(parents=True)
    for i in range(2):
        seg = np.zeros((120, 160, 3), np.uint8)
        seg[30 + i:60, 40:90 - i, 2] = 255  # the blue channel marks the object
        seg[70:75, 100:103, 2] = 99 + 2 * i  # around the threshold after the resize
        Image.fromarray(seg).save(src / "seg" / f"{i:04d}.png")
        Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)).save(
            src / "rgb" / f"{i:04d}.png")
    # a frame with no object: written, but not listed as converted
    Image.fromarray(np.zeros((120, 160, 3), np.uint8)).save(src / "seg" / "0002.png")
    # a sequence of no known class is skipped
    (root / "HO3D" / "train" / "XX9" / "seg").mkdir(parents=True)
    return str(root / "HO3D" / "train")


def _five_sequences(root):
    from PIL import Image

    seqs = {"MC1": 8, "MC5": 11, "MC6": 7, "ShSu14": 6, "SM4": 6}
    for seq, n in seqs.items():
        src = root / "HO3D" / "train" / seq
        (src / "rgb").mkdir(parents=True)
        (src / "seg").mkdir(parents=True)
        seg = np.zeros((480, 640, 3), np.uint8)
        seg[30:60, 40:90, 2] = 255
        for i in range(n):
            Image.fromarray(seg).save(src / "seg" / f"{i:04d}.png")
    return str(root / "HO3D" / "train")


def _tree(path):
    return sorted(os.path.relpath(os.path.join(d, f), path)
                  for d, _, files in os.walk(path) for f in files)


def _assert_same_tree(got, want):
    files = _tree(want)
    assert _tree(got) == files and files
    _, mismatch, errors = filecmp.cmpfiles(want, got, files, shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("layout", ["one_sequence", "five_sequences"])
def test_convert_and_imagesets_write_the_same_tree(tmp_path, layout):
    rng = np.random.default_rng(0)
    src = (_one_sequence(tmp_path, rng) if layout == "one_sequence"
           else _five_sequences(tmp_path))
    outs = {}
    for name, mod in (("jax", j_ho3d), ("port", p_ho3d)):
        out = str(tmp_path / name / "HO3D_V2_iCWT_format")
        ids = mod.convert(src, out)
        paths = [mod.write_imagesets(out, ids)] + [mod.write_imagesets(out, ids, stride=s)
                                                   for s in (2, 3)]
        refs = mod.write_reference_imagesets(out, ids)
        outs[name] = (out, ids, [os.path.relpath(p, out) for p in paths],
                      [(os.path.relpath(p, out), n) for p, n in refs])
    (jout, jids, jpaths, jrefs), (pout, pids, ppaths, prefs) = outs["jax"], outs["port"]
    assert pids == jids and ppaths == jpaths and prefs == jrefs
    _assert_same_tree(pout, jout)
    if layout == "one_sequence":
        assert pids == ["MC1/0000", "MC1/0001"]
        assert "train/Masks/MC1/0002.png" in _tree(pout)
    else:
        assert len(pids) == 38 and dict(prefs)["train/ImageSets/imageset_test_1_out_of_5.txt"] == 2


def test_main_writes_the_same_tree(tmp_path, capsys):
    src = _five_sequences(tmp_path)
    for name, mod in (("jax", j_ho3d), ("port", p_ho3d)):
        mod.main(["--ho3d_root", os.path.dirname(src), "--out", str(tmp_path / name),
                  "--imageset_strides", "2", "4"])
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    def strip(lines, name):
        return [ln.replace(str(tmp_path / name), "OUT") for ln in lines]

    assert strip(out[half:], "port") == strip(out[:half], "jax")
    assert out[-1].startswith("converted 38 annotated frames")
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_port_dataset_reads_the_converted_tree(tmp_path):
    """As ``tests/test_demo_tools.py::test_ho3d_converter`` reads the JAX
    package's output: the HO-3D class table, the box of the mask's extents
    in the 640x480 frame, and a binary mask."""
    src = _one_sequence(tmp_path, np.random.default_rng(0))
    out = str(tmp_path / "HO3D_V2_iCWT_format")
    ids = p_ho3d.convert(src, out)
    p_ho3d.write_imagesets(out, ids)
    ds = ICubWorldDataset(os.path.join(out, "train"), "", "imageset_train")
    anno = ds.get_annotation(0)
    assert ds.classes[anno.labels[0]] == "003_cracker_box"
    assert anno.boxes[0][0] >= 150 and anno.boxes[0][2] <= 370
    masks = ds.load_masks(0, anno)
    assert masks.shape == (1, 480, 640) and masks.max() == 1.0


SHAPES = [((4, 4), (4, 4)), ((4, 4), (2, 2)), ((4, 4), (8, 8)), ((120, 160), (640, 480)),
          ((480, 640), (640, 480)), ((37, 53), (19, 71)), ((7, 5), (640, 480)),
          ((481, 641), (640, 480))]


@pytest.mark.parametrize("src_hw, out_wh", SHAPES)
def test_resize_bilinear_cv2_bit_equal(src_hw, out_wh):
    rng = np.random.default_rng(src_hw[0] * 7 + out_wh[0])
    img = rng.integers(0, 256, src_hw + (3,), dtype=np.uint8)
    want = j_ho3d._resize_bilinear_cv2(img, out_wh)
    got = p_ho3d._resize_bilinear_cv2(img, out_wh)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (out_wh[1], out_wh[0], 3)
    np.testing.assert_array_equal(got, want)
    if src_hw == (out_wh[1], out_wh[0]):
        assert got is img  # identity at the same size


def test_sequence_table_and_splits_are_the_jax_package_s():
    assert p_ho3d.SEQUENCE_TO_CLASS == j_ho3d.SEQUENCE_TO_CLASS
    assert p_ho3d._REFERENCE_SPLITS == j_ho3d._REFERENCE_SPLITS
