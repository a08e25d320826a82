"""The port's copies of the datasets, the VOC evaluator and the COCO RLE
codec against the JAX package's modules, on the CPU.

- ``make_synthetic_icwt``: both packages write byte-identical trees from one
  seed.
- ``ICubWorldDataset`` / ``YCBVideoDataset``: equal ids, classes,
  annotations (boxes, labels, difficult; ``harvest_annotation``'s -1 shift),
  images and masks, on that tree (with an extra image holding a difficult
  object) and on a fabricated BOP scene.
- ``voc_eval``: equal results dicts (per-class APs, NaN where a class is
  unseen) and byte-identical ``result.txt`` text on fixed numpy
  predictions with masks and difficult objects, for the 07 and the area
  metric at IoU 0.5 and 0.7; ``paste_mask`` equal on boxes inside, across
  and past the image's edges.
- ``coco_rle``: equal strings both ways, equal decodes and areas.

Every comparison is exact: the modules are numpy copies, so the same inputs
must give the same bits.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from online_detection_tpu.data import datasets as j_datasets
from online_detection_tpu.data.datasets import icubworld as j_icw
from online_detection_tpu.data.datasets import synthetic as j_synth
from online_detection_tpu.data.datasets import ycb_video as j_ycbv
from online_detection_tpu.data.evaluation import coco_rle as j_rle
from online_detection_tpu.data.evaluation import voc_eval as j_voc
from online_detection_tpu_torch.data import datasets as t_datasets
from online_detection_tpu_torch.data.datasets import icubworld as t_icw
from online_detection_tpu_torch.data.datasets import synthetic as t_synth
from online_detection_tpu_torch.data.datasets import ycb_video as t_ycbv
from online_detection_tpu_torch.data.evaluation import coco_rle as t_rle
from online_detection_tpu_torch.data.evaluation import voc_eval as t_voc

torch.set_num_threads(2)


def _tree_files(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """A synthetic tree with one more image, holding two objects, one of them
    difficult, listed with a test image in the split ``difficult``."""
    jroot = str(tmp_path_factory.mktemp("synth") / "ycbv")
    j_synth.make_synthetic_icwt(jroot, n_train=3, n_test=2, seed=4)
    shutil.copy(os.path.join(jroot, "Images", "test_0000.jpg"),
                os.path.join(jroot, "Images", "diff_0000.jpg"))
    shutil.copy(os.path.join(jroot, "Masks", "test_0000.png"),
                os.path.join(jroot, "Masks", "diff_0000.png"))
    j_synth._write_xml(os.path.join(jroot, "Annotations", "diff_0000.xml"), 320, 240,
                       [("025_mug", (10, 20, 90, 110), True),
                        ("011_banana", (120, 40, 200, 150), False)])
    with open(os.path.join(jroot, "ImageSets", "Main", "difficult.txt"), "w") as f:
        f.write("test_0000\ndiff_0000\n")
    return jroot


def test_synthetic_trees_are_identical(tmp_path):
    t_synth.make_synthetic_icwt(str(tmp_path / "port_ycbv"), n_train=3, n_test=2, seed=4)
    j_synth.make_synthetic_icwt(str(tmp_path / "jax_ycbv"), n_train=3, n_test=2, seed=4)
    jt, tt = _tree_files(str(tmp_path / "jax_ycbv")), _tree_files(str(tmp_path / "port_ycbv"))
    assert sorted(jt) == sorted(tt) and len(jt) == 5 * 3 + 4  # jpg, png, xml; 4 lists
    for k in jt:
        assert jt[k] == tt[k], k


def _assert_anno_equal(a, b):
    assert a.image_id == b.image_id and (a.width, a.height) == (b.width, b.height)
    for k in ("boxes", "labels", "difficult"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("split,use_difficult", [("train", False), ("test", False),
                                                 ("difficult", False), ("difficult", True)])
def test_icubworld_dataset_matches_jax(synth_root, split, use_difficult):
    root = synth_root
    jds = j_icw.ICubWorldDataset(root, "Main", split, use_difficult=use_difficult)
    tds = t_icw.ICubWorldDataset(root, "Main", split, use_difficult=use_difficult)
    assert tds.ids == jds.ids and len(tds) == len(jds) > 0
    assert tds.classes == jds.classes and tds.compute_masks == jds.compute_masks
    for i in range(len(jds)):
        ja, ta = jds.get_annotation(i), tds.get_annotation(i)
        _assert_anno_equal(ta, ja)
        jh, th = j_datasets.harvest_annotation(jds, i), t_datasets.harvest_annotation(tds, i)
        _assert_anno_equal(th, jh)
        assert tds.image_path(i) == jds.image_path(i)
        np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
        np.testing.assert_array_equal(tds.load_masks(i, ta), jds.load_masks(i, ja))
        assert tds.map_class_id_to_class_name(int(ta.labels[0])) == \
            jds.map_class_id_to_class_name(int(ja.labels[0]))
    if split == "difficult":  # the difficult object: kept by the harvest parser only
        anno, hanno = tds.get_annotation(1), tds.harvest_annotation(1)
        assert len(anno.boxes) == (2 if use_difficult else 1) and len(hanno.boxes) == 2
        np.testing.assert_array_equal(hanno.boxes[1], anno.boxes[-1] - 1)


@pytest.mark.parametrize("flags", [dict(), dict(is_target_task=True),
                                   dict(is_target_task=True, icwt_21_objs=True)])
def test_icubworld_class_tables_match_jax(tmp_path, flags):
    """The class table picked from the root's name and the flags."""
    root = str(tmp_path / "iCWT")
    j_synth.make_synthetic_icwt(root, classes=("mug1", "flower2"), n_train=2, n_test=1)
    jds = j_icw.ICubWorldDataset(root, "Main", "train", remove_images_without_annotations=False,
                                 **flags)
    tds = t_icw.ICubWorldDataset(root, "Main", "train", remove_images_without_annotations=False,
                                 **flags)
    assert tds.classes == jds.classes and tds.class_to_ind == jds.class_to_ind
    assert tds.ids == jds.ids


@pytest.fixture
def bop_root(tmp_path):
    """A BOP scene as ``tests/test_ycb_video.py`` fabricates one: two visible
    objects and an invisible one."""
    from PIL import Image

    root = tmp_path / "YCB-Video" / "test"
    scene = root / "000048"
    (scene / "rgb").mkdir(parents=True)
    (scene / "mask_visib").mkdir()
    rng = np.random.default_rng(0)
    scene_gt = {"1": [{"obj_id": 2}, {"obj_id": 10}, {"obj_id": 5}],
                "2": [{"obj_id": 1}, {"obj_id": 14}]}
    scene_gt_info = {"1": [{"bbox_visib": [100, 80, 60, 40]},
                           {"bbox_visib": [300, 200, 50, 70]},
                           {"bbox_visib": [-1, -1, -1, -1]}],
                     "2": [{"bbox_visib": [10, 20, 30, 40]},
                           {"bbox_visib": [200, 100, 0, 50]}]}
    (scene / "scene_gt.json").write_text(json.dumps(scene_gt))
    (scene / "scene_gt_info.json").write_text(json.dumps(scene_gt_info))
    for frame, n in ((1, 3), (2, 2)):
        Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)).save(
            scene / "rgb" / f"{frame:06d}.png")
        for j in range(n):
            m = np.zeros((480, 640), np.uint8)
            if j < 2:
                m[80 + 10 * frame:120, 100:160 + j] = 255
            Image.fromarray(m).save(scene / "mask_visib" / f"{frame:06d}_{j:06d}.png")
    (root / "imageset_test.txt").write_text("000048 000001\n000048 000002\n")
    return str(root)


@pytest.mark.parametrize("not_in_ho3d", [False, True])
def test_ycb_video_dataset_matches_jax(bop_root, not_in_ho3d):
    jds = j_ycbv.YCBVideoDataset(bop_root, split="imageset_test",
                                 ycbv_classes_not_in_ho3d=not_in_ho3d)
    tds = t_ycbv.YCBVideoDataset(bop_root, split="imageset_test",
                                 ycbv_classes_not_in_ho3d=not_in_ho3d)
    assert tds.ids == jds.ids and tds.classes == jds.classes
    assert len(tds) == (1 if not_in_ho3d else 2)
    for i in range(len(jds)):
        ja, ta = jds.get_annotation(i), tds.get_annotation(i)
        _assert_anno_equal(ta, ja)
        _assert_anno_equal(t_datasets.harvest_annotation(tds, i),
                           j_datasets.harvest_annotation(jds, i))
        assert tds.image_path(i) == jds.image_path(i)
        np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
        np.testing.assert_array_equal(tds.load_masks(i, ta), jds.load_masks(i, ja))


# ---------------------------------------------------------------------------
# voc_eval


N_CLS = 5  # classes 1..5; class 5 never appears (NaN AP), class 4 only as difficult


def _eval_case(seed=0, n_img=6, h=60, w=80):
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_img):
        g = int(rng.integers(1, 4))
        xy = rng.uniform(0, [w - 20, h - 20], size=(g, 2))
        wh = rng.uniform(8, 30, size=(g, 2))
        boxes = np.round(np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])], 1))
        labels = rng.integers(1, 4, size=g).astype(np.int32)
        difficult = rng.uniform(size=g) < 0.25
        if rng.uniform() < 0.5:
            boxes = np.concatenate([boxes, [[5.0, 5.0, 25.0, 30.0]]])
            labels = np.append(labels, 4).astype(np.int32)
            difficult = np.append(difficult, True)
        masks = np.zeros((len(boxes), h, w), np.float32)
        for k, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
            masks[k, y1:y2 + 1, x1:x2 + 1] = 1.0
        gts.append({"boxes": boxes.astype(np.float32), "labels": labels,
                    "difficult": difficult, "masks": masks})
        # detections: jittered GT (some twice, some with a wrong label) and noise
        d_boxes = [boxes + rng.normal(0, 2.5, boxes.shape), boxes[:1] + 1.0,
                   np.sort(rng.uniform(0, w - 1, size=(2, 4)), 1)]
        d_labels = [labels, labels[:1], rng.integers(1, 5, size=2)]
        pb = np.concatenate(d_boxes).astype(np.float32)
        pl = np.concatenate(d_labels).astype(np.int32)
        flip = rng.uniform(size=len(pl)) < 0.15
        pl[flip] = rng.integers(1, 5, size=int(flip.sum()))
        preds.append({"boxes": pb, "scores": rng.uniform(size=len(pb)).astype(np.float32),
                      "labels": pl,
                      "masks": rng.uniform(0.35, 1.0, size=(len(pb), 14, 14)).astype(np.float32)})
    names = ["__background__"] + [f"object_{i}" for i in range(1, N_CLS + 1)]
    return preds, gts, names


@pytest.mark.parametrize("use_07", [True, False])
@pytest.mark.parametrize("ious", [(0.5,), (0.7,), (0.5, 0.7)])
def test_evaluate_matches_jax(tmp_path, use_07, ious):
    preds, gts, names = _eval_case()
    out = {}
    for name, mod in (("jax", j_voc), ("port", t_voc)):
        d = tmp_path / name
        d.mkdir()
        res = mod.evaluate(preds, gts, names, iou_thresholds=ious, use_07_metric=use_07,
                           evaluate_segmentation=True, output_dir=str(d))
        out[name] = (res, (d / "result.txt").read_text())
    (jres, jtext), (tres, ttext) = out["jax"], out["port"]
    assert ttext == jtext
    assert sorted(tres) == sorted(jres)
    for k in jres:
        np.testing.assert_array_equal(tres[k], jres[k], err_msg=k)
    det = tres[f"det_ap_{ious[0]}"]
    assert len(det) == N_CLS and np.isnan(det[0]) and np.isnan(det[4])  # 4: difficult only
    assert 0.0 < tres[f"det_map_{ious[0]}"] < 1.0 and 0.0 < tres[f"segm_map_{ious[0]}"] < 1.0


def test_prec_rec_match_jax():
    """The per-class precision and recall arrays themselves, detection and
    segmentation."""
    preds, gts, _ = _eval_case(seed=1)
    for fn in ("detection_prec_rec", "segmentation_prec_rec"):
        jp, jr = getattr(j_voc, fn)(preds, gts, 0.5)
        tp, tr = getattr(t_voc, fn)(preds, gts, 0.5)
        assert len(tp) == len(jp) and len(tr) == len(jr)
        for a, b in zip(tp + tr, jp + jr):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("box", [[10.0, 12.0, 40.0, 30.0], [-15.0, -5.0, 20.0, 25.0],
                                 [60.0, 40.0, 95.0, 70.0], [30.0, 30.0, 30.5, 31.0],
                                 [100.0, 100.0, 120.0, 130.0]])
def test_paste_mask_matches_jax(box):
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(14, 14)).astype(np.float32)
    box = np.asarray(box, np.float32)
    got, want = t_voc.paste_mask(mask, box, 60, 80), j_voc.paste_mask(mask, box, 60, 80)
    np.testing.assert_array_equal(got, want)
    a = rng.uniform(size=(3, 60, 80)) > 0.5
    b = rng.uniform(size=(2, 60, 80)) > 0.7
    np.testing.assert_array_equal(t_voc.mask_iou(a, b), j_voc.mask_iou(a, b))


# ---------------------------------------------------------------------------
# coco_rle


def _rle_masks():
    rng = np.random.default_rng(3)
    ms = [np.zeros((5, 7), np.uint8), np.ones((4, 6), np.uint8)]
    first = np.zeros((6, 5), np.uint8)
    first[0, 0] = 1
    ms.append(first)
    ms += [(rng.uniform(size=(h, w)) > p).astype(np.uint8)
           for h, w, p in ((30, 40, 0.5), (64, 48, 0.9), (17, 23, 0.2))]
    big = np.zeros((200, 300), np.uint8)
    big[20:180, 40:260] = 1  # long runs: multi-char counts and negative deltas
    ms.append(big)
    return ms


@pytest.mark.parametrize("k", range(7))
def test_coco_rle_matches_jax(k):
    m = _rle_masks()[k]
    jr, tr = j_rle.rle_encode(m), t_rle.rle_encode(m)
    assert tr == jr
    np.testing.assert_array_equal(t_rle.rle_decode(jr), m)
    np.testing.assert_array_equal(j_rle.rle_decode(tr), m)
    assert t_rle.rle_area(tr) == j_rle.rle_area(jr) == int(m.sum())


def test_masks_to_coco_format_matches_jax():
    rng = np.random.default_rng(5)
    probs = rng.uniform(size=(3, 20, 30)).astype(np.float32)
    labels, scores = np.array([1, 4, 2]), np.array([0.9, 0.5, 0.25], np.float32)
    assert (t_rle.masks_to_coco_format(probs, labels, scores, 7)
            == j_rle.masks_to_coco_format(probs, labels, scores, 7))
