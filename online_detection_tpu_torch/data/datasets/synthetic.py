"""Synthetic iCWT-format dataset factory (a copy of the JAX package's
``data/datasets/synthetic.py``).

Fabricates the directory contract of SURVEY.md §2.1 "Datasets" (VOC-style
XMLs, ImageSets txt, mask PNGs, JPEG images) with simple colored ellipses
on noise, so the whole harvest->train->eval path can run hermetically.
Both packages write the same files from the same seed.
"""

import os
import xml.etree.ElementTree as ET

import numpy as np


def _write_xml(path, w, h, objects):
    root = ET.Element("annotation")
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "height").text = str(h)
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "depth").text = "3"
    for name, box, difficult in objects:
        obj = ET.SubElement(root, "object")
        ET.SubElement(obj, "name").text = name
        ET.SubElement(obj, "difficult").text = str(int(difficult))
        bb = ET.SubElement(obj, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, k).text = str(int(v))
    ET.ElementTree(root).write(path)


def make_synthetic_icwt(
    root: str,
    classes=("011_banana", "025_mug"),
    n_train: int = 6,
    n_test: int = 4,
    image_hw=(240, 320),
    seed: int = 0,
):
    """Create a tiny iCWT-layout dataset; class i draws a bright rectangle
    with a distinctive color. Returns (root, train_ids, test_ids).

    The directory name contains 'ycbv' so masks are enabled and boxes are
    read with the reference's TO_REMOVE=0 quirk.
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_hw
    os.makedirs(os.path.join(root, "Annotations"), exist_ok=True)
    os.makedirs(os.path.join(root, "Images"), exist_ok=True)
    os.makedirs(os.path.join(root, "Masks"), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets", "Main"), exist_ok=True)

    colors = [
        np.array([220, 40, 40]),
        np.array([40, 220, 40]),
        np.array([40, 40, 220]),
        np.array([220, 220, 40]),
    ]

    def make_image(img_id, cls_idx):
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        bw = int(rng.integers(60, 110))
        bh = int(rng.integers(60, 110))
        x1 = int(rng.integers(0, w - bw - 1))
        y1 = int(rng.integers(0, h - bh - 1))
        x2, y2 = x1 + bw, y1 + bh
        color = colors[cls_idx % len(colors)]
        # the object is an ELLIPSE inscribed in the GT box, not the full
        # rectangle: a box-filling mask projects to all-ones on the 14x14
        # GT-box grid, so mask harvesting would find ZERO negative pixels
        # and the per-pixel FALKON heads could never train at smoke scale
        # (observed: mask_neg counts all 0 -> segm mAP 0.0 everywhere)
        yy, xx = np.mgrid[0 : h, 0 : w]
        cy, cx = (y1 + y2) / 2.0, (x1 + x2) / 2.0
        ell = ((xx - cx) / (bw / 2.0)) ** 2 + ((yy - cy) / (bh / 2.0)) ** 2 <= 1.0
        img[ell] = (
            color[None] + rng.integers(-20, 20, (int(ell.sum()), 3))
        ).clip(0, 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        mask[ell] = 255
        Image.fromarray(img).save(os.path.join(root, "Images", img_id + ".jpg"))
        Image.fromarray(mask).save(os.path.join(root, "Masks", img_id + ".png"))
        _write_xml(
            os.path.join(root, "Annotations", img_id + ".xml"),
            w, h, [(classes[cls_idx], (x1, y1, x2, y2), False)],
        )

    train_ids, test_ids = [], []
    for i in range(n_train):
        img_id = f"train_{i:04d}"
        make_image(img_id, i % len(classes))
        train_ids.append(img_id)
    for i in range(n_test):
        img_id = f"test_{i:04d}"
        make_image(img_id, i % len(classes))
        test_ids.append(img_id)

    for sub in ("Main", ""):
        d = os.path.join(root, "ImageSets", sub)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "train.txt"), "w") as f:
            f.write("\n".join(train_ids) + "\n")
        with open(os.path.join(d, "test.txt"), "w") as f:
            f.write("\n".join(test_ids) + "\n")
    return root, train_ids, test_ids
