"""HO-3D v2 -> iCWT-format converter; a copy of the JAX package's
``data/ho3d_to_icwt.py`` (numpy, ``xml`` and ``shutil``; PIL is imported
only where an image is read or written). Run it as a module:

    python -m online_detection_tpu_torch.data.ho3d_to_icwt --ho3d_root HO3D_v2 \\
        --out Data/datasets/HO3D_V2_iCWT_format

Torch/cv2-free rebuild of the reference's ``src/ho3d-to-icwt-format.py``
(SURVEY.md §2.1 "Data tooling"): for each HO-3D training sequence, derive the
object class from the sequence-name table, resize the rendered ``seg`` masks
to 640x480 (cv2-convention bilinear, see ``_resize_bilinear_cv2``), binarize
(blue channel >= 100 marks the object), write the binary mask PNG, the
VOC-style XML (box = mask extents, xmax/ymax exclusive like the reference's
``max+1``), and copy the RGB frame. Layout:

    <out>/train/{Images,Annotations,Masks}/<seq>/<frame>.{png,xml,png}
    <out>/train/ImageSets/imageset_*.txt
        (the reference's curated held-out-sequence splits, written by
        ``write_reference_imagesets``; plus optional naive strides via
        ``write_imagesets``)
"""

from __future__ import annotations

import glob
import os
import shutil
import xml.etree.ElementTree as ET
from typing import Dict, Iterable, Optional

import numpy as np

SEQUENCE_TO_CLASS: Dict[str, str] = {
    **{f"ABF1{i}": "021_bleach_cleanser" for i in range(5)},
    **{f"BB1{i}": "011_banana" for i in range(5)},
    **{f"GPMF1{i}": "010_potted_meat_can" for i in range(5)},
    **{f"GSF1{i}": "037_scissors" for i in range(5)},
    **{f"MC{i}": "003_cracker_box" for i in (1, 2, 4, 5, 6)},
    **{f"MDF1{i}": "035_power_drill" for i in range(5)},
    "ND2": "035_power_drill",
    **{f"SB1{i}": "021_bleach_cleanser" for i in (0, 2, 4)},
    **{f"ShSu1{i}": "004_sugar_box" for i in (0, 2, 3, 4)},
    **{f"SiBF1{i}": "011_banana" for i in range(5)},
    "SiS1": "004_sugar_box",
    **{f"SM{i}": "006_mustard_bottle" for i in (2, 3, 4, 5)},
    "SMu1": "025_mug", "SMu40": "025_mug", "SMu41": "025_mug", "SMu42": "025_mug",
    "SS1": "004_sugar_box", "SS2": "004_sugar_box", "SS3": "004_sugar_box",
}


def _resize_bilinear_cv2(img: np.ndarray, out_wh) -> np.ndarray:
    """Bilinear resize with cv2's ``INTER_LINEAR`` coordinate convention
    (``src = (dst + 0.5) * scale - 0.5``, edge-clamped), in float.

    The reference resizes the seg render with cv2's DEFAULT interpolation
    (bilinear, ``ho3d-to-icwt-format.py:197``) before thresholding; PIL's
    BILINEAR applies a triangle filter on downscale and would move mask
    boundaries by a pixel or two. This reproduces cv2's sampling exactly up
    to float-vs-fixed-point rounding (cv2 interpolates in 11-bit fixed
    point), which can flip a boundary pixel only when the interpolated
    blue channel lands exactly on the threshold. Identity (and bit-exact)
    when the input is already the target size — the HO-3D v2 release norm.
    """
    ow, oh = out_wh
    h, w = img.shape[:2]
    if (w, h) == (ow, oh):
        return img
    sx, sy = w / ow, h / oh
    fx = (np.arange(ow) + 0.5) * sx - 0.5
    fy = (np.arange(oh) + 0.5) * sy - 0.5
    x0 = np.clip(np.floor(fx).astype(np.int64), 0, w - 1)
    y0 = np.clip(np.floor(fy).astype(np.int64), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = np.clip(fx - x0, 0.0, 1.0)[None, :, None]
    wy = np.clip(fy - y0, 0.0, 1.0)[:, None, None]
    im = img.astype(np.float32)
    top = im[y0[:, None], x0[None, :]] * (1 - wx) + im[y0[:, None], x1[None, :]] * wx
    bot = im[y1[:, None], x0[None, :]] * (1 - wx) + im[y1[:, None], x1[None, :]] * wx
    out = top * (1 - wy) + bot * wy
    return np.rint(out).clip(0, 255).astype(np.uint8)


def _write_xml(path: str, img_name: str, objects):
    root = ET.Element("annotation")
    ET.SubElement(root, "folder").text = "Images"
    ET.SubElement(root, "filename").text = img_name
    src = ET.SubElement(root, "source")
    ET.SubElement(src, "database").text = "HO3D_V2"
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "width").text = "640"
    ET.SubElement(size, "height").text = "480"
    ET.SubElement(size, "depth").text = "3"
    ET.SubElement(root, "tstamp").text = "0"
    ET.SubElement(root, "segmented").text = "1"
    for obj in objects:
        o = ET.SubElement(root, "object")
        ET.SubElement(o, "category").text = obj["label"]
        ET.SubElement(o, "name").text = obj["label"]
        ET.SubElement(o, "truncated").text = "0"
        ET.SubElement(o, "difficult").text = "0"
        bb = ET.SubElement(o, "bndbox")
        for k in ("xmin", "ymin", "xmax", "ymax"):
            ET.SubElement(bb, k).text = str(obj[k])
    ET.ElementTree(root).write(path)


def convert(
    ho3d_train_dir: str,
    out_dir: str,
    sequences: Optional[Iterable[str]] = None,
    blue_threshold: int = 100,
):
    """Convert HO-3D ``train/<seq>/{rgb,seg}`` into the iCWT layout."""
    from PIL import Image

    out_train = os.path.join(out_dir, "train")
    for sub in ("Images", "Annotations", "Masks", "ImageSets"):
        os.makedirs(os.path.join(out_train, sub), exist_ok=True)

    converted = []
    seq_dirs = sorted(glob.glob(os.path.join(ho3d_train_dir, "*")))
    for seq_dir in seq_dirs:
        seq = os.path.basename(seq_dir)
        if sequences is not None and seq not in sequences:
            continue
        cls = None
        for k, v in SEQUENCE_TO_CLASS.items():
            if k in seq:
                cls = v
                break
        if cls is None:
            continue
        for sub in ("Images", "Annotations", "Masks"):
            os.makedirs(os.path.join(out_train, sub, seq), exist_ok=True)
        for seg_file in sorted(glob.glob(os.path.join(seq_dir, "seg", "*"))):
            name = os.path.splitext(os.path.basename(seg_file))[0]
            seg = _resize_bilinear_cv2(
                np.asarray(Image.open(seg_file).convert("RGB")), (640, 480)
            )
            # the renderer marks the object in the blue channel (cv2 BGR
            # ">= [100,0,0]" == RGB blue channel >= 100)
            obj = seg[..., 2] >= blue_threshold
            mask = (obj * 255).astype(np.uint8)
            Image.fromarray(mask).save(
                os.path.join(out_train, "Masks", seq, name + ".png")
            )
            objects = []
            ys, xs = np.nonzero(obj)
            if len(ys):
                objects.append(
                    {
                        "xmin": int(xs.min()), "ymin": int(ys.min()),
                        "xmax": int(xs.max()) + 1, "ymax": int(ys.max()) + 1,
                        "label": cls,
                    }
                )
            _write_xml(
                os.path.join(out_train, "Annotations", seq, name + ".xml"),
                name, objects,
            )
            src_img = os.path.join(seq_dir, "rgb", name + ".png")
            if os.path.exists(src_img):
                shutil.copyfile(
                    src_img, os.path.join(out_train, "Images", seq, name + ".png")
                )
            if objects:
                converted.append(f"{seq}/{name}")
    return converted


def write_imagesets(out_dir: str, ids, stride: int = 1, name: str = "imageset_train"):
    """Write ``ImageSets/<name>{_1_out_of_<stride>}.txt``."""
    suffix = "" if stride == 1 else f"_1_out_of_{stride}"
    path = os.path.join(out_dir, "train", "ImageSets", f"{name}{suffix}.txt")
    with open(path, "w") as f:
        f.write("\n".join(ids[::stride]) + "\n")
    return path


# The reference's HO-3D experiment splits are CURATED HELD-OUT SEQUENCES
# shipped as ImageSets files (Data/datasets/HO3D_V2_iCWT_format/train/
# ImageSets/*.txt in the reference checkout), NOT strides over the full
# converted id list — a naive frame stride would leak test sequences into
# the train split. Sequence membership and per-split frame strides below are
# transcribed from those shipped files (one unseen sequence per object for
# test; the last train sequence of each object doubles as val):
_REFERENCE_SPLITS = {
    # (name, frame stride within each sequence, sequence list)
    "imageset_train_1_out_of_2": (2, (
        "ABF10", "ABF11", "ABF12", "ABF13", "BB10", "BB11", "BB12", "BB13",
        "GPMF10", "GPMF11", "GPMF12", "GPMF13", "GSF10", "GSF11", "GSF12",
        "GSF13", "MC1", "MC2", "MC4", "MC5", "MDF10", "MDF11", "MDF12",
        "MDF13", "ShSu10", "ShSu12", "ShSu13", "ShSu14", "SM2", "SM3", "SM4",
        "SMu1", "SMu40", "SMu41",
    )),
    "imageset_train_1_out_of_2_3_seq": (2, (
        "ABF10", "ABF11", "ABF12", "BB10", "BB11", "BB12", "GPMF10",
        "GPMF11", "GPMF12", "GSF10", "GSF11", "GSF12", "MC1", "MC2", "MC4",
        "MDF10", "MDF11", "MDF12", "ShSu10", "ShSu12", "ShSu13", "SM2",
        "SM3", "SMu1", "SMu40",
    )),
    "imageset_val_1_out_of_5": (5, (
        "ABF13", "BB13", "GPMF13", "GSF13", "MC5", "MDF13", "ShSu14", "SM4",
        "SMu41",
    )),
    "imageset_test_1_out_of_5": (5, (
        "ABF14", "BB14", "GPMF14", "GSF14", "MC6", "MDF14", "SiS1", "SM5",
        "SMu42",
    )),
}


def write_reference_imagesets(out_dir: str, ids):
    """Emit the reference's four curated ImageSets files from the converted
    ``<seq>/<frame>`` ids: per split, concatenate ALL frames of its hardcoded
    sequences in case-insensitive order and take every Nth id of the
    CONCATENATION — the stride phase carries across sequence boundaries
    (verified against the shipped files: e.g. ``imageset_test_1_out_of_5``
    runs ``...BB14/1190 -> GPMF14/0001 -> ... -> GSF14/0003``, which only a
    global stride over the true per-sequence frame counts produces).
    Sequences absent from ``ids`` (not downloaded/converted) are skipped
    with a warning so a partial conversion still yields runnable (if
    smaller) splits — note a skip shifts the downstream phase vs the
    shipped files."""
    by_seq: Dict[str, list] = {}
    for i in ids:
        seq, _, frame = i.partition("/")
        by_seq.setdefault(seq, []).append(frame)
    paths = []
    for name, (stride, seqs) in _REFERENCE_SPLITS.items():
        concat = []
        for seq in sorted(seqs, key=str.lower):
            if seq not in by_seq:
                print(f"warning: split {name}: sequence {seq} has no "
                      "converted frames; skipping it")
                continue
            concat += [f"{seq}/{f}" for f in sorted(by_seq[seq])]
        lines = concat[::stride]
        path = os.path.join(out_dir, "train", "ImageSets", f"{name}.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append((path, len(lines)))
    return paths


def main(argv=None):
    """CLI equivalent of running the reference's ``src/ho3d-to-icwt-format.py``
    (which hardcodes ``$HOME_DIR/Data/datasets`` paths at :11-25)."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--ho3d_root", required=True,
        help="HO-3D v2 root (containing train/<seq>/{rgb,seg})")
    parser.add_argument(
        "--out", required=True,
        help="output root, e.g. Data/datasets/HO3D_V2_iCWT_format")
    parser.add_argument(
        "--imageset_strides", type=int, nargs="*", default=[],
        help="ALSO write naive ImageSets/imageset_train_1_out_of_<s>.txt "
        "strides over every converted frame (the reference experiments use "
        "the curated splits written by default, not these)")
    parser.add_argument(
        "--no_reference_imagesets", action="store_true",
        help="skip writing the reference's curated "
        "train/train_3_seq/val/test splits (held-out test sequences: "
        "ABF14 BB14 GPMF14 GSF14 MC6 MDF14 SiS1 SM5 SMu42)")
    args = parser.parse_args(argv)

    train_dir = os.path.join(args.ho3d_root, "train")
    if not os.path.isdir(train_dir):
        train_dir = args.ho3d_root
    ids = convert(train_dir, args.out)
    if not args.no_reference_imagesets:
        for path, n in write_reference_imagesets(args.out, ids):
            print(f"wrote {path} ({n} ids)")
    for stride in args.imageset_strides:
        path = write_imagesets(args.out, ids, stride=stride)
        print(f"wrote {path} ({len(ids[::stride])} ids)")
    print(f"converted {len(ids)} annotated frames into {args.out}")


if __name__ == "__main__":
    main()
