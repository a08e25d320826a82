"""iCubWorld-format dataset reader (VOC-style XML + ImageSets + mask PNGs); a
copy of the JAX package's ``data/datasets/icubworld.py``. PIL is imported
only where an image or a mask is read.

Rebuild of ``data/datasets/icubworld.py:46-276``: the same
directory contract (``Annotations/%s.xml``, ``Images/%s.jpg`` — ``.png`` for
HO-3D — ``Masks/%s.png``, ``ImageSets/<set>/<split>.txt``) and class tables
(iCWT-30 / iCWT-21 TARGET-TASK, YCBV-in-hand, HO-3D).

Quirk preserved: the reference's ``'HO3D' or 'ycbv' in self.root`` condition
is always truthy, so XML boxes are never shifted by -1 regardless of dataset
(``icubworld.py:211-218``); we replicate (TO_REMOVE = 0).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

ICWT_CLASSES = (
    "__background__",
    *[f"{c}{i}" for c in (
        "cellphone", "mouse", "perfume", "remote", "soapdispenser",
        "sunglasses", "glass", "hairbrush", "ovenglove", "squeezer",
    ) for i in range(1, 11)],
)

ICWT_TARGET_TASK_CLASSES = (
    "__background__",
    "flower2", "flower5", "flower7",
    "mug1", "mug3", "mug4",
    "wallet6", "wallet7", "wallet10",
    "sodabottle2", "sodabottle3", "sodabottle4",
    "book4", "book6", "book9",
    "ringbinder4", "ringbinder5", "ringbinder6",
    "bodylotion2", "bodylotion5", "bodylotion8",
    "sprayer6", "sprayer8", "sprayer9",
    "pencilcase3", "pencilcase5", "pencilcase6",
    "hairclip2", "hairclip6", "hairclip8",
)

ICWT_TARGET_TASK_21_CLASSES = (
    "__background__",
    "sodabottle3", "sodabottle4",
    "mug1", "mug3", "mug4",
    "pencilcase5", "pencilcase3",
    "ringbinder4", "ringbinder5",
    "wallet6",
    "flower7", "flower5", "flower2",
    "book6", "book9",
    "hairclip2", "hairclip8", "hairclip6",
    "sprayer6", "sprayer8", "sprayer9",
)

YCBV_IN_HAND_CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "024_bowl", "025_mug",
    "035_power_drill", "036_wood_block", "037_scissors",
    "051_large_clamp", "052_extra_large_clamp", "061_foam_brick",
)

HO3D_CLASSES = (
    "__background__",
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "021_bleach_cleanser",
    "025_mug", "035_power_drill", "037_scissors",
)


@dataclass
class ImageAnnotation:
    image_id: str
    width: int
    height: int
    boxes: np.ndarray  # [G, 4] xyxy float32
    labels: np.ndarray  # [G] int32, 1-based
    difficult: np.ndarray  # [G] bool


@dataclass
class ICubWorldDataset:
    """Filesystem-backed dataset. ``root`` is the dataset directory."""

    root: str
    image_set: str
    split: str
    use_difficult: bool = False
    is_target_task: bool = False
    icwt_21_objs: bool = False
    remove_images_without_annotations: bool = True
    ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        self._annopath = os.path.join(self.root, "Annotations", "%s.xml")
        img_ext = ".png" if "HO3D" in self.root else ".jpg"
        self._imgpath = os.path.join(self.root, "Images", "%s" + img_ext)
        self._maskpath = os.path.join(self.root, "Masks", "%s.png")
        self.compute_masks = ("ycbv" in self.root) or ("HO3D" in self.root)

        if "ycbv" in self.root:
            cls = YCBV_IN_HAND_CLASSES
        elif "HO3D" in self.root:
            cls = HO3D_CLASSES
        elif not self.is_target_task:
            cls = ICWT_CLASSES
        elif self.icwt_21_objs:
            cls = ICWT_TARGET_TASK_21_CLASSES
        else:
            cls = ICWT_TARGET_TASK_CLASSES
        self.classes = cls
        self.class_to_ind = {c: i for i, c in enumerate(cls)}

        if not self.ids:
            setpath = os.path.join(
                self.root, "ImageSets", self.image_set, self.split + ".txt"
            )
            with open(setpath) as f:
                self.ids = [line.strip() for line in f if line.strip()]
        if self.remove_images_without_annotations:
            self.ids = [i for i in self.ids if len(self.parse_annotation(i).boxes)]

    def __len__(self) -> int:
        return len(self.ids)

    def parse_annotation(self, image_id: str) -> ImageAnnotation:
        root = ET.parse(self._annopath % image_id).getroot()
        boxes, labels, difficult = [], [], []
        for obj in root.iter("object"):
            diff_node = obj.find("difficult")
            if diff_node is None:
                continue
            diff = int(diff_node.text) == 1
            if diff and not self.use_difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            boxes.append(
                [int(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
            )
            labels.append(self.class_to_ind[name])
            difficult.append(diff)
        size = root.find("size")
        h, w = int(size.find("height").text), int(size.find("width").text)
        return ImageAnnotation(
            image_id=image_id,
            width=w,
            height=h,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32),
            difficult=np.asarray(difficult, bool),
        )

    def get_annotation(self, index: int) -> ImageAnnotation:
        return self.parse_annotation(self.ids[index])

    def harvest_annotation(self, index: int) -> ImageAnnotation:
        """GT boxes as the reference's HARVEST/eval-model path builds them.

        The reference has TWO XML parsers that disagree: the dataset class
        (``icubworld.py:215-218``, TO_REMOVE=0 because ``'HO3D' or 'ycbv' in
        self.root`` is always truthy) feeds the *evaluator*, while the engine
        (``feature_proposal_extractor.py:165-173``, ``engine/inference.py:
        195-203``) re-parses the XML for the boxes fed to the *model* —
        there the inverted condition ``'HO3D' or 'ycbv' not in anno_dir`` is
        always truthy too, so those boxes get an unconditional -1 shift AND
        no difficult-filtering (``compute_gts_icwt`` never reads the
        ``difficult`` node). Harvested positives/COXY and the
        eval-segm-with-GT-boxes substitution therefore see (xml - 1) boxes
        of ALL named objects, while mAP matching sees unshifted,
        difficult-filtered boxes. This method replicates the engine parser.
        """
        image_id = self.ids[index]
        root = ET.parse(self._annopath % image_id).getroot()
        boxes, labels = [], []
        for obj in root.findall("object"):
            name_node = obj.find("name")
            if name_node is None or name_node.text is None:
                continue
            bb = obj.find("bndbox")
            boxes.append(
                [float(bb.find(k).text) - 1.0
                 for k in ("xmin", "ymin", "xmax", "ymax")]
            )
            labels.append(self.class_to_ind[name_node.text])
        size = root.find("size")
        h, w = int(size.find("height").text), int(size.find("width").text)
        return ImageAnnotation(
            image_id=image_id,
            width=w,
            height=h,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32),
            difficult=np.zeros(len(labels), bool),
        )

    def image_path(self, index: int) -> str:
        """Filesystem path of image ``index`` (native prefetcher input)."""
        return self._imgpath % self.ids[index]

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.image_path(index)).convert("RGB"))

    def load_masks(self, index: int, anno: Optional[ImageAnnotation] = None) -> np.ndarray:
        """[G, H, W] float binary masks. The mask PNG holds one binary mask
        (single-instance robotics streams); multi-valued PNGs are split by
        instance value 1..G."""
        from PIL import Image

        anno = anno or self.get_annotation(index)
        m = np.asarray(Image.open(self._maskpath % self.ids[index]))
        if m.ndim == 3:
            m = m[..., 0]
        g = len(anno.boxes)
        vals = np.unique(m)
        vals = vals[vals > 0]
        if g <= 1 or len(vals) <= 1:
            return (m > 0).astype(np.float32)[None].repeat(max(g, 1), axis=0)
        out = np.zeros((g, *m.shape), np.float32)
        for i in range(g):
            val = vals[i] if i < len(vals) else vals[-1]
            out[i] = m == val
        return out

    def map_class_id_to_class_name(self, class_id: int) -> str:
        return self.classes[class_id]
