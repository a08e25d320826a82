"""YCB-Video dataset reader (BOP format); a copy of the JAX package's
``data/datasets/ycb_video.py``. PIL is imported only where an image or a
mask is read.

Rebuild of ``data/datasets/ycb_video.py:43-246``: image-set lines
``"<scene> <frame>"``, per-scene ``scene_gt.json`` (obj_id) +
``scene_gt_info.json`` (bbox_visib [x, y, w, h]) and per-object
``mask_visib/<frame>_<j>.png`` masks. Boxes become xyxy via
``[x, y, x+w-1, y+h-1]``; entries with bbox_visib [-1,-1,-1,-1] or zero w/h
are skipped. The ``ycbv_classes_not_in_ho3d`` filter reproduces the HO-3D
transfer split.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from online_detection_tpu_torch.data.datasets.icubworld import ImageAnnotation

YCBV_CLASSES = (
    "__background__",
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
)

HO3D_OVERLAP_CLASSES = (
    "__background__",
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "021_bleach_cleanser",
    "025_mug", "035_power_drill", "037_scissors",
)

YCBV_NOT_IN_HO3D_CLASSES = (
    "__background__",
    "002_master_chef_can", "005_tomato_soup_can", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "019_pitcher_base", "024_bowl",
    "036_wood_block", "040_large_marker", "051_large_clamp",
    "052_extra_large_clamp", "061_foam_brick",
)


@dataclass
class YCBVideoDataset:
    data_dir: str
    image_set: str = ""
    split: str = "imageset_train"
    ycbv_classes_not_in_ho3d: bool = False
    ids: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.root = self.data_dir
        ext = "jpg" if "pbr" in self.root else "png"
        self._imgpath = os.path.join(self.root, "%s", "rgb", "%s." + ext)
        self._maskpath = os.path.join(self.root, "%s", "mask_visib", "%s.png")
        self.classes = (
            YCBV_NOT_IN_HO3D_CLASSES if self.ycbv_classes_not_in_ho3d else YCBV_CLASSES
        )

        if not self.ids:
            with open(os.path.join(self.root, self.split + ".txt")) as f:
                self.ids = [line.strip() for line in f if line.strip()]

        self.scene_gts = {}
        self.scene_gt_infos = {}
        for line in self.ids:
            scene = line.split()[0]
            if scene in self.scene_gts:
                continue
            with open(os.path.join(self.root, scene, "scene_gt.json")) as f:
                self.scene_gts[scene] = json.load(f)
            with open(os.path.join(self.root, scene, "scene_gt_info.json")) as f:
                self.scene_gt_infos[scene] = json.load(f)

        if self.ycbv_classes_not_in_ho3d:
            kept = []
            for line in self.ids:
                anno = self._parse(line)
                if len(anno.boxes):
                    kept.append(line)
            self.ids = kept

    def __len__(self) -> int:
        return len(self.ids)

    def _parse(self, line: str) -> ImageAnnotation:
        scene, frame = line.split()
        scene_gt = self.scene_gts[scene]
        info = self.scene_gt_infos[scene]
        entries_gt = scene_gt[str(int(frame))]
        entries_info = info[str(int(frame))]
        boxes, labels = [], []
        self._mask_indices_cache = getattr(self, "_mask_indices_cache", {})
        kept_j = []
        for j in range(len(entries_gt)):
            bbox = entries_info[j]["bbox_visib"]
            if bbox == [-1, -1, -1, -1] or bbox[2] == 0 or bbox[3] == 0:
                continue
            obj_id = entries_gt[j]["obj_id"]
            if self.ycbv_classes_not_in_ho3d:
                if YCBV_CLASSES[obj_id] in HO3D_OVERLAP_CLASSES:
                    continue
                obj_id = YCBV_NOT_IN_HO3D_CLASSES.index(YCBV_CLASSES[obj_id])
            boxes.append([bbox[0], bbox[1], bbox[0] + bbox[2] - 1, bbox[1] + bbox[3] - 1])
            labels.append(obj_id)
            kept_j.append(j)
        self._mask_indices_cache[line] = kept_j
        return ImageAnnotation(
            image_id=line,
            width=640,
            height=480,
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32),
            difficult=np.zeros(len(labels), bool),
        )

    def get_annotation(self, index: int) -> ImageAnnotation:
        return self._parse(self.ids[index])

    def harvest_annotation(self, index: int) -> ImageAnnotation:
        """The BOP path is the one place the reference's harvest-side GT
        parser (``compute_gts_ycbv``, ``feature_proposal_extractor.py:
        181-231``) agrees with its eval-side one (``ycb_video.py:190+``):
        both build ``[x, y, x+w-1, y+h-1]`` boxes with the same skip rules,
        so harvest == eval here (unlike the XML datasets — see
        ``ICubWorldDataset.harvest_annotation``)."""
        return self._parse(self.ids[index])

    def image_path(self, index: int) -> str:
        """Filesystem path of image ``index`` (native prefetcher input)."""
        scene, frame = self.ids[index].split()
        return self._imgpath % (scene, frame)

    def load_image(self, index: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.image_path(index)).convert("RGB"))

    def load_masks(self, index: int, anno: Optional[ImageAnnotation] = None) -> np.ndarray:
        from PIL import Image

        line = self.ids[index]
        anno = anno or self._parse(line)
        scene, frame = line.split()
        kept = self._mask_indices_cache.get(line)
        if kept is None:
            self._parse(line)
            kept = self._mask_indices_cache[line]
        masks = []
        for j in kept:
            path = self._maskpath % (scene, f"{frame}_{j:06d}")
            if not os.path.exists(path):
                cands = sorted(glob.glob(self._maskpath % (scene, frame + "_*")))
                path = cands[j] if j < len(cands) else None
            if path:
                m = np.asarray(Image.open(path))
                masks.append((m > 0).astype(np.float32))
            else:
                masks.append(np.zeros((anno.height, anno.width), np.float32))
        if not masks:
            return np.zeros((0, anno.height, anno.width), np.float32)
        return np.stack(masks)

    def map_class_id_to_class_name(self, class_id: int) -> str:
        return self.classes[class_id]
