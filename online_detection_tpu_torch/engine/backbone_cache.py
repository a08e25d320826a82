"""Backbone-feature caching: the train-from-features machinery (counterpart
of ``engine/backbone_cache.py``).

The reference's backbone-feature dump (``generalized_rcnn_getProposals.py:
56-84``) and its ``*_from_feat`` datasets (``icubworld_from_feat.py``,
``ycb_video_from_feat.py``): the frozen C4 maps are computed once and cached
on disk, so the fine-tuning baseline (``--use_backbone_features``) never runs
the backbone again. The files are the JAX package's: ``features/<id>.npy``
(float16, ``/`` in an id written as ``__``) and ``features/_meta.npy`` (a
pickled dict id -> {"scale", "scaled_size"}), so each package reads the
other's cache.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.utils.device import ieee_fp32, resolve_device


def dump_backbone_features(params, dataset, out_dir: str, canvas_hw: Tuple[int, int],
                           min_size: int = 600, max_size: int = 1333, device=None) -> str:
    """Runs the backbone (in f32, IEEE fp32 convs; the stem is kernel B2 on
    the card) over the dataset, one image at a time, and caches each C4 map
    as ``features/<image_id>.npy`` in float16 (the consumers cast back).
    ``params`` must live on ``device`` (the card by default). Returns the
    features directory."""
    dev = resolve_device(device)
    feat_dir = os.path.join(out_dir, "features")
    os.makedirs(feat_dir, exist_ok=True)
    meta = {}
    with torch.inference_mode(), ieee_fp32():
        for i in range(len(dataset)):
            anno = dataset.get_annotation(i)
            canvas, scale, (sw, sh) = transforms.preprocess_image_u8(
                dataset.load_image(i), canvas_hw, min_size, max_size)
            image = transforms.normalize_canvas(torch.from_numpy(canvas).to(dev))
            c4 = resnet.backbone_c4(params.backbone, image[None])[0]
            safe_id = anno.image_id.replace("/", "__")
            np.save(os.path.join(feat_dir, safe_id + ".npy"),
                    c4.to(torch.float16).cpu().numpy())
            meta[anno.image_id] = {"scale": scale, "scaled_size": (sw, sh)}
    np.save(os.path.join(feat_dir, "_meta.npy"), meta, allow_pickle=True)
    return feat_dir


class FromFeatDataset:
    """Wraps a dataset and serves its cached C4 maps in place of images
    (``iCubWorldDatasetFromFeat`` / ``YCBVideoDatasetFromFeat``)."""

    def __init__(self, base, feat_dir: str):
        self.base = base
        self.feat_dir = feat_dir
        self.meta = np.load(os.path.join(feat_dir, "_meta.npy"), allow_pickle=True).item()
        self.classes = base.classes
        self.ids = base.ids

    def __len__(self):
        return len(self.base)

    def get_annotation(self, index):
        return self.base.get_annotation(index)

    def harvest_annotation(self, index):
        fn = getattr(self.base, "harvest_annotation", None)
        return fn(index) if fn else self.base.get_annotation(index)

    def load_masks(self, index, anno=None):
        return self.base.load_masks(index, anno)

    def load_features(self, index) -> Tuple[np.ndarray, float, Tuple[int, int]]:
        """(C4 map [h, w, C] float32, scale, (scaled_w, scaled_h))."""
        anno = self.base.get_annotation(index)
        safe_id = anno.image_id.replace("/", "__")
        c4 = np.load(os.path.join(self.feat_dir, safe_id + ".npy")).astype(np.float32)
        m = self.meta[anno.image_id]
        return c4, m["scale"], tuple(m["scaled_size"])

    def map_class_id_to_class_name(self, class_id):
        return self.base.map_class_id_to_class_name(class_id)
