"""The one traffic generator: synthetic teaching images from a
traffic mix's parameters and the seed.

Each image is dark noise with one coloured ellipse, its box and its mask;
image i shows class ``i % classes + 1``, so every class is taught in turn.
Sides are drawn in ``object_sides`` (with random trunk weights, the
on-line RPN proposes objects of 64-192 px; larger ones get mAP 0). The
images are drawn on the run's device in a few bulk calls and kept on the
host, where the program's loaders read them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class _Anno:
    def __init__(self, boxes, labels, image_id):
        self.boxes, self.labels, self.image_id = boxes, labels, image_id
        self.difficult = np.zeros(len(labels), bool)


class SyntheticSet:
    """``n`` images of ``hw`` with ``classes`` classes: ``__len__``,
    ``load_image``, ``get_annotation`` (boxes, 1-based labels, difficult),
    ``load_masks`` and ``classes``, as the program's datasets have them."""

    def __init__(self, n: int, hw: Sequence[int], classes: int, seed: int,
                 object_sides: Sequence[int], device):
        h, w = hw
        lo, hi = object_sides
        gen = torch.Generator(device=device).manual_seed(seed)
        imgs = torch.randint(0, 60, (n, h, w, 3), generator=gen, device=device,
                             dtype=torch.uint8)
        sides = torch.randint(lo, hi, (n, 2), generator=gen, device=device)
        u = torch.rand((n, 2), generator=gen, device=device)
        bw, bh = sides[:, 0], sides[:, 1]
        x1 = (u[:, 0] * (w - bw)).long()
        y1 = (u[:, 1] * (h - bh)).long()
        cls = torch.arange(n, device=device) % classes
        color = torch.stack([(cls * 97) % 256, (cls * 57 + 80) % 256,
                             (cls * 151 + 40) % 256], -1).to(torch.uint8)
        yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
        xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
        cx = (x1 + bw / 2).float()[:, None, None]
        cy = (y1 + bh / 2).float()[:, None, None]
        ell = (((xx - cx) / (bw.float()[:, None, None] / 2)) ** 2
               + ((yy - cy) / (bh.float()[:, None, None] / 2)) ** 2) <= 1
        imgs = torch.where(ell[..., None], color[:, None, None, :], imgs)
        self.images = imgs.cpu().numpy()
        self.masks = ell.cpu().numpy()
        box = torch.stack([x1, y1, x1 + bw, y1 + bh], -1).float().cpu().numpy()
        self.boxes = [box[i:i + 1] for i in range(n)]
        self.labels = [np.array([c + 1]) for c in cls.cpu().tolist()]
        self.classes = ("__background__",) + tuple(f"object_{c + 1}" for c in range(classes))
        self.ids = [f"image_{i:04d}" for i in range(n)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def get_annotation(self, i):
        return _Anno(self.boxes[i], self.labels[i], self.ids[i])

    def load_masks(self, i, anno=None):
        return self.masks[i][None].astype(np.float32)


def teaching_set(traffic: dict, classes: int, seed: int, device) -> SyntheticSet:
    return SyntheticSet(traffic["teach_images"], traffic["image_hw"], classes, seed,
                        traffic["object_sides"], device)
