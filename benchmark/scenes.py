"""Synthetic training scenes for the ``full_train`` kind: several objects an
image, from a traffic mix's parameters and the seed.

Each image is dark noise with ``objects`` coloured ellipses, each in a cell
of its own of a ``grid`` over the image (so none hides another), of sides
drawn in ``object_sides``, of classes drawn without repetition and uniformly
over the configuration's classes: a YCB-Video frame shows several of its 21
objects at once. Images and masks are drawn on the run's device in bulk and
kept on the host, where the program's loaders read them; a mask is kept as
its box's crop and pasted at full size when loaded, as a dataset decodes it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class _Anno:
    def __init__(self, boxes, labels, image_id):
        self.boxes, self.labels, self.image_id = boxes, labels, image_id
        self.difficult = np.zeros(len(labels), bool)


class SceneSet:
    """``n`` scenes of ``hw``: ``__len__``, ``load_image`` (uint8 RGB),
    ``get_annotation`` (boxes, 1-based labels), ``load_masks`` ([G, H, W]
    float32) and ``classes``, as the program's datasets have them."""

    def __init__(self, n: int, hw: Sequence[int], classes: int, seed: int,
                 object_sides: Sequence[int], objects: Sequence[int], grid: Sequence[int],
                 device):
        h, w = hw
        lo, hi = object_sides
        rows, cols = grid
        ch, cw = h // rows, w // cols
        k_max = objects[1]
        if hi > min(ch, cw) or k_max > rows * cols or k_max > classes:
            raise ValueError(f"{k_max} objects of up to {hi} px do not fit a {rows}x{cols} grid "
                             f"of {ch}x{cw} cells with {classes} classes")
        gen = torch.Generator(device=device).manual_seed(seed)
        imgs = torch.randint(0, 60, (n, h, w, 3), generator=gen, device=device,
                             dtype=torch.uint8)
        count = torch.randint(objects[0], k_max + 1, (n,), generator=gen, device=device)
        cell = torch.rand((n, rows * cols), generator=gen, device=device).argsort(1)[:, :k_max]
        cls = torch.rand((n, classes), generator=gen, device=device).argsort(1)[:, :k_max]
        sides = torch.randint(lo, hi, (n, k_max, 2), generator=gen, device=device)
        u = torch.rand((n, k_max, 2), generator=gen, device=device)
        bw, bh = sides[..., 0], sides[..., 1]
        x1 = (cell % cols) * cw + (u[..., 0] * (cw - bw)).long()
        y1 = (cell // cols) * ch + (u[..., 1] * (ch - bh)).long()
        color = torch.stack([(cls * 97) % 256, (cls * 57 + 80) % 256, (cls * 151 + 40) % 256],
                            -1).to(torch.uint8)
        yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
        xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
        box = torch.stack([x1, y1, x1 + bw, y1 + bh], -1)
        box_np, count_np = box.cpu().numpy(), count.cpu().numpy()
        crops = [[] for _ in range(n)]
        for j in range(k_max):
            cx = (x1[:, j] + bw[:, j] / 2).float()[:, None, None]
            cy = (y1[:, j] + bh[:, j] / 2).float()[:, None, None]
            ell = ((((xx - cx) / (bw[:, j].float()[:, None, None] / 2)) ** 2
                    + ((yy - cy) / (bh[:, j].float()[:, None, None] / 2)) ** 2) <= 1)
            ell &= (j < count)[:, None, None]
            imgs = torch.where(ell[..., None], color[:, j, None, None, :], imgs)
            ell_np = ell.cpu().numpy()
            for i in range(n):
                if j < count_np[i]:
                    bx1, by1, bx2, by2 = box_np[i, j]
                    crops[i].append(ell_np[i, by1:by2 + 1, bx1:bx2 + 1].copy())
        self.hw = (h, w)
        self.images = imgs.cpu().numpy()
        self.crops = crops
        self.boxes = [box_np[i, :count_np[i]].astype(np.float32) for i in range(n)]
        self.labels = [cls[i, :count_np[i]].cpu().numpy() + 1 for i in range(n)]
        self.classes = ("__background__",) + tuple(f"object_{c + 1}" for c in range(classes))
        self.ids = [f"scene_{i:04d}" for i in range(n)]

    def __len__(self):
        return len(self.images)

    def load_image(self, i):
        return self.images[i]

    def get_annotation(self, i):
        return _Anno(self.boxes[i], self.labels[i], self.ids[i])

    def load_masks(self, i, anno=None):
        out = np.zeros((len(self.crops[i]),) + self.hw, np.float32)
        for j, crop in enumerate(self.crops[i]):
            x1, y1, x2, y2 = self.boxes[i][j].astype(int)
            out[j, y1:y2 + 1, x1:x2 + 1] = crop
        return out


def scene_set(traffic: dict, classes: int, seed: int, device) -> SceneSet:
    return SceneSet(traffic["images"], traffic["image_hw"], classes, seed,
                    traffic["object_sides"], traffic["objects"], traffic["grid"], device)
