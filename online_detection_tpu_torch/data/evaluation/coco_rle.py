"""COCO compressed-RLE mask encoding, pure numpy (a copy of the JAX package's
``data/evaluation/coco_rle.py``).

A numpy equivalent of the one pycocotools surface the reference's shipped
code reaches: ``MaskPostProcessorCOCOFormat``
(``mrcnn_modified/modeling/roi_heads/mask_head/inference.py:64-85``) encodes
each detection's binarized mask with ``mask_util.encode(np.array(mask[0, :,
:, np.newaxis], order="F"))[0]`` into ``{"size": [H, W], "counts": bytes}``.
pycocotools is a C extension (SURVEY.md §2.3); this module reimplements its
compressed-RLE wire format from the spec so the framework has zero native
eval deps:

- runs are counted in COLUMN-MAJOR (Fortran) scan order, first count is the
  number of leading zeros (possibly 0);
- counts are serialized with pycocotools' 5-bit variable-length signed
  encoding (``maskApi.c rleToString``): counts at index >= 2 are
  difference-coded against ``counts[i-2]``, each value emitted low-5-bits
  first with a 0x20 continuation flag, chars offset by 48 (printable ASCII
  '0'..'o').

Round-trip (`rle_encode`/`rle_decode`) is exact; `tests/test_coco_rle.py`
pins handcrafted goldens of the wire format in the JAX package, and
`tests/test_torch_eval_datasets.py` holds this copy to it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> List[int]:
    """Column-major run lengths, leading-zero count first."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.nonzero(np.diff(flat))[0]
    runs = np.diff(np.concatenate([[-1], change, [flat.size - 1]]))
    counts = runs.tolist()
    if flat[0] == 1:  # first count is ALWAYS the zero-run (may be 0)
        counts.insert(0, 0)
    return [int(c) for c in counts]


def _counts_to_string(counts: List[int]) -> bytes:
    """pycocotools rleToString: 5-bit groups, 0x20 continuation, +48."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5  # Python >> is arithmetic: sign-extends negatives
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def _counts_from_string(s: bytes) -> List[int]:
    """pycocotools rleFrString inverse of :func:`_counts_to_string`."""
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_encode(mask: np.ndarray) -> Dict:
    """Binary [H, W] mask -> ``{"size": [H, W], "counts": bytes}`` in
    pycocotools' compressed format."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _counts_to_string(_counts_from_mask(mask))}


def rle_decode(rle: Dict) -> np.ndarray:
    """Inverse of :func:`rle_encode` -> uint8 [H, W] mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, bytearray)):
        counts = _counts_from_string(bytes(counts))
    flat = np.zeros((h * w,), np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def rle_area(rle: Dict) -> int:
    """Foreground pixel count straight from the counts (no decode)."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, bytearray)):
        counts = _counts_from_string(bytes(counts))
    return int(sum(counts[1::2]))


def masks_to_coco_format(
    mask_probs: np.ndarray,  # [N, H, W] probabilities (pasted to image size)
    labels: np.ndarray,  # [N]
    scores: np.ndarray,  # [N]
    image_id,
    threshold: float = 0.5,
) -> List[Dict]:
    """Per-detection COCO result dicts — the
    ``MaskPostProcessorCOCOFormat.forward`` contract
    (``mask_head/inference.py:64-85``): binarize at ``threshold`` and RLE-
    encode each mask; category/score ride along for a COCO-style results
    JSON (counts decoded to str for JSON transport, as pycocotools users
    do)."""
    out = []
    for i in range(len(labels)):
        rle = rle_encode(np.asarray(mask_probs[i]) > threshold)
        out.append({
            "image_id": image_id,
            "category_id": int(labels[i]),
            "score": float(scores[i]),
            "segmentation": {
                "size": rle["size"],
                "counts": rle["counts"].decode("ascii"),
            },
        })
    return out
