#!/usr/bin/env python3
"""Held-out det and segm mAP@0.5 of the on-line detector against the size of
the synthetic objects, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/map_by_object_size.py

For each range of object sides (pixels), teaches the full-width network of
``chip_smoke.py`` (R-50-C4 with random weights from seed 0, the flagship
``OnlineTrainConfig``) on 64 synthetic 800x600 images of that range at
batch 8, then scores ``run_inference`` on those images and on 32 held-out
ones (seed 1), once with the trained on-line RPN and once with the
network's own (random) RPN head. Prints one ``RESULT`` line per range, with
the harvest's average recall and the number of RPN anchor classes trained.

It picked ``chip_smoke.OBJECT_SIDES``: with random trunk weights, what the
on-line RPN can learn to propose depends on the objects' sizes, and over
some ranges it proposes nothing that overlaps a held-out object enough.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RANGES = ((64, 450), (64, 192), (96, 256), (48, 128), (128, 320))


def main() -> int:
    import torch

    import chip_smoke as cs
    from online_detection_tpu_torch.models.detector import (
        DetectorConfig, OnlineModelSet, init_detector_params)
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import (
        OnlineTrainConfig, run_inference)

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    _build.build_all(cs.KERNELS)
    for k in cs.KERNELS:
        _build.load(k)
    print(f"card: {cs.card_line()}", flush=True)
    params = init_detector_params(0, cs.N_ANCHORS, cs.N_CLASSES + 1).cuda()
    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    for lo, hi in RANGES:
        t0 = time.time()
        ds = cs.SyntheticTeachingSet(cs.TRAIN_IMAGES, cs.TRAIN_HW, cs.N_CLASSES, 0, lo, hi)
        held = cs.SyntheticTeachingSet(cs.HELD_OUT_IMAGES, cs.TRAIN_HW, cs.N_CLASSES, 1, lo, hi)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state, meta = harvest_dataset_device(gen, params, ds, cfg, cs.CANVAS, dcfg=dcfg,
                                             batch_size=cs.BATCH_SIZE)
        online = train_online_modules_device(gen, [state], cfg)
        del state
        out = [f"sides {lo}-{hi}: AR {meta['average_recall']:.3f}, rpn classes "
               f"{int(online.rpn.falkon.exists.sum())}"]
        pretrained = OnlineModelSet(None, online.detector, online.mask)
        for tag, models in (("online rpn", online), ("pretrained rpn", pretrained)):
            for name, test in (("train", ds), ("held", held)):
                res, _ = run_inference(params, models, test, cs.CANVAS, dcfg,
                                       batch_size=cs.BATCH_SIZE)
                out.append(f"{tag} {name} det {res['det_map_0.5']:.4f} "
                           f"segm {res['segm_map_0.5']:.4f}")
        print("RESULT", "; ".join(out), f"({time.time() - t0:.1f} s)", flush=True)
        del online, pretrained
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
