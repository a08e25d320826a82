#!/usr/bin/env python3
"""Held-out det and segm mAP@0.5 of the device route against the training
draws, for each trunk dtype, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/map_by_training_draw.py [--seeds 6] [--dtypes bfloat16 float32]
                                          [--root OTHER_CHECKOUT]

For each trunk dtype (``ODTPU_COMPUTE_DTYPE``, one child process each),
harvests ``chip_smoke.py``'s 64 teaching images once (the generator from
seed 0), then trains the flagship heads from those reservoirs with the
generator seeded 1, 2, ... (``--seeds`` draws; the same reservoirs every
time) and scores ``run_inference`` on the 32 held-out images. Prints one
line per dtype with each draw's det and segm mAP@0.5, and which class each
draw's detections take (the detections' most frequent label and its share).
``--root`` imports the port (and ``chip_smoke.py``) from another checkout,
for a side-by-side with an earlier commit. Writes
``chiprun_out/map_by_training_draw.json``.

With random trunk weights and 3 teaching images a class, what a class's
FALKON model learns depends on the draws: one class's model can score over
3 on every proposal and take every detection slot, and det mAP is then 0.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(root: str, seeds: int) -> dict:
    sys.path.insert(0, root)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from online_detection_tpu_torch.engine.device_accumulate import Pool
    from online_detection_tpu_torch.models.detector import DetectorConfig, init_detector_params
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

    def copy_of(state):
        def one(x):
            if isinstance(x, Pool):
                return Pool(x.rows.clone(), x.counts.clone(),
                            None if x.attempted is None else x.attempted.clone())
            return None if x is None else x.clone()
        return state.replace(**{f.name: one(getattr(state, f.name))
                                for f in dataclasses.fields(state)})

    params = init_detector_params(0, cs.N_ANCHORS, cs.N_CLASSES + 1).cuda()
    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state, _ = harvest_dataset_device(gen, params, cs.teaching_set(cs.TRAIN_IMAGES, 0), cfg,
                                      cs.CANVAS, dcfg=dcfg, batch_size=cs.BATCH_SIZE)
    test = cs.teaching_set(cs.HELD_OUT_IMAGES, 1)
    draws = []
    for seed in range(1, seeds + 1):
        online = train_online_modules_device(torch.Generator(device="cuda").manual_seed(seed),
                                             [copy_of(state)], cfg)
        results, preds = run_inference(params, online, test, cs.CANVAS, dcfg,
                                       batch_size=cs.BATCH_SIZE)
        labels = np.concatenate([p["labels"] for p in preds]).astype(int)
        top = int(np.bincount(labels).argmax()) if len(labels) else 0
        draws.append({"seed": seed, "det_map_0.5": results["det_map_0.5"],
                      "segm_map_0.5": results["segm_map_0.5"], "top_label": top,
                      "top_label_share": float((labels == top).mean()) if len(labels) else 0.0})
    return {"root": root, "dtype": os.environ.get("ODTPU_COMPUTE_DTYPE"),
            "card": cs.card_line(), "draws": draws}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.root, args.seeds)), flush=True)
        return 0
    out = []
    for dtype in args.dtypes:
        env = dict(os.environ, ODTPU_COMPUTE_DTYPE=dtype)
        proc = subprocess.run([sys.executable, __file__, "--child", "--seeds", str(args.seeds),
                               "--root", args.root], env=env, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        out.append(rec)
        print(f"{rec['root']} {dtype}: det / segm mAP@0.5 by draw "
              f"{[(d['det_map_0.5'], d['segm_map_0.5']) for d in rec['draws']]}; the "
              f"detections' most frequent label (share) "
              f"{[(d['top_label'], round(d['top_label_share'], 3)) for d in rec['draws']]} "
              f"on {rec['card']}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    name = "map_by_training_draw.json" if args.root == str(ROOT) else \
        "map_by_training_draw_other.json"
    (dest / name).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
