"""The readings each limit in ``limits/`` was set from, at a cell's own size
on the card, several seeds in one process:

- ``program``: one teaching round of the program and the cell's check, as
  a run makes it (the lower readings), with the fault of a refiner left at
  zero read beside it (``rls_gap`` of the program's models with every RLS
  beta zeroed);
- ``control``: the plain reference put in the program's place at the
  nearest precision below the configured one (the trunk in fp8 e4m3 with
  one scale a tensor, the fp32 products in TF32), on the inputs of the
  program's round, judged by the same comparisons (the upper readings).

    python3 benchmark/control.py --workload <name> --side program|control --seeds <n> ...

prints one JSON line a seed. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _round(spec: Dict, workload: str, seed: int, device, overrides: Optional[Dict]):
    from benchmark import drivers
    from benchmark.harness import cell_spec

    _, cfg, mix = cell_spec(spec, workload)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else mix)[key] = val
    setup = drivers.Setup(cfg, mix, seed, device)
    with drivers.HarvestCapture() as cap:
        state, online, _ = setup.round(0, keep_state=True)
    return setup, {"state": state, "online": online, "round": 0, "batches": list(cap.batches)}


def control_answers(setup, batches, rng):
    """The control's negative rows: for each picked batch, image and class,
    as many of the rows the class may take as the program's sampling takes,
    drawn from the seed, with the control's features at them."""
    from benchmark import judge
    from benchmark.reference import forward as ref

    def answers_of(layout, picked):
        out = {}
        b = setup.mix["batch"]
        for k in picked:
            lay, bt = layout["batches"][k], batches[k]
            idx = list(range(k * b, min(k * b + b, len(setup.teach))))
            imgs = torch.from_numpy(judge._canvases(setup.teach, idx, setup.mix["canvas_hw"]))
            boxes = torch.cat([bt["gt_boxes"], bt["props"]], 1).float()[:len(idx)]
            with torch.inference_mode(), ref.fp32_mode(ref.CONTROL):
                c4 = ref.backbone_c4(setup.w, imgs.to(setup.dev), ref.CONTROL)
                feats = torch.cat([ref.box_features(setup.w, c4[i:i + 1], boxes[i:i + 1],
                                                    ref.CONTROL) for i in range(len(idx))])
            for (i, c), n in np.ndenumerate(lay["take"].numpy()):
                if n > 0 and int(lay["start"][i, c]) < layout["cap"]:
                    rows = lay["eligible"][i, c].nonzero()[:, 0].cpu().numpy()
                    pick = torch.from_numpy(rng.choice(rows, size=int(n))).to(feats.device)
                    out[(k, i, c)] = feats[i][pick]
        return out

    return answers_of


def readings(spec: Dict, workload: str, seed: int, side: str, device,
             overrides: Optional[Dict] = None) -> Dict[str, float]:
    from benchmark import drivers, judge
    from benchmark.harness import check
    from benchmark.reference import forward as ref
    from benchmark.reference import train as ref_train

    setup, products = _round(spec, workload, seed, device, overrides)
    cfg, mix, dev = setup.cfg["train"], setup.mix, setup.dev
    if side == "program":
        zeroed = ref.models_of(products["online"])
        pools = ref_train.pools_of(products["state"])
        refm = judge.reference_models(pools, cfg, drivers.derive(seed, "train", 0), dev)
        for head in ("rpn", "detector"):
            if zeroed.get(head) is not None:
                zeroed[head]["rls"] = dict(zeroed[head]["rls"],
                                           beta=torch.zeros_like(zeroed[head]["rls"]["beta"]))
        fault = judge.models_gap(zeroed, refm, judge.probes(pools, cfg, np.random.default_rng(0),
                                                            mix["probe_rows"]))
        out = check(setup, {"products": products})
        out["fault_zero_beta.rls_gap"] = fault["rls_gap"]
        return out
    pools = ref_train.pools_of(products["state"])
    rng = np.random.default_rng(drivers.derive(seed, "check"))
    train_seed = drivers.derive(seed, "train", 0)
    del products["online"]
    low = judge.reference_models(pools, cfg, train_seed, dev, ref.CONTROL)
    refm = judge.reference_models(pools, cfg, train_seed, dev)
    return judge.teach_readings(
        setup.w, setup.teach, mix, cfg, pools, products["batches"], low, refm, rng, dev,
        answers_of=control_answers(setup, products["batches"], rng),
        got_fn=lambda imgs, gb: ref.gt_features(setup.w, imgs, gb, ref.CONTROL))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT))
    from online_detection_tpu_torch.ops import _build

    _build.build_all(["gaussian_mmv", "stem_pool", "roi_align", "roi_align_fused2"])
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for seed in args.seeds:
        t0 = time.time()
        r = readings(spec, args.workload, seed, args.side, "cuda")
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "readings": r, "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
