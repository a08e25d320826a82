"""The readings each limit in ``limits/`` was set from, at a cell's own size
on the card, several seeds in one process: ``--side program``, the
program's readings (the lower ones), and ``--side control``, the plain
reference one precision step below the configured one in the program's
place (the upper ones). The cell's kind (``kinds/<kind>.py::control``)
says what each side runs.

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

import torch

ROOT = Path(__file__).resolve().parent.parent


def readings(spec: Dict, workload: str, seed: int, side: str, device,
             overrides: Optional[Dict] = None) -> Dict[str, float]:
    from benchmark.harness import cell_spec, kind_of

    _, cfg, mix = cell_spec(spec, workload)
    for key, val in (overrides or {}).items():
        (cfg if key in cfg else mix)[key] = val
    return kind_of(mix["kind"]).control(cfg, mix, seed, side, device)


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
    from benchmark.harness import cell_spec, kind_of
    from online_detection_tpu_torch.ops import _build

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _build.build_all(kind_of(cell_spec(spec, args.workload)[2]["kind"]).KERNELS)
    for seed in args.seeds:
        t0 = time.time()
        r = readings(spec, args.workload, seed, args.side, "cuda")
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "readings": r, "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
