"""The device mesh across the cards of one host: ``chip_smoke.py``'s mesh
phase on ``make_mesh(n)``, one entry a card, each slice on its own card.

    python3 tools/mesh_cards.py [--cards N] [--seed S]   # default: every card

Builds the kernels, makes the flagship's full-width network from the seed,
and runs ``chip_smoke.mesh_phase`` on the mesh: the harvest of the 64
teaching images with each canvas batch split over the cards, the training
with every head's classes and the grouped RLS split over them, and
``run_inference`` on the 32 held-out images split over them. It holds what
the smoke's phase holds (reservoirs bit-identical to the unsharded
harvest's with the trunk in the same slices, FALKON scores equal to the
unsharded training's at the per-card class chunk, mAPs within its tolerance of the
unsharded run's at the per-card batch, one launch a kernel a slice), holds
the trained models equal to those of the same mesh with every entry on the
first card (the unsharded run's RLS, solved in one batch, is printed
beside), and prints each stage's seconds on the mesh beside the unsharded
run's on the first card, after one warm-up harvest batch on the mesh.
Writes ``chiprun_out/mesh_cards.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from online_detection_tpu_torch.models.detector import init_detector_params
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.parallel.mesh import make_mesh

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: this tool needs CUDA cards")
    mesh = make_mesh(args.cards)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print(f"mesh {[str(d) for d in mesh.devices]} on {cards[:mesh.size]}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.time()
    _build.build_all(chip_smoke.KERNELS)
    print(f"built {len(chip_smoke.KERNELS)} kernels in {time.time() - t0:.1f} s", flush=True)
    params = init_detector_params(args.seed, chip_smoke.N_ANCHORS,
                                  chip_smoke.N_CLASSES + 1).to(mesh.first)
    # each card's first trunk call initialises its libraries: not timed
    from online_detection_tpu_torch.pipelines.device_pipeline import harvest_dataset_device
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    t0 = time.time()
    harvest_dataset_device(torch.Generator(device="cuda").manual_seed(args.seed), params,
                           chip_smoke.teaching_set(chip_smoke.BATCH_SIZE, args.seed),
                           OnlineTrainConfig(), chip_smoke.CANVAS,
                           batch_size=chip_smoke.BATCH_SIZE, mesh=mesh)
    print(f"warm-up harvest of one batch on the mesh: {time.time() - t0:.1f} s", flush=True)
    report = {}
    paths = chip_smoke.mesh_phase(params, None, args.seed, cards[0], report, mesh=mesh)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_cards.json").write_text(json.dumps(
        {"cards": cards[:mesh.size], "mesh": report["mesh"], "launches": paths}, indent=1))
    print(json.dumps({"ok": True, "cards": mesh.size}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
