#!/usr/bin/env python3
"""The JPEG-fed device harvest with and without the canvas prefetcher, with
OpenBLAS's default thread pool and with one OpenBLAS thread, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/prefetch_probe.py

Starts one child process for each OpenBLAS setting (the variable unset, and
``OPENBLAS_NUM_THREADS=1``; OpenBLAS reads it when NumPy loads). Each child
builds the kernels, writes ``chip_smoke.py``'s 64 teaching images as 800x600
JPEGs (quality 95, PIL) and harvests them at batch 8 with the full-width
network of ``chip_smoke.py``: from the images in memory (no decoding), then
from the files with ``prefetch=None`` and ``"threads"`` in the order None,
threads, threads, None, then in memory again. It prints ms per image on the
host clock (synchronised), the process's CPU ms per image (every thread) and
the ms per image the loop waited in ``CanvasLoader.get``, and writes them to
``chiprun_out/prefetch_probe.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = (("memory", None), ("files", None), ("files", "threads"), ("files", "threads"),
        ("files", None), ("memory", None))


def child() -> dict:
    # OpenBLAS reads the variable when NumPy loads: load it first, as this
    # process was started (chip_smoke sets the variable on import)
    tag = os.environ.get("OPENBLAS_NUM_THREADS", "default")
    import numpy  # noqa: F401

    sys.path.insert(0, str(ROOT))
    import shutil

    import torch

    import chip_smoke as cs
    from online_detection_tpu_torch.data.loader import CanvasLoader
    from online_detection_tpu_torch.models.detector import DetectorConfig, init_detector_params
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.pipelines.device_pipeline import harvest_dataset_device
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    _build.build_all(cs.KERNELS)
    for k in cs.KERNELS:
        _build.load(k)
    params = init_detector_params(0, cs.N_ANCHORS, cs.N_CLASSES + 1).cuda()
    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    memory = cs.teaching_set(cs.TRAIN_IMAGES, 0)
    work = ROOT / ".bench" / f"prefetch_probe_{tag}"
    files = cs.JpegTeachingSet(memory, work)
    waits = []
    get = CanvasLoader.get

    def timed_get(self, i):
        t0 = time.perf_counter()
        try:
            return get(self, i)
        finally:
            waits.append(time.perf_counter() - t0)

    CanvasLoader.get = timed_get

    def harvest(ds, mode):
        gen = torch.Generator(device="cuda").manual_seed(0)
        waits.clear()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        harvest_dataset_device(gen, params, ds, cfg, cs.CANVAS, dcfg=dcfg,
                               batch_size=cs.BATCH_SIZE, prefetch=mode)
        torch.cuda.synchronize()
        n = len(ds)
        return {"ms": (time.perf_counter() - t0) / n * 1e3,
                "cpu_ms": (time.process_time() - c0) / n * 1e3,
                "get_ms": sum(waits) / n * 1e3}

    harvest(memory, None)  # warm-up
    out = {"openblas_threads": tag, "card": cs.card_line(), "runs": []}
    try:
        for source, mode in RUNS:
            r = harvest(memory if source == "memory" else files, mode)
            out["runs"].append({"source": source, "prefetch": mode, **r})
            print(f"  OPENBLAS_NUM_THREADS={tag}: {source}, prefetch={mode}: {r['ms']:.3f} ms "
                  f"an image, CPU {r['cpu_ms']:.2f} ms, in get {r['get_ms']:.3f} ms", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main() -> int:
    if os.environ.get("PREFETCH_PROBE_CHILD"):
        print(json.dumps(child()), flush=True)
        return 0
    results = []
    for threads in (None, "1"):
        env = {k: v for k, v in os.environ.items() if k != "OPENBLAS_NUM_THREADS"}
        env["PREFETCH_PROBE_CHILD"] = "1"
        if threads:
            env["OPENBLAS_NUM_THREADS"] = threads
        proc = subprocess.run([sys.executable, __file__], env=env, capture_output=True,
                              text=True, timeout=600)
        print(proc.stdout.rstrip("\n").rsplit("\n", 1)[0], flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "prefetch_probe.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
