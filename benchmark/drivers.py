"""Set-up and measured window of each kind of traffic mix.

A traffic mix's ``kind`` picks its driver:

- ``teach``: rounds of ``harvest_dataset_device`` over the teaching set,
  then ``train_online_modules_device``, synced. The window closes at the
  first round boundary after ``seconds``.

Each driver returns the window's timings, what the per-layer readers take,
and the products that the check judges. With ``trace`` the first units of
the window run under ``torch.profiler``; the window then goes on until at
least one unit ran outside the trace, whose wall times the readers take.
"""

from __future__ import annotations

import hashlib
import inspect
import time
from typing import Dict, List

import torch

from benchmark import traffic as traffic_mod
from benchmark import tracing
from benchmark.weights import make_weights, to_program


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the run's seed."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def program_configs(cfg: Dict):
    from online_detection_tpu_torch.models.detector import DetectorConfig
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    return OnlineTrainConfig(**cfg["train"]), DetectorConfig(**cfg["detector"])


class Setup:
    """Weights, configurations and the teaching set of one run."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        t = cfg["train"]
        self.w = make_weights(derive(seed, "weights"), self.dev, 15, t["num_classes"],
                              tuple(cfg["stages"]), tuple(tuple(c) for c in cfg["channels"]))
        self.params = to_program(self.w)
        self.tcfg, self.dcfg = program_configs(cfg)
        self.canvas_hw = tuple(mix["canvas_hw"])
        h, w = mix["image_hw"]
        if min(h, w) != cfg["min_size"] or max(h, w) > cfg["max_size"] \
                or h > self.canvas_hw[0] or w > self.canvas_hw[1]:
            # the reference pads the images onto the canvas as they are
            raise ValueError(f"images of {h}x{w} would be resized under min_size "
                             f"{cfg['min_size']}, max_size {cfg['max_size']}")
        self.teach = traffic_mod.teaching_set(mix, t["num_classes"],
                                              derive(seed, "teach"), self.dev)

    def round(self, r: int, keep_state: bool):
        """One teaching round -> (reservoirs or None, models, record)."""
        from online_detection_tpu_torch.pipelines.device_pipeline import (
            harvest_dataset_device, train_online_modules_device)

        gh = torch.Generator(device=self.dev).manual_seed(derive(self.seed, "harvest", r))
        gt = torch.Generator(device=self.dev).manual_seed(derive(self.seed, "train", r))
        t0 = time.perf_counter()
        with tracing.span("harvest"):
            state, meta = harvest_dataset_device(
                gh, self.params, self.teach, self.tcfg, self.canvas_hw, dcfg=self.dcfg,
                min_size=self.cfg["min_size"], max_size=self.cfg["max_size"],
                batch_size=self.mix["batch"], device=self.dev)
            sync(self.dev)
        t1 = time.perf_counter()
        stages: Dict[str, float] = {}
        with tracing.span("train"):
            online = train_online_modules_device(gt, state if keep_state else [state],
                                                 self.tcfg, timings=stages, device=self.dev)
            sync(self.dev)
        t2 = time.perf_counter()
        rec = {"round": r, "harvest_s": t1 - t0, "train_s": sum(stages.values()),
               "stages": stages, "round_s": t2 - t0, "truncation": meta["truncation"]}
        return (state if keep_state else None), online, rec


def _window(seconds: float, trace: bool, unit, units_traced: int):
    """Runs ``unit(i)`` until ``seconds`` have passed at a unit boundary;
    with ``trace`` the first ``units_traced`` units run under the profiler
    and the window holds at least one unit after them. Returns (window
    seconds, units, reduced trace or None, indices of the traced units)."""
    prof_red, traced = None, []
    start = time.perf_counter()
    i = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(units_traced):
                unit(i)
                traced.append(i)
                i += 1
            wall = time.perf_counter() - t0
        prof_red = (prof, wall)
    while True:
        if time.perf_counter() - start >= seconds and i > len(traced):
            break
        unit(i)
        i += 1
    return time.perf_counter() - start, i, prof_red, traced


class HarvestCapture:
    """Keeps, for each canvas batch of the harvest, the boxes its sampling
    ran on (the program's proposals, which the check of the negative pools
    takes as given, and the GT boxes), while installed on the module that
    calls ``harvest_chunks``; the call itself is unchanged. Holds
    references only: nothing is copied or synced."""

    KEEP = ("prop_boxes", "prop_valid", "image_sizes", "gt_boxes", "gt_labels", "gt_valid")
    NAMES = ("props", "pvalid", "sizes", "gt_boxes", "gt_labels", "gt_valid")

    def __init__(self):
        from online_detection_tpu_torch.pipelines import device_pipeline

        self.module, self.fn, self.batches = device_pipeline, device_pipeline.harvest_chunks, []
        self.sig = inspect.signature(self.fn)

    def __call__(self, *args, **kwargs):
        a = self.sig.bind(*args, **kwargs).arguments
        self.batches.append({n: a[k] for n, k in zip(self.NAMES, self.KEEP)})
        return self.fn(*args, **kwargs)

    def __enter__(self):
        self.module.harvest_chunks = self
        return self

    def __exit__(self, *exc):
        self.module.harvest_chunks = self.fn


def teach(setup: Setup, seconds: float, trace: bool) -> Dict:
    setup.round(-1, keep_state=False)  # warms every shape of a round
    sync(setup.dev)
    t_first = time.time()
    recs: List[Dict] = []
    last = {}

    def unit(i):
        last.clear()
        cap.batches.clear()
        state, online, rec = setup.round(i, keep_state=True)
        last.update(state=state, online=online, round=i, batches=list(cap.batches))
        recs.append(rec)

    with HarvestCapture() as cap:
        win_s, n, prof, traced = _window(seconds, trace, unit, 1)
    return {"t_first": t_first, "window_s": win_s, "units": n, "records": recs,
            "profile": prof, "traced": traced,
            "e2e": {"teach_s": win_s / n}, "products": last}


DRIVERS = {"teach": teach}
