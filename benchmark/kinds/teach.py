"""The ``teach`` kind: rounds of ``harvest_dataset_device`` over the teaching
set, then ``train_online_modules_device``, synced. The window closes at
the first round boundary after ``seconds``; the check judges its last
round (``judge.teach_readings``).
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import judge, tracing
from benchmark import traffic as traffic_mod
from benchmark.drivers import derive, measure, sync
from benchmark.reference import forward as ref
from benchmark.reference import train as ref_train
from benchmark.weights import make_weights, to_program

KERNELS = ["gaussian_mmv", "stem_pool", "roi_align", "roi_align_fused2"]


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


def setup(cfg: Dict, mix: Dict, seed: int, dev) -> Setup:
    # the pools' saturation is recorded in the result (``extra``), not logged
    logging.getLogger("online_detection_tpu_torch.device_pipeline").setLevel(logging.ERROR)
    return Setup(cfg, mix, seed, dev)


def window(setup: Setup, seconds: float, trace: bool) -> Dict:
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
        win_s, n, prof, traced = measure(seconds, trace, unit, 1)
    return {"t_first": t_first, "window_s": win_s, "units": n, "records": recs,
            "profile": prof, "traced": traced,
            "e2e": {"teach_s": win_s / n}, "products": last}


def pool_rows(state) -> Dict[str, int]:
    """Valid rows of the pools the counts of the training need (a host read
    after the window)."""
    return {"coxy": int(state.det_coxy.counts.sum()),
            "rpn_pos": 0 if state.rpn_pos is None else int(state.rpn_pos.counts.sum()),
            "det_neg_fill": [int(c) for c in state.det_neg.counts.tolist()]}


def run_fields(setup: Setup, out: Dict) -> Dict:
    return {"pools": pool_rows(out["products"]["state"])}


def extra(setup: Setup, out: Dict) -> Dict:
    return {"pool_fill": pool_rows(out["products"]["state"])["det_neg_fill"],
            "truncation": out["records"][-1]["truncation"]}


def check(setup: Setup, out: Dict) -> Dict[str, float]:
    """The numbers compared for this run (see ``judge.py``)."""
    seed, dev, cfg, mix = setup.seed, setup.dev, setup.cfg, setup.mix
    rng = np.random.default_rng(derive(seed, "check"))
    p = out["products"]
    pools = ref_train.pools_of(p["state"])
    prog = ref.models_of(p["online"])
    del p["online"]
    refm = judge.reference_models(pools, cfg["train"], derive(seed, "train", p["round"]), dev)
    return judge.teach_readings(setup.w, setup.teach, mix, cfg["train"], pools, p["batches"],
                                prog, refm, rng, dev)


# ---------------------------------------------------------------- the control

def _first_round(cfg: Dict, mix: Dict, seed: int, dev):
    """One teaching round of the program, as a run's window makes it ->
    (set-up, the products its check takes)."""
    s = setup(cfg, mix, seed, dev)
    with HarvestCapture() as cap:
        state, online, _ = s.round(0, keep_state=True)
    return s, {"state": state, "online": online, "round": 0, "batches": list(cap.batches)}


def control_answers(setup: Setup, batches, rng):
    """The control's negative rows: for each picked batch, image and class,
    as many of the rows the class may take as the program's sampling takes,
    drawn from the seed, with the control's features at them."""

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


def control(cfg: Dict, mix: Dict, seed: int, side: str, dev) -> Dict[str, float]:
    """The readings of one seed, on one teaching round:

    - ``program``: the round's check, as a run makes it (the lower
      readings), with the fault of a refiner left at zero read beside it
      (``rls_gap`` of the program's models with every RLS beta zeroed);
    - ``control``: the plain reference put in the program's place at the
      nearest precision below the configured one (the trunk in fp8 e4m3
      with one scale a tensor, the fp32 products in TF32), on the inputs of
      the program's round, judged by the same comparisons (the upper
      readings).
    """
    s, products = _first_round(cfg, mix, seed, dev)
    tcfg, dev = s.cfg["train"], s.dev
    if side == "program":
        zeroed = ref.models_of(products["online"])
        pools = ref_train.pools_of(products["state"])
        refm = judge.reference_models(pools, tcfg, derive(seed, "train", 0), dev)
        for head in ("rpn", "detector"):
            if zeroed.get(head) is not None:
                zeroed[head]["rls"] = dict(zeroed[head]["rls"],
                                           beta=torch.zeros_like(zeroed[head]["rls"]["beta"]))
        fault = judge.models_gap(zeroed, refm, judge.probes(pools, tcfg, np.random.default_rng(0),
                                                            mix["probe_rows"]))
        out = check(s, {"products": products})
        out["fault_zero_beta.rls_gap"] = fault["rls_gap"]
        return out
    pools = ref_train.pools_of(products["state"])
    rng = np.random.default_rng(derive(seed, "check"))
    train_seed = derive(seed, "train", 0)
    del products["online"]
    low = judge.reference_models(pools, tcfg, train_seed, dev, ref.CONTROL)
    refm = judge.reference_models(pools, tcfg, train_seed, dev)
    return judge.teach_readings(
        s.w, s.teach, mix, tcfg, pools, products["batches"], low, refm, rng, dev,
        answers_of=control_answers(s, products["batches"], rng),
        got_fn=lambda imgs, gb: ref.gt_features(s.w, imgs, gb, ref.CONTROL))
