"""The ``full_train`` kind: rounds of SGD steps of the whole Mask R-CNN
R-50-C4, one image a step (``engine/trainer.py::do_train``). A round is
one ``do_train`` call of ``steps`` steps that continues the run the
previous call handed back (its ``SGDRun``: iteration, trained tensors,
momentum, image order), so the window measures one training job, not one
restarted each round. Steps run back to back (a closed loop); one untimed
round in set-up warms every shape and starts the run.

The check judges the first step of the window's last round, the step that
uses the state carried across a round boundary: a pass-through on the
names the step calls by module attribute (``StepCapture``) keeps its
uploaded batch, its draws, the RPN's sampled anchors, the proposals and
sampled RoIs, its three loss terms, its gradients and the tensors after
it, and the round's start keeps the state handed to it. The plain
reference (``reference/full_train.py``) takes one IEEE fp32 step from that
state, at the learning rate of the carried iteration.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import scenes, tracing
from benchmark.drivers import derive, measure, sync
from benchmark.reference import full_train as reference
from benchmark.weights import make_weights, to_program

KERNELS = ["stem_pool", "roi_align", "roi_align_backward"]

SOLVER_KEYS = ("base_lr", "momentum", "weight_decay", "warmup_iters", "warmup_factor", "steps",
               "gamma")
CONVS = {"branch2a": "a", "branch2b": "b", "branch2c": "c", "branch1": "branch1"}
HEADS = {"rpn": "rpn", "mask_head": "mask", "box_predictor": "box"}


def ref_name(path: str) -> str:
    """The program's tree path of a tensor -> the reference's name
    (``backbone/res2/0/branch2a/w`` -> ``res2.0.a.w``)."""
    parts = path.split("/")
    if parts[0] != "backbone":
        return f"{HEADS[parts[0]]}.{parts[1]}"
    if parts[1] == "stem":
        return f"stem.{parts[2]}"
    stage, block, conv, leaf = parts[1:]
    return f"{stage}.{block}.{CONVS[conv]}.{leaf}"


class HostDraws:
    """``draws[it]``: step ``it``'s four sampler uniforms (the RPN's
    positives and negatives over the anchors, the box head's over the
    proposals and GT rows), float32 on the host from the run's seed, as a
    CPU generator hands them to the command-line run."""

    def __init__(self, seed: int, n_anchors: int, n_rois: int):
        self.seed, self.sizes = seed, (n_anchors, n_anchors, n_rois, n_rois)

    def __getitem__(self, it: int) -> List[np.ndarray]:
        rng = np.random.default_rng(derive(self.seed, it))
        return [rng.random(n, dtype=np.float32) for n in self.sizes]


class Setup:
    """Weights, scenes, draws and the SGD run of one benchmark run."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from online_detection_tpu_torch.engine.trainer import SGDConfig, SGDRun
        from online_detection_tpu_torch.experiments._common import reinit_predictors

        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, torch.device(device)
        classes = cfg["num_classes"]
        self.w = make_weights(derive(seed, "weights"), self.dev, 15, classes,
                              tuple(cfg["stages"]), tuple(tuple(c) for c in cfg["channels"]))
        self.params = to_program(self.w)
        # the command-line run's output layers for NUM_CLASSES + 1 classes
        reinit_predictors(self.params, classes, cfg["mask_on"])
        self.sgd = SGDConfig(**dict(cfg["sgd"], steps=tuple(cfg["sgd"]["steps"])))
        self.canvas_hw = tuple(mix["canvas_hw"])
        h, w = mix["image_hw"]
        if min(h, w) != cfg["min_size"] or max(h, w) > cfg["max_size"] \
                or h > self.canvas_hw[0] or w > self.canvas_hw[1]:
            # the reference takes the uploaded canvas; no resize is checked
            raise ValueError(f"images of {h}x{w} would be resized under min_size "
                             f"{cfg['min_size']}, max_size {cfg['max_size']}")
        self.scenes = scenes.scene_set(mix, classes, derive(seed, "scenes"), self.dev)
        h16, w16 = self.canvas_hw[0] // 16, self.canvas_hw[1] // 16
        self.draws = HostDraws(derive(seed, "draws"), h16 * w16 * 15,
                               self.sgd.post_nms_train + cfg["gt_cap"])
        self.run = SGDRun()

    def snapshot(self) -> Dict:
        """The state the last round handed back, copied on the device
        (nothing synced): iteration, trained tensors, momentum buffers."""
        run = self.run
        return {"iteration": run.iteration,
                "params": [t.detach().clone() for t in run.trainable],
                "momentum": [None if b is None else b.clone() for b in run.momentum()]}

    def paths(self) -> List[str]:
        """The tree paths of the run's trained tensors, in its order."""
        from online_detection_tpu_torch.engine.trainer import freeze_mask

        mask = freeze_mask(self.run.params, self.sgd)
        return [p for p, keep in mask.items() if keep]

    def round(self, r: int) -> Dict:
        """One round: ``do_train`` for the mix's ``steps`` steps from where the
        run stands, synced."""
        from online_detection_tpu_torch.engine import trainer

        it0 = self.run.iteration
        cfg = self.sgd._replace(max_iter=it0 + self.mix["steps"])
        t0 = time.perf_counter()
        with tracing.span("sgd"):
            _, hist = trainer.do_train(
                self.params, self.scenes, self.canvas_hw, cfg, draws=self.draws,
                with_mask=self.cfg["mask_on"], min_size=self.cfg["min_size"],
                max_size=self.cfg["max_size"], gt_cap=self.cfg["gt_cap"],
                flip_prob=self.cfg["flip_prob"], device=self.dev, run=self.run)
            sync(self.dev)
        return {"round": r, "round_s": time.perf_counter() - t0, "steps": len(hist),
                "first_iteration": it0, "loss": hist[-1]}


class StepCapture:
    """While installed, wraps the names one SGD step calls by module
    attribute (``trainer.training_loss`` and ``sgd_step``, ``losses``' loss
    terms and samplers); armed, it keeps what the next step passes and
    returns, up to its optimizer step. Every call goes through unchanged;
    the gradients are copied before the clip changes them and the tensors
    after the update (device to device, nothing synced), the rest are
    references."""

    HOOKS = (("trainer", "training_loss"), ("trainer", "sgd_step"), ("losses", "rpn_loss"),
             ("losses", "balanced_sample"), ("losses", "sample_rois"),
             ("losses", "box_head_loss"), ("losses", "mask_head_loss"))

    def __init__(self):
        from online_detection_tpu_torch.engine import losses, trainer

        self.modules = {"trainer": trainer, "losses": losses}
        self.real = {name: getattr(self.modules[mod], name) for mod, name in self.HOOKS}
        self.sigs = {name: inspect.signature(fn) for name, fn in self.real.items()}
        self.step, self.armed = {}, False

    def arm(self):
        self.step, self.armed = {"samples": []}, True

    def _through(self, name):
        fn = self.real[name]

        def call(*args, **kwargs):
            if not self.armed:
                return fn(*args, **kwargs)
            a = self.sigs[name].bind(*args, **kwargs).arguments
            step = self.step
            if name == "sgd_step":
                step["grads"] = [torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                                 for t in a["trainable"]]
                out = fn(*args, **kwargs)
                step["after"] = [t.detach().clone() for t in a["trainable"]]
                self.armed = False
                return out
            out = fn(*args, **kwargs)
            if name == "training_loss":
                step.update(batch=a["batch"], uniforms=a.get("uniforms"))
            elif name == "balanced_sample":
                step["samples"].append(out)
            elif name == "sample_rois":
                step.update(sample=out, proposals=(a["proposals"], a["prop_valid"]))
            else:
                step[name] = out.detach()
            return out

        return call

    def __enter__(self):
        for mod, name in self.HOOKS:
            setattr(self.modules[mod], name, self._through(name))
        return self

    def __exit__(self, *exc):
        for mod, name in self.HOOKS:
            setattr(self.modules[mod], name, self.real[name])


def setup(cfg: Dict, mix: Dict, seed: int, dev) -> Setup:
    return Setup(cfg, mix, seed, dev)


def window(setup: Setup, seconds: float, trace: bool) -> Dict:
    setup.round(-1)  # warms every shape of a step and starts the run
    sync(setup.dev)
    t_first = time.time()
    recs: List[Dict] = []
    last = {}

    def unit(i):
        state = setup.snapshot()
        cap.arm()
        recs.append(setup.round(i))
        last.update(state=state, step=cap.step, round=i)

    with StepCapture() as cap:
        win_s, n, prof, traced = measure(seconds, trace, unit, 1)
    return {"t_first": t_first, "window_s": win_s, "units": n, "records": recs,
            "profile": prof, "traced": traced, "e2e": {"teach_s": win_s / n}, "products": last}


def run_fields(setup: Setup, out: Dict) -> Dict:
    return {}


def extra(setup: Setup, out: Dict) -> Dict:
    return {"iterations": setup.run.iteration, "round_loss": [r["loss"] for r in out["records"]]}


# ---------------------------------------------------------------- the check

def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def compare(prog: Dict, ref: Dict, theta: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's readings: ``loss_gap`` (the largest relative gap of the
    three loss terms), ``grad_gap`` (the largest ||dg|| / ||g_ref|| over the
    trained tensors), ``update_gap`` (||d theta'|| over the reference's
    update ||theta'_ref - theta||, all the trained tensors as one vector)
    and ``rpn_sample_off`` (anchors sampled otherwise). The update is judged
    whole: a frozen-BN scale near 1.0 is held in steps of 6e-8, about its
    update, so tensor by tensor one rounding of theta' would read as a gap
    of half the update."""
    loss_gap = max(abs(prog["terms"][k] - v) / max(abs(v), 1e-30) for k, v in ref["terms"].items())
    norms = {k: _norm(g) for k, g in ref["grads"].items()}
    floor = max(float(np.median(list(norms.values()))), 1e-30)
    grad_gap = max(_norm(prog["grads"][k].float() - g) / max(norms[k], floor)
                   for k, g in ref["grads"].items())
    diff = math.hypot(*(_norm(prog["params"][k].float() - v) for k, v in ref["params"].items()))
    update = math.hypot(*(_norm(v - theta[k].float()) for k, v in ref["params"].items()))
    update_gap = diff / max(update, 1e-30)
    off = (prog["rpn_pos"] != ref["rpn_pos"]) | (prog["rpn_neg"] != ref["rpn_neg"])
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap,
            "rpn_sample_off": float(off.sum())}


def roi_sample_off(step: Dict, roi_batch: int) -> float:
    """Sampled RoIs (box, label or positive) that differ from the
    reference's sample of the program's proposals with the same draws."""
    batch, u, s = step["batch"], step["uniforms"], step["sample"]
    boxes, valid = step["proposals"]
    g = int(batch["gt_valid"].sum())
    idx, labels, is_pos = reference.roi_sample(batch["gt_boxes"][:g].float(),
                                               batch["gt_labels"][:g], boxes.float(), valid,
                                               u[2], u[3], batch=roi_batch)
    n_prog = int(s.valid.sum())
    m = min(n_prog, len(idx))
    rows = ((s.boxes[:m].float() != boxes[idx[:m]].float()).any(-1)
            | (s.labels[:m].long() != labels[:m]) | (s.is_pos[:m] != is_pos[:m]))
    return float(int(rows.sum()) + abs(n_prog - len(idx)))


def reference_inputs(step: Dict) -> Dict:
    b, s = step["batch"], step["sample"]
    out = {k: b[k] for k in ("image", "image_size", "gt_boxes", "gt_labels", "gt_valid")}
    if "gt_masks" in b:
        out["gt_masks"] = b["gt_masks"]
    out.update(uniforms=step["uniforms"], roi_boxes=s.boxes, roi_labels=s.labels,
               roi_matched=s.matched_gt, roi_valid=s.valid, roi_pos=s.is_pos)
    return out


def _judged(setup: Setup, products: Dict, tf32_program: bool) -> Dict[str, float]:
    """The readings of one captured step: the program's (or, for the
    control, the reference's in TF32 in its place) against the reference's
    in IEEE fp32."""
    cfg = setup.cfg
    state, step = products["state"], products["step"]
    names = [ref_name(p) for p in setup.paths()]
    theta = dict(zip(names, state["params"]))
    mom = dict(zip(names, state["momentum"]))
    solver = {k: cfg["sgd"][k] for k in SOLVER_KEYS}
    inputs = reference_inputs(step)
    want = reference.sgd_step(theta, mom, inputs, state["iteration"], solver, cfg["mask_on"])
    if tf32_program:
        got = reference.sgd_step(theta, mom, inputs, state["iteration"], solver, cfg["mask_on"],
                                 tf32=True)
    else:
        got = {"terms": {k: float(step[k]) for k in want["terms"]},
               "grads": dict(zip(names, step["grads"])), "params": dict(zip(names, step["after"])),
               "rpn_pos": step["samples"][0][0], "rpn_neg": step["samples"][0][1]}
    out = compare(got, want, theta)
    out["roi_sample_off"] = roi_sample_off(step, cfg["sgd"]["roi_batch"])
    out["iteration"] = float(state["iteration"])
    out["grad_norm"] = math.sqrt(sum(_norm(g) ** 2 for g in want["grads"].values()))
    return out


def check(setup: Setup, out: Dict) -> Dict[str, float]:
    """The numbers compared for this run."""
    return _judged(setup, out["products"], tf32_program=False)


def control(cfg: Dict, mix: Dict, seed: int, side: str, dev) -> Dict[str, float]:
    """The readings of one seed, on the first step of the round after the
    one that starts the run: ``program``, the program's step as a run's
    check judges it (the lower readings); ``control``, the reference's step
    with TF32 allowed (cuBLAS and cuDNN), one precision step below the
    configured IEEE fp32, in the program's place (the upper readings)."""
    s = setup(cfg, mix, seed, dev)
    s.round(-1)
    with StepCapture() as cap:
        state = s.snapshot()
        cap.arm()
        s.round(0)
    return _judged(s, {"state": state, "step": cap.step}, tf32_program=(side == "control"))
