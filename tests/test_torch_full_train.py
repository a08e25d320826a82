"""The port's SGD step of the whole Mask R-CNN against the benchmark's plain
fp32 reference (``benchmark/reference/full_train.py``), the resumable
``do_train`` and its spans, on the CPU at a tiny size: one block a stage at
narrow widths, 64x96 canvases of 3-5 objects, ``roi_batch`` 64, weights
from a seed.

- ``training_loss``'s three terms within 1e-5 relative of the reference's,
  given the same proposals, sampled RoIs and draws; every tensor's autograd
  gradient within 1e-4 of the reference's (its norm, the median tensor's
  norm the floor: fp32 sums in other orders); the RPN's sampled anchors and
  the box head's sampled RoIs exactly the reference's;
- one ``do_train`` step's update, and the next call's first step (momentum
  and iteration carried), within 1e-5 of the reference's update (all the
  tensors as one vector);
- the resume contract: two calls of 2 steps give the parameters, loss
  history and momentum of one call of 4, bit for bit;
- the ``sgd`` spans and counters under a profiler, none without one, and
  the same step either way."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import kind_of
from benchmark.reference import full_train as reference
from benchmark.scenes import SceneSet
from benchmark.weights import make_weights, to_program
from online_detection_tpu_torch.engine import trainer
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.heads import BoxPredictor
from online_detection_tpu_torch.utils import telemetry

torch.set_num_threads(2)

CANVAS = (64, 96)
SIZES = dict(min_size=64, max_size=96, gt_cap=8)
CHANNELS = ((8, 32), (8, 32), (16, 64), (16, 128))
N_CLS = 6
SGD = dict(base_lr=0.01, warmup_iters=3, roi_batch=64, post_nms_train=30)
SPANS = ["sgd.batch", "sgd.upload", "sgd.forward", "sgd.backward", "sgd.step", "sgd.loss_read"]

KIND = kind_of("full_train")


def tiny_params(seed=5):
    """Seeded narrow weights, BN affines away from identity, with box
    predictors for N_CLS + 1 classes."""
    g = torch.Generator().manual_seed(seed)
    w = make_weights(seed, "cpu", 15, N_CLS, (1, 1, 1, 1), CHANNELS)
    for stage in ("res2", "res3", "res4", "res5"):
        for blk in w[stage]:
            for conv in ("a", "b", "c", "branch1"):
                p = blk[conv]
                p["scale"].mul_(1.0 + 0.2 * torch.rand(p["scale"].shape, generator=g))
                p["bias"].add_(0.05 * torch.randn(p["bias"].shape, generator=g))
    params = to_program(w)
    c5, k = CHANNELS[3][1], N_CLS + 1
    params.box_predictor = BoxPredictor(0.05 * torch.randn(c5, k, generator=g), torch.zeros(k),
                                        0.01 * torch.randn(c5, 4 * k, generator=g),
                                        torch.zeros(4 * k))
    return params


def scenes(n=4):
    return SceneSet(n, CANVAS, N_CLS, 11, (12, 28), (3, 5), (2, 3), "cpu")


def draws():
    n_anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    return KIND.HostDraws(7, n_anchors, SGD["post_nms_train"] + SIZES["gt_cap"])


def train(params, ds, steps, run=None, **kw):
    cfg = trainer.SGDConfig(max_iter=steps, **SGD)
    return trainer.do_train(params, ds, CANVAS, cfg, with_mask=kw.pop("with_mask", True),
                            log_every=100, device="cpu", run=run, **SIZES,
                            **({"draws": draws()} if "generator" not in kw else {}), **kw)


def names_of(run):
    mask = trainer.freeze_mask(run.params, trainer.SGDConfig(**SGD))
    return [KIND.ref_name(p) for p, keep in mask.items() if keep]


def solver():
    cfg = trainer.SGDConfig(**SGD)._asdict()
    return {k: cfg[k] for k in KIND.SOLVER_KEYS}


# ---------------------------------------------------------------- against the reference

@pytest.mark.parametrize("with_mask", [True, False], ids=["masks", "no_masks"])
def test_training_loss_and_gradients_match_the_reference(with_mask):
    params, ds = tiny_params(), scenes()
    dev = torch.device("cpu")
    net, trainable = trainer.trainable_copy(params, dev, trainer.SGDConfig(**SGD))
    anchors_np = grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)
    host = trainer.host_batch(ds, 1, CANVAS, 64, 96, SIZES["gt_cap"], anchors_np, with_mask,
                               0.0, np.random.default_rng(0), False)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    uniforms = [torch.from_numpy(u) for u in draws()[0]]
    theta = [t.detach().clone() for t in trainable]
    with KIND.StepCapture() as cap:
        cap.arm()
        loss = trainer.training_loss(net, batch, torch.from_numpy(anchors_np),
                                     trainer.SGDConfig(**SGD), with_mask, uniforms)
        loss.backward()
    step = dict(cap.step, batch=batch, uniforms=uniforms)
    names = [KIND.ref_name(p) for p, _ in trainer.named_leaves(net)]
    want = reference.sgd_step(dict(zip(names, theta)), {}, KIND.reference_inputs(step), 0,
                              solver(), with_mask)
    terms = reference.TERMS if with_mask else reference.TERMS[:2]
    assert sorted(want["terms"]) == sorted(terms)
    for k in terms:
        np.testing.assert_allclose(float(step[k]), want["terms"][k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), sum(want["terms"].values()), rtol=1e-5)
    got = {n: torch.zeros_like(t) if t.grad is None else t.grad for n, t in zip(names, trainable)}
    norms = {n: float(g.double().norm()) for n, g in want["grads"].items()}
    floor = float(np.median(list(norms.values())))
    for n, g in want["grads"].items():
        assert float((got[n] - g).double().norm()) <= 1e-4 * max(norms[n], floor), n
    # the mask head learns only from the mask loss
    assert (norms["mask.logits_w"] > 0) == with_mask
    pos, neg = step["samples"][0]
    assert torch.equal(pos, want["rpn_pos"]) and torch.equal(neg, want["rpn_neg"])
    assert KIND.roi_sample_off(step, SGD["roi_batch"]) == 0


def test_do_train_updates_match_the_reference_across_calls():
    """The first step of a run (no momentum, iteration 0) and the first step
    of the next call (momentum and iteration carried by the ``SGDRun``)."""
    params, ds = tiny_params(), scenes()
    run = trainer.SGDRun()
    for steps in (1, 2):
        state = {"iteration": run.iteration,
                 "params": [t.detach().clone() for t in run.trainable],
                 "momentum": [None if b is None else b.clone() for b in run.momentum()]}
        with KIND.StepCapture() as cap:
            cap.arm()
            train(params, ds, steps, run=run)
        if steps == 1:  # the run started from the caller's tensors
            state["params"] = [t.detach().clone() for _, t in trainer.named_leaves(params)]
            state["momentum"] = [None] * len(state["params"])
        names = names_of(run)
        theta = dict(zip(names, state["params"]))
        want = reference.sgd_step(theta, dict(zip(names, state["momentum"])),
                                  KIND.reference_inputs(cap.step), state["iteration"], solver())
        assert want["lr"] == pytest.approx(trainer.lr_schedule(trainer.SGDConfig(**SGD))(
            state["iteration"]), rel=1e-6)
        got = dict(zip(names, cap.step["after"]))
        gap = KIND.compare({"terms": {k: float(cap.step[k]) for k in reference.TERMS},
                            "grads": dict(zip(names, cap.step["grads"])), "params": got,
                            "rpn_pos": cap.step["samples"][0][0],
                            "rpn_neg": cap.step["samples"][0][1]}, want, theta)
        assert gap["loss_gap"] < 1e-5 and gap["grad_gap"] < 1e-4, gap
        assert gap["update_gap"] < 1e-5 and gap["rpn_sample_off"] == 0, gap
    assert run.iteration == 2 and all(b is not None for b in run.momentum())


# ---------------------------------------------------------------- resuming a run

@pytest.mark.parametrize("source", ["draws", "generator"])
def test_two_calls_of_two_steps_are_one_call_of_four(source):
    params, ds = tiny_params(), scenes()

    def kw():
        return {"generator": torch.Generator().manual_seed(3)} if source == "generator" else {}

    whole = trainer.SGDRun()
    gen = kw()
    p4, h4 = train(params, ds, 4, run=whole, **gen)
    halves = trainer.SGDRun()
    gen = kw()
    p2, h2a = train(params, ds, 2, run=halves, **gen)
    assert halves.iteration == 2 and p2 is halves.params
    p2b, h2b = train(None, ds, 4, run=halves, **gen)  # params are not read once started
    assert p2b is p2 and halves.iteration == whole.iteration == 4
    assert h2a + h2b == h4 and len(h4) == 4
    for (path, a), (_, b) in zip(trainer.named_leaves(p4), trainer.named_leaves(p2b)):
        assert torch.equal(a, b) and not b.requires_grad, path
    for a, b in zip(whole.momentum(), halves.momentum()):
        assert torch.equal(a, b)
    # the caller's tensors are untouched
    for (path, a), (_, b) in zip(trainer.named_leaves(params),
                                 trainer.named_leaves(tiny_params())):
        assert torch.equal(a, b), path


def test_without_a_run_each_call_starts_afresh():
    params, ds = tiny_params(), scenes()
    _, first = train(params, ds, 2)
    _, again = train(params, ds, 2)
    assert first == again


# ---------------------------------------------------------------- spans and counters

def _traced(traced):
    telemetry._RECORDS.clear()
    run = trainer.SGDRun()
    params, ds = tiny_params(), scenes()
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, hist = train(params, ds, 2, run=run)
        names = {e.name for e in prof.events()}
    else:
        _, hist = train(params, ds, 2, run=run)
        names = set()
    tree = telemetry.last_root("sgd")
    telemetry._RECORDS.clear()
    return hist, [t.detach().clone() for t in run.trainable], tree, names, ds


def test_sgd_spans_and_counters_under_a_profiler_and_none_without():
    hist0, params0, tree0, _, _ = _traced(False)
    assert tree0 == []
    hist1, params1, tree, names, ds = _traced(True)
    assert hist0 == hist1
    assert all(torch.equal(a, b) for a, b in zip(params0, params1))

    root = tree[0]
    assert root.name == "sgd" and root.parent is None
    assert root.counts == {"sgd.steps": 2}
    steps = [r.name for r in tree[1:] if r.parent == root.index]
    assert steps == SPANS * 2
    assert {"odtpu::" + n for n in ["sgd"] + SPANS} <= names
    uploads = [r for r in tree if r.name == "sgd.upload"]
    order = np.random.default_rng(0).permutation(len(ds))
    assert [r.counts for r in uploads] == [{"sgd.gt_masks": len(ds.boxes[order[i]])}
                                            for i in range(2)]
    forwards = [r for r in tree if r.name == "sgd.forward"]
    assert all(r.counts.get("nms.sweeps", 0) >= 1 for r in forwards)
    assert all(not r.counts for r in tree if r.name not in ("sgd", "sgd.upload", "sgd.forward"))
