"""The port's SGD trainer (``online_detection_tpu_torch/engine/trainer.py``)
against the JAX package's, on the CPU, with the JAX samplers' draws injected
into the port's:

- ``training_loss`` and its gradient on every leaf at the same params and
  draws, full channel width on a 128x192 canvas, ``roi_batch`` 32,
  ``post_nms_train`` 30, with and without masks. The loss within 1e-5
  relative; each leaf's gradient within 2e-3 of that leaf's largest
  magnitude: fp32 sums in other orders through 50 conv layers move the res5
  gradients by up to 3.5e-4 of their scale;
- ``do_train`` for 3 steps on a narrow network: the loss histories within
  1e-4 relative (the same images, draws and optimizer on both sides);
- the horizontal flip: the same step inputs as the JAX package builds, and
  loss histories that agree with ``flip_prob`` 1;
- ``freeze_mask`` against the JAX mask leaf for leaf; frozen tensors are
  unchanged after training and the caller's params are untouched;
- ``parse_time_budget``, ``lr_schedule`` and the optimizer step (clip, decay,
  momentum) against optax's on the same gradients;
- each package reads the other's pickled ``model_final`` tree."""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from online_detection_tpu.data.datasets.icubworld import ICubWorldDataset as JDataset
from online_detection_tpu.engine import trainer as jt
from online_detection_tpu.models.detector import init_detector_params as jinit
from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.engine import trainer as pt
from online_detection_tpu_torch.experiments.run_experiment_test_feature_task import (
    load_any_checkpoint,
)
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.weights import params_from_jax, tree_from_params
from tests.test_torch_weights import r50_narrow_tree

torch.set_num_threads(2)

CANVAS = (128, 192)
SIZES = dict(min_size=128, max_size=320)
GT_CAP = 20
N_CLS = 20  # the synthetic tree's dataset has 20 classes besides the background
SMALL = dict(post_nms_train=30, roi_batch=32)
# do_train's config on both sides (one compiled JAX step serves every test)
TRAIN_KW = dict(base_lr=0.005, warmup_iters=2, **SMALL)


def jax_draws(key, n_anchors, n_rois):
    """The four uniform vectors one JAX ``training_loss(key)`` draws: the RPN
    sampler's and the RoI sampler's positives and negatives."""
    k_rpn, k_roi, _ = jax.random.split(key, 3)
    out = []
    for k, n in ((k_rpn, n_anchors), (k_roi, n_rois)):
        kp, kn = jax.random.split(k)
        out += [np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))]
    return out


def step_draws(key, steps, post_nms_train):
    """``do_train``'s draws: step ``it`` uses ``fold_in(key, it)``."""
    n_anchors = (CANVAS[0] // 16) * (CANVAS[1] // 16) * 15
    return [jax_draws(jax.random.fold_in(key, it), n_anchors, post_nms_train + GT_CAP)
            for it in range(steps)]


def full_width_tree():
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), 15, N_CLS + 1))
    tree["box_predictor"] = {
        "cls_w": rng.normal(0, 0.01, (2048, N_CLS + 1)).astype(np.float32),
        "cls_b": np.zeros(N_CLS + 1, np.float32),
        "bbox_w": rng.normal(0, 0.001, (2048, 4 * (N_CLS + 1))).astype(np.float32),
        "bbox_b": np.zeros(4 * (N_CLS + 1), np.float32)}
    return tree


def grad_tree(params):
    """Each tensor's gradient (zeros where there is none) in the JAX tree."""
    g = copy.deepcopy(params)
    for m, mg in zip(params.modules(), g.modules()):
        for name, t in m._buffers.items():
            if t is not None:
                mg._buffers[name] = (torch.zeros_like(t) if t.grad is None else t.grad).detach()
    return tree_from_params(g)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sgd") / "ycbv_synth")
    make_synthetic_icwt(root, n_train=3, n_test=1)
    return root


@pytest.mark.parametrize("with_mask", [True, False])
def test_training_loss_gradients_match_jax(synth, with_mask):
    ds = ICubWorldDataset(synth, "Main", "train")
    anchors = grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)
    host = pt.host_batch(ds, 0, CANVAS, 128, 320, GT_CAP, anchors, with_mask, 0.0,
                          np.random.default_rng(0), False)
    tree = full_width_tree()
    key = jax.random.key(1)
    jcfg = jt.SGDConfig(**SMALL)
    jloss, jgrad = jax.value_and_grad(lambda p: jt.training_loss(
        p, key, {k: jnp.asarray(v) for k, v in host.items()}, jnp.asarray(anchors), jcfg,
        with_mask))(jax.tree_util.tree_map(jnp.asarray, tree))

    cfg = pt.SGDConfig(**SMALL)
    params, trainable = pt.trainable_copy(params_from_jax(tree), torch.device("cpu"), cfg)
    assert len(trainable) == len(pt.named_leaves(params))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
    draws = jax_draws(key, anchors.shape[0], SMALL["post_nms_train"] + GT_CAP)
    loss = pt.training_loss(params, batch, torch.from_numpy(anchors), cfg, with_mask,
                            [torch.from_numpy(d) for d in draws])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got, want = flat(grad_tree(params)), flat(jgrad)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        scale = np.abs(w).max()
        np.testing.assert_allclose(got[path], w, rtol=0, atol=2e-3 * scale + 1e-12,
                                   err_msg=path)
    # the mask head has a gradient only when the loss has masks
    assert (np.abs(got["['mask_head']['logits_w']"]).max() > 0) == with_mask


def narrow_setup(synth):
    tree = r50_narrow_tree(seed=3, n_cls=N_CLS)
    return tree, ICubWorldDataset(synth, "Main", "train"), JDataset(synth, "Main", "train")


def both_do_train(synth, steps, cfg_kw, with_mask=True, flip_prob=0.0):
    tree, pds, jds = narrow_setup(synth)
    key = jax.random.key(2)
    jparams, jhist = jt.do_train(jax.tree_util.tree_map(jnp.asarray, tree), jds, CANVAS,
                                 jt.SGDConfig(max_iter=steps, **cfg_kw), key,
                                 with_mask=with_mask, log_every=100, flip_prob=flip_prob, **SIZES)
    start = params_from_jax(tree)
    before = tree_from_params(start)
    params, hist = pt.do_train(start, pds, CANVAS, pt.SGDConfig(max_iter=steps, **cfg_kw),
                               draws=step_draws(key, steps, cfg_kw["post_nms_train"]),
                               with_mask=with_mask, log_every=100, flip_prob=flip_prob,
                               device="cpu", **SIZES)
    # the caller's params are untouched
    for path, v in flat(tree_from_params(start)).items():
        np.testing.assert_array_equal(v, flat(before)[path], err_msg=path)
    return (jparams, jhist), (params, hist), tree


def test_do_train_loss_history_matches_jax(synth, tmp_path):
    (jparams, jhist), (params, hist), tree = both_do_train(synth, 3, TRAIN_KW)
    assert len(hist) == len(jhist) == 3 and np.isfinite(hist).all()
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)
    assert all(not t.requires_grad and t.grad is None for _, t in pt.named_leaves(params))
    # every leaf moved (nothing is frozen), as the JAX package's did
    start = flat(tree)
    moved = {p: not np.array_equal(v, start[p]) for p, v in flat(tree_from_params(params)).items()}
    assert all(moved.values()), [p for p, m in moved.items() if not m]

    # each package reads the other's pickled model_final tree
    port_pkl, jax_pkl = tmp_path / "model_port.pkl", tmp_path / "model_jax.pkl"
    with open(port_pkl, "wb") as f:
        pickle.dump(tree_from_params(params), f)
    with open(jax_pkl, "wb") as f:
        pickle.dump(jax.device_get(jparams), f)
    with open(port_pkl, "rb") as f:  # as the JAX tester reads it
        from_port = pickle.load(f)
    assert (jax.tree_util.tree_structure(from_port)
            == jax.tree_util.tree_structure(jax.device_get(jparams)))
    for path, v in flat(from_port).items():
        np.testing.assert_array_equal(v, flat(tree_from_params(params))[path])
    for path, v in flat(tree_from_params(load_any_checkpoint(str(jax_pkl)))).items():
        np.testing.assert_array_equal(v, flat(jax.device_get(jparams))[path])


def test_flip_matches_jax(synth):
    tree, pds, _ = narrow_setup(synth)
    anchors = grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)
    plain = pt.host_batch(pds, 0, CANVAS, 128, 320, GT_CAP, anchors, True, 0.0,
                           np.random.default_rng(0), False)
    flipped = pt.host_batch(pds, 0, CANVAS, 128, 320, GT_CAP, anchors, True, 1.0,
                             np.random.default_rng(0), False)
    sw, sh = plain["image_size"].astype(int)
    np.testing.assert_array_equal(flipped["image"][:sh, :sw], plain["image"][:sh, :sw][:, ::-1])
    np.testing.assert_array_equal(flipped["image"][:, sw:], plain["image"][:, sw:])
    np.testing.assert_array_equal(flipped["gt_masks"][:, :sh, :sw],
                                  plain["gt_masks"][:, :sh, :sw][:, :, ::-1])
    g = int(plain["gt_valid"].sum())
    np.testing.assert_array_equal(flipped["gt_boxes"][:g, 0], sw - 1 - plain["gt_boxes"][:g, 2])
    np.testing.assert_array_equal(flipped["gt_boxes"][:g, 2], sw - 1 - plain["gt_boxes"][:g, 0])

    (_, jhist), (_, hist), _ = both_do_train(synth, 2, TRAIN_KW, flip_prob=1.0)
    np.testing.assert_allclose(hist, jhist, rtol=1e-4)


@pytest.mark.parametrize("flags", [(True, False, False), (True, True, False), (False, True, True),
                                   (True, True, True), (False, False, False)])
def test_freeze_mask_matches_jax(flags):
    tree = r50_narrow_tree(seed=0, n_cls=4)
    names = ("freeze_backbone", "freeze_rpn_except_logits", "freeze_heads_except_predictor")
    kw = dict(zip(names, flags))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): float(v)
            for p, v in jax.tree_util.tree_flatten_with_path(
                jt.freeze_mask(tree, jt.SGDConfig(**kw)))[0]}
    got = pt.freeze_mask(params_from_jax(tree), pt.SGDConfig(**kw))
    assert got == want


def test_frozen_tensors_stay_and_caller_params_are_untouched(synth, tmp_path):
    tree, pds, _ = narrow_setup(synth)
    start = params_from_jax(tree)
    with torch.inference_mode():  # tensors made under inference_mode train too
        start = start.to("cpu")
    cfg = pt.SGDConfig(max_iter=2, base_lr=0.01, warmup_iters=0, freeze_backbone=True,
                       freeze_rpn_except_logits=True, **SMALL)
    seen = []
    params, hist = pt.do_train(start, pds, CANVAS, cfg, torch.Generator().manual_seed(0),
                               with_mask=True, log_every=1, checkpoint_period=1,
                               checkpoint_dir=str(tmp_path), val_fn=lambda p, it: seen.append(it),
                               val_period=1, device="cpu", **SIZES)
    assert np.isfinite(hist).all() and seen == [1]
    # the periodic checkpoint (after step 1) is the JAX tree, and the log has its lines
    with open(tmp_path / "model_0000001.pkl", "rb") as f:
        ckpt = flat(pickle.load(f))
    assert sorted(ckpt) == sorted(flat(tree))
    assert "iter: 1" in (tmp_path / "log.txt").read_text()
    mask = pt.freeze_mask(params, cfg)
    before, after = flat(tree), flat(tree_from_params(params))
    frozen = [p for p, t in pt.named_leaves(params) if not mask[p]]
    assert frozen and any(p.startswith("rpn/conv") for p in frozen)
    for path, t in pt.named_leaves(params):
        key = "".join(f"[{k}]" if k.isdigit() else f"['{k}']" for k in path.split("/"))
        same = np.array_equal(after[key], before[key])
        assert same == (not mask[path]), path
    for path, v in flat(tree_from_params(start)).items():
        np.testing.assert_array_equal(v, before[path])


def test_parse_time_budget_and_lr_schedule_match_jax():
    for spec in ("1h:30m:15s", "0h:0m:20s", None, ""):
        assert pt.parse_time_budget(spec) == jt.parse_time_budget(spec)
    with pytest.raises(ValueError):
        pt.parse_time_budget("90 minutes")
    for kw in (dict(), dict(base_lr=0.0005, warmup_iters=50, steps=(30, 60)),
               dict(warmup_iters=0, steps=(5,), gamma=0.5)):
        want, got = jt.lr_schedule(jt.SGDConfig(**kw)), pt.lr_schedule(pt.SGDConfig(**kw))
        for step in (0, 1, 2, 5, 29, 30, 49, 50, 59, 60, 100, 499, 500, 48000, 64001):
            np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-7)


def test_optimizer_step_matches_optax():
    """clip (both sides of 35) -> decay -> momentum -> -lr * trace, with a
    frozen leaf, three steps, on the same gradients."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    gmask = {"a": 1.0, "b": 1.0, "frozen": 0.0}
    cfg = jt.SGDConfig(base_lr=0.1, weight_decay=1e-2, warmup_iters=2, steps=(2,), gamma=0.5)
    tx = optax.chain(optax.clip_by_global_norm(35.0), optax.add_decayed_weights(cfg.weight_decay),
                     optax.sgd(learning_rate=jt.lr_schedule(cfg), momentum=cfg.momentum))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tensors = {k: torch.from_numpy(v.copy()) for k, v in params.items() if gmask[k]}
    for t in tensors.values():
        t.requires_grad_(True)
    opt = torch.optim.SGD(list(tensors.values()), lr=cfg.base_lr, momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay)
    lr_fn = pt.lr_schedule(pt.SGDConfig(**cfg._asdict()))
    for step, gscale in enumerate((1.0, 40.0, 3.0)):  # the second step clips
        grads = {k: (rng.normal(0, gscale, s)).astype(np.float32) for k, s in shapes.items()}
        jg = {k: jnp.asarray(v) * gmask[k] for k, v in grads.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, {k: u * gmask[k] for k, u in updates.items()})
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k].copy())
        pt.sgd_step(opt, list(tensors.values()), lr_fn(step))
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {step}")
        np.testing.assert_array_equal(np.asarray(jp["frozen"]), params["frozen"])
    norm = pt.clip_by_global_norm([torch.full((4,), 100.0)], 35.0)
    assert float(norm) == 200.0


def test_metric_logger_matches_jax():
    """``SmoothedValue`` / ``MetricLogger`` give the JAX package's medians,
    averages and log line on the same updates; no card, no memory figure."""
    from online_detection_tpu.utils import telemetry as jtel
    from online_detection_tpu_torch.utils import telemetry as ptel

    vals = np.random.default_rng(0).uniform(0, 5, (30, 2))
    got, want = ptel.MetricLogger(), jtel.MetricLogger()
    for t, loss in vals:
        got.update(time=t, loss=loss)
        want.update(time=t, loss=loss)
    for name in ("time", "loss"):
        g, w = got.meters[name], want.meters[name]
        assert (g.median, g.avg, g.global_avg, g.count) == (w.median, w.avg, w.global_avg, w.count)
    assert got.loss.median == want.loss.median
    assert str(got) == str(want)
    assert ptel.device_memory_mb() is None
    assert got.log_line(7, 100) == want.log_line(7, 100)


def test_time_budget_stops_training(synth):
    tree, pds, _ = narrow_setup(synth)
    cfg = pt.SGDConfig(max_iter=5, **TRAIN_KW)
    _, hist = pt.do_train(params_from_jax(tree), pds, CANVAS, cfg,
                          torch.Generator().manual_seed(0), with_mask=False, time_budget=0.0,
                          log_every=100, device="cpu", **SIZES)
    assert len(hist) == 1  # the budget is checked after each step, as in the JAX package
