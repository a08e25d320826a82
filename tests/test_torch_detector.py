"""The slice as a whole: the port's ``detect_batched`` vs the JAX package's on
the CPU, on a narrow network (one block per stage, narrow widths) built with
numpy and carried over by ``params_from_jax`` / ``online_from_jax``.

Required: identical ``valid`` masks and labels, boxes within 1e-3 px, scores
and masks within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.models import detector as jdet
from online_detection_tpu.models.heads import OnlineDetectorModels as JDetModels
from online_detection_tpu.models.heads import OnlineMaskModels as JMaskModels
from online_detection_tpu.models.rpn import OnlineRPNModels as JRPNModels
from online_detection_tpu.solvers.falkon import FalkonModel as JFalkon
from online_detection_tpu.solvers.rls import RLSModel as JRLS
from online_detection_tpu.utils.stats import FeatureStats as JStats
from online_detection_tpu_torch.models import detector
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.weights import online_from_jax, params_from_jax

torch.set_num_threads(2)

STAGES = ((8, 32), (8, 32), (16, 64), (16, 64))  # (mid, out) per stage, one block each
N_CLS = 3


def _conv_bn(rng, k, cin, cout, damp=1.0):
    return {"w": (rng.normal(size=(k, k, cin, cout)) * (2.0 / (k * k * cin)) ** 0.5
                  ).astype(np.float32),
            "scale": (rng.uniform(0.8, 1.2, cout) * damp).astype(np.float32),
            "bias": (rng.normal(size=cout) * 0.05).astype(np.float32)}


def narrow_tree(rng):
    stem = _conv_bn(rng, 7, 3, 64)
    stem["w"] /= 64.0
    bb = {"stem": stem}
    cin = 64
    for si, (mid, cout) in enumerate(STAGES):
        bb[f"res{si + 2}"] = [{
            "branch2a": _conv_bn(rng, 1, cin, mid), "branch2b": _conv_bn(rng, 3, mid, mid),
            "branch2c": _conv_bn(rng, 1, mid, cout, 0.1), "branch1": _conv_bn(rng, 1, cin, cout),
        }]
        cin = cout
    c4, c5 = STAGES[2][1], STAGES[3][1]
    f = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)
    rpn = {"conv_w": f(3, 3, c4, c4), "conv_b": f(c4), "cls_w": f(c4, 15), "cls_b": f(15),
           "bbox_w": f(c4, 60), "bbox_b": f(60)}
    mask = {"w": f(2, 2, c5, 256) * 4, "b": f(256), "logits_w": f(256, N_CLS + 1),
            "logits_b": f(N_CLS + 1)}
    return {"backbone": bb, "rpn": rpn, "mask_head": mask}


def narrow_online(rng):
    def falkon(c, m, d, sigma, exists=None):
        alpha = rng.normal(size=(c, m)).astype(np.float32)
        alpha -= alpha.mean(1, keepdims=True)  # comparable score ranges across classes
        return JFalkon(jnp.asarray(rng.normal(size=(c, m, d)).astype(np.float32) * 2),
                       jnp.asarray(alpha),
                       jnp.asarray(np.ones(c, bool) if exists is None else exists), sigma)

    def rls(c, d):
        eye = np.broadcast_to(np.eye(4, dtype=np.float32), (c, 4, 4)).copy()
        return JRLS(jnp.asarray(rng.normal(size=(c, d + 1, 4)).astype(np.float32) * 1e-3),
                    jnp.asarray(eye), jnp.asarray(eye),
                    jnp.asarray(rng.normal(size=(c, 4)).astype(np.float32) * 0.05),
                    jnp.ones((c,), bool), jnp.zeros((c, 4)))

    def stats(d):
        return JStats(jnp.asarray(rng.normal(size=d).astype(np.float32) * 0.1),
                      jnp.ones((d,)), jnp.asarray(np.float32(rng.uniform(5, 10))))

    c4, c5 = STAGES[2][1], STAGES[3][1]
    return jdet.OnlineModelSet(
        rpn=JRPNModels(falkon(15, 16, c4, 50.0), rls(15, c4), stats(c4)),
        detector=JDetModels(falkon(N_CLS, 16, c5, 40.0), rls(N_CLS, c5), stats(c5)),
        mask=JMaskModels(falkon(N_CLS, 16, 256, 10.0, np.array([True, False, True])),
                         stats(256)),
    )


CFG_ARGS = dict(pre_nms_top_n=150, post_nms_top_n=40, detections_per_img=12)


@pytest.fixture(scope="module")
def setup():
    """(JAX tree, JAX on-line models, port params, port on-line models,
    anchors, images, sizes) for a batch of 2 canvases of 96x128."""
    rng = np.random.default_rng(7)
    tree = narrow_tree(rng)
    jonline = narrow_online(rng)
    h, w, b = 96, 128, 2
    anchors = grid_anchors(h // 16, w // 16)
    images = rng.integers(0, 256, size=(b, h, w, 3), dtype=np.uint8)
    sizes = np.array([[w, h], [w - 10, h - 6]], np.float32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    return (jtree, jonline, params_from_jax(tree), online_from_jax(jonline), anchors, images,
            sizes)


@pytest.fixture(scope="module")
def slice_run(setup):
    jtree, jonline, params, online, anchors, images, sizes = setup
    want = jdet.detect_batched(jtree, jonline, jnp.asarray(anchors), jnp.asarray(images),
                               jnp.asarray(sizes), jdet.DetectorConfig(**CFG_ARGS), True)
    got = detector.detect_batched(params, online, anchors, images, sizes,
                                  detector.DetectorConfig(**CFG_ARGS), True, device="cpu")
    return got, want


def test_detect_batched_valid_and_labels_identical(slice_run):
    (gd, _, _, gpv), (wd, _, _, wpv) = slice_run
    np.testing.assert_array_equal(gpv.numpy(), np.asarray(wpv))
    np.testing.assert_array_equal(gd.valid.numpy(), np.asarray(wd.valid))
    np.testing.assert_array_equal(gd.labels.numpy(), np.asarray(wd.labels))
    assert gd.valid.any() and (gd.labels[gd.valid] >= 1).all()
    # more than one class survives, so the own-class mask gather is exercised
    assert len(set(gd.labels[gd.valid].tolist())) > 1


def test_detect_batched_boxes_scores_masks_close(slice_run):
    (gd, gm, gpb, _), (wd, wm, wpb, _) = slice_run
    np.testing.assert_allclose(gpb.numpy(), np.asarray(wpb), atol=1e-3)
    np.testing.assert_allclose(gd.boxes.numpy(), np.asarray(wd.boxes), atol=1e-3)
    np.testing.assert_allclose(gd.scores.numpy(), np.asarray(wd.scores), atol=1e-4)
    assert gm.shape == (2, 12, 14, 14)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-4)
    assert (gd.boxes[~gd.valid] == 0).all()
    assert ((gm >= 0) & (gm <= 1)).all()


def _assert_same_detections(got, want):
    (gd, gm, gpb, gpv), (wd, wm, wpb, wpv) = got, want
    np.testing.assert_array_equal(gpv.numpy(), np.asarray(wpv))
    np.testing.assert_allclose(gpb.numpy(), np.asarray(wpb), atol=1e-3)
    np.testing.assert_array_equal(gd.valid.numpy(), np.asarray(wd.valid))
    np.testing.assert_array_equal(gd.labels.numpy(), np.asarray(wd.labels))
    np.testing.assert_allclose(gd.boxes.numpy(), np.asarray(wd.boxes), atol=1e-3)
    np.testing.assert_allclose(gd.scores.numpy(), np.asarray(wd.scores), atol=1e-4)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-4)


def test_detect_single_image_matches_jax(setup):
    jtree, jonline, params, online, anchors, images, sizes = setup
    want = jdet.detect(jtree, jonline, jnp.asarray(anchors), jnp.asarray(images[1]),
                       jnp.asarray(sizes[1]), jdet.DetectorConfig(**CFG_ARGS), True)
    got = detector.detect(params, online, anchors, images[1], sizes[1],
                          detector.DetectorConfig(**CFG_ARGS), True, device="cpu")
    assert got[1].shape == (12, 14, 14)
    _assert_same_detections(got, want)


def test_detect_batched_gt_boxes_mode_matches_jax(setup):
    """With ground-truth boxes the mask head runs on them (the mask-quality
    protocol); padding rows stay zero."""
    jtree, jonline, params, online, anchors, images, sizes = setup
    gt_boxes = np.array([[[4, 6, 60, 50], [30, 20, 120, 90], [0, 0, 0, 0]],
                         [[10, 10, 40, 70], [50, 5, 100, 40], [20, 30, 90, 80]]], np.float32)
    gt_labels = np.array([[1, 3, 0], [2, 2, 1]], np.int32)
    gt_valid = np.array([[True, True, False], [True, True, True]])
    want = jdet.detect_batched(jtree, jonline, jnp.asarray(anchors), jnp.asarray(images),
                               jnp.asarray(sizes), jdet.DetectorConfig(**CFG_ARGS), True,
                               jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                               jnp.asarray(gt_valid))
    got = detector.detect_batched(params, online, anchors, images, sizes,
                                  detector.DetectorConfig(**CFG_ARGS), True, gt_boxes,
                                  gt_labels, gt_valid, device="cpu")
    _assert_same_detections(got, want)
    assert (got[0].boxes[0, 2] == 0).all() and got[1].shape == (2, 3, 14, 14)


_DTYPES = (None, "float32", "bfloat16")


@pytest.mark.parametrize("cfg_dtype", _DTYPES)
@pytest.mark.parametrize("env", _DTYPES + ("",))
def test_compute_dtype_resolves_as_jax(monkeypatch, env, cfg_dtype):
    """``ODTPU_COMPUTE_DTYPE`` first (empty counts as unset), then
    ``cfg.compute_dtype``, then the device's default: the JAX package's
    order. The CPU's default is f32 in both packages; the card's is bf16."""
    if env is None:
        monkeypatch.delenv("ODTPU_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("ODTPU_COMPUTE_DTYPE", env)
    want = jdet.resolve_compute_dtype(jdet.DetectorConfig(compute_dtype=cfg_dtype))
    cfg = detector.DetectorConfig(compute_dtype=cfg_dtype)
    assert detector.resolve_compute_dtype(cfg, "cpu") == getattr(torch, want)
    card = env or cfg_dtype or "bfloat16"
    assert detector.resolve_compute_dtype(cfg, "cuda") == getattr(torch, card)


@pytest.mark.parametrize("env, cfg_dtype", [("float16", None), ("fp32", "float32"),
                                            (None, "half")])
def test_unknown_compute_dtype_raises(monkeypatch, env, cfg_dtype):
    if env is None:
        monkeypatch.delenv("ODTPU_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("ODTPU_COMPUTE_DTYPE", env)
    with pytest.raises(ValueError, match="unknown trunk dtype"):
        detector.resolve_compute_dtype(detector.DetectorConfig(compute_dtype=cfg_dtype), "cpu")


def test_compute_dtype_override_reaches_detect_batched(setup, slice_run, monkeypatch):
    """With ``ODTPU_COMPUTE_DTYPE=float32`` a config that asks for a bf16
    trunk runs it in f32: the detections equal the f32 run's, and so the JAX
    package's."""
    jtree, jonline, params, online, anchors, images, sizes = setup
    cfg = detector.DetectorConfig(**CFG_ARGS, compute_dtype="bfloat16")
    monkeypatch.setenv("ODTPU_COMPUTE_DTYPE", "float32")
    got = detector.detect_batched(params, online, anchors, images, sizes, cfg, True,
                                  device="cpu")
    _assert_same_detections(got, slice_run[1])
    monkeypatch.delenv("ODTPU_COMPUTE_DTYPE")
    bf16 = detector.detect_batched(params, online, anchors, images, sizes, cfg, True,
                                   device="cpu")
    assert not torch.equal(bf16[0].scores, got[0].scores)  # the config's bf16 trunk ran
