"""The on-line segmentation demo and the incremental teacher
(``modules/demo.py``) of the port beside the JAX package's, on the CPU, on
the narrow network of ``test_torch_detector`` (one block a stage, narrow
widths) at a 128x192 canvas, as ``tests/test_demo_tools.py`` runs them:

- ``OnlineSegmentationDemo.run_on_image`` on a 240x320 image with the narrow
  on-line models, then ``overlay``;
- ``IncrementalTeacher``: one class taught with two observations and masks,
  ``update_model``; a second class added with ``add_new_class`` and
  taught, ``update_model`` again; after each round the models of both
  packages detect on a probe image.

The teacher's harvest runs in the pinned ``parity_sampling`` mode (set on
both packages' ``HarvestConfig``) with the narrow network's reservoir
widths, and its solvers are sized so that every cache row is a Nystrom
center: no draw decides anything. The detector's ridge is raised to 1e-3
(see ``TEACH_CFG``).

Tolerances, those of ``test_torch_training_slice``: equal validity and
labels, scores within 2e-3, boxes within 1e-2 px (on the canvas), mask
probabilities within 1e-2; the demo's pasted masks and overlays equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.models import detector as jdet
from online_detection_tpu.modules import demo as j_demo
from online_detection_tpu.pipelines.online_pipeline import OnlineTrainConfig as JCfg
from online_detection_tpu_torch.data import transforms
from online_detection_tpu_torch.models import detector
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.weights import online_from_jax, params_from_jax
from online_detection_tpu_torch.modules import demo as p_demo
from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
from tests.test_torch_detector import STAGES, narrow_online, narrow_tree

torch.set_num_threads(2)

CANVAS = (128, 192)
SIZES = dict(min_size=128, max_size=320)
DEMO_DCFG = dict(pre_nms_top_n=100, post_nms_top_n=30, detections_per_img=5)
TEACH_DCFG = dict(pre_nms_top_n=100, post_nms_top_n=30, detections_per_img=12)
# quota-sized solvers (as test_torch_host_pipeline): every cache row a center.
# The detector's ridge is 1e-3, not the default 1e-5: with the centers'
# duplicated slots its system is conditioned so that fp32 solves in another
# order move the second round's scores by up to 1.5e-2 at 1e-5 (6e-3 at
# M = 128), against 2e-4 at 1e-3
TEACH_CFG = dict(num_classes=0, det_m=256, rpn_m=256, segm_m=512, det_lam=1e-3, iterations=2,
                 batch_size=24, segm_batch_size=64)


@pytest.fixture(scope="module")
def network():
    rng = np.random.default_rng(7)
    tree = narrow_tree(rng)
    jonline = narrow_online(rng)
    return (jax.tree_util.tree_map(jnp.asarray, tree), jonline, params_from_jax(tree),
            online_from_jax(jonline))


def _image(seed, h=240, w=320):
    """Noise with a bright ellipse at a fixed place: the object to teach."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    ell = ((xx - 100) / 40.0) ** 2 + ((yy - 85) / 35.0) ** 2 <= 1
    rgb[ell] = [200 - 60 * (seed % 2), 60 + 120 * (seed % 2), 90]
    return rgb, ell.astype(np.float32)


def test_demo_run_on_image_and_overlay_match_jax(network):
    jtree, jonline, params, online = network
    names = ["bg", "a", "b", "c"]
    jd = j_demo.OnlineSegmentationDemo(jtree, jonline, names, canvas_hw=CANVAS,
                                       det_cfg=jdet.DetectorConfig(**DEMO_DCFG), **SIZES)
    pd = p_demo.OnlineSegmentationDemo(params, online, names, canvas_hw=CANVAS,
                                       det_cfg=detector.DetectorConfig(**DEMO_DCFG),
                                       device="cpu", **SIZES)
    rgb = np.random.default_rng(0).integers(0, 255, (240, 320, 3), dtype=np.uint8)
    want, got = jd.run_on_image(rgb), pd.run_on_image(rgb)
    assert set(got) == set(want) >= {"boxes", "scores", "labels", "class_names", "masks"}
    assert len(got["labels"]) > 1
    scale = transforms.resize_scale(320, 240, **SIZES)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["class_names"] == want["class_names"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-3)
    np.testing.assert_allclose(got["boxes"] * scale, want["boxes"] * scale, atol=1e-2)
    assert got["masks"].shape == want["masks"].shape == (len(got["labels"]), 240, 320)
    assert got["masks"].dtype == want["masks"].dtype == np.uint8
    np.testing.assert_array_equal(got["masks"], want["masks"])
    overlay = pd.overlay(rgb, got)
    assert overlay.shape == rgb.shape and overlay.dtype == np.uint8
    np.testing.assert_array_equal(overlay, jd.overlay(rgb, want))
    np.testing.assert_array_equal(pd.overlay(rgb), overlay)  # runs the image itself


def test_demo_confidence_threshold_and_no_masks(network):
    """A threshold above every score keeps nothing; a model set without a
    mask head gives no masks, as in the JAX package."""
    jtree, jonline, params, online = network
    rgb = np.random.default_rng(1).integers(0, 255, (240, 320, 3), dtype=np.uint8)
    kw = dict(canvas_hw=CANVAS, **SIZES)
    pd = p_demo.OnlineSegmentationDemo(params, online, ["bg", "a"], det_cfg=detector.
                                       DetectorConfig(**DEMO_DCFG), confidence_threshold=1e9,
                                       device="cpu", **kw)
    out = pd.run_on_image(rgb)
    assert len(out["boxes"]) == 0 and out["masks"].shape == (0, 240, 320)
    assert (pd.overlay(rgb, out) == rgb).all()
    no_mask = jonline._replace(mask=None)
    jd = j_demo.OnlineSegmentationDemo(jtree, no_mask, ["bg", "a"],
                                       det_cfg=jdet.DetectorConfig(**DEMO_DCFG), **kw)
    pd = p_demo.OnlineSegmentationDemo(params, online_from_jax(no_mask), ["bg", "a"],
                                       det_cfg=detector.DetectorConfig(**DEMO_DCFG),
                                       device="cpu", **kw)
    want, got = jd.run_on_image(rgb), pd.run_on_image(rgb)
    assert "masks" not in got and "masks" not in want
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["class_names"] == want["class_names"]  # labels past the names print as numbers
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-3)


# ---------------------------------------------------------------------------
# the incremental teacher


_TEACH = {}


def _probe_detections(jtree, params, jonline, online, rgb):
    """Both packages' detect_batched on the probe image's canvas."""
    canvas, _, (sw, sh) = transforms.preprocess_image_u8(rgb, CANVAS, **SIZES)
    anchors = grid_anchors(CANVAS[0] // 16, CANVAS[1] // 16)
    size = np.array([[sw, sh]], np.float32)
    want = jdet.detect_batched(jtree, jonline, jnp.asarray(anchors), jnp.asarray(canvas[None]),
                               jnp.asarray(size), jdet.DetectorConfig(**TEACH_DCFG), True)
    got = detector.detect_batched(params, online, anchors, canvas[None], size,
                                  detector.DetectorConfig(**TEACH_DCFG), True, device="cpu")
    return got, want


@pytest.fixture(scope="module")
def teaching(network, tmp_path_factory):
    """Both teachers over the same observations: two rounds each; per round,
    (JAX models, port models, port detections, JAX detections on the probe)."""
    jtree, _, params, _ = network
    c4, c5 = STAGES[2][1], STAGES[3][1]
    mp = pytest.MonkeyPatch()
    rounds = []
    try:
        for mod in (j_demo, p_demo):
            mp.setattr(mod, "HarvestConfig",
                       functools.partial(mod.HarvestConfig, parity_sampling=True))
            mp.setattr(mod, "HarvestAccumulator",
                       functools.partial(mod.HarvestAccumulator, rpn_dim=c4, det_dim=c5))
        jt = j_demo.IncrementalTeacher(jtree, canvas_hw=CANVAS, train_cfg=JCfg(**TEACH_CFG),
                                       det_cfg=jdet.DetectorConfig(**TEACH_DCFG), **SIZES)
        pt = p_demo.IncrementalTeacher(params, canvas_hw=CANVAS,
                                       train_cfg=OnlineTrainConfig(**TEACH_CFG),
                                       det_cfg=detector.DetectorConfig(**TEACH_DCFG),
                                       device="cpu", **SIZES)
        dirs = {}
        for name in ("jax", "port"):
            dirs[name] = tmp_path_factory.mktemp(f"teacher_{name}")
        rgb0, mask0 = _image(0)
        rgb1, mask1 = _image(1)
        probe, _ = _image(2)
        labels = []
        for t in (jt, pt):
            cup = t.add_new_class("cup")
            labels.append(cup)
            t.observe(rgb0, [60, 50, 140, 120], cup, mask0)
            t.observe(rgb1, [60, 50, 140, 120], cup, mask1)
        jo = jt.update_model(str(dirs["jax"]))
        po = pt.update_model(str(dirs["port"]))
        rounds.append((jo, po) + _probe_detections(jtree, params, jo, po, probe))
        rgb2, mask2 = _image(3)
        for t in (jt, pt):
            ball = t.add_new_class("ball")
            labels.append(ball)
            t.observe(rgb2, [60, 50, 140, 120], ball, mask2)
            t.observe(rgb2[:, ::-1].copy(), [180, 50, 260, 120], ball, mask2[:, ::-1].copy())
        jo = jt.update_model(str(dirs["jax"]))
        po = pt.update_model(str(dirs["port"]))
        rounds.append((jo, po) + _probe_detections(jtree, params, jo, po, probe))
    finally:
        mp.undo()
    _TEACH.update(labels=labels, classes=(jt.class_names, pt.class_names),
                  lines=[(dirs[n] / "result.txt").read_text().splitlines()
                         for n in ("jax", "port")])
    return rounds


def test_teacher_labels_and_classes(teaching):
    assert _TEACH["labels"] == [1, 1, 2, 2]
    jnames, pnames = _TEACH["classes"]
    assert pnames == jnames == ["__background__", "cup", "ball"]


@pytest.mark.parametrize("round_", [0, 1])
def test_teacher_models_exist_for_every_class(teaching, round_):
    jo, po = teaching[round_][:2]
    n_cls = round_ + 1
    assert po.detector.falkon.alpha.shape[0] == n_cls
    assert po.detector.falkon.exists.all() and po.mask.falkon.exists.all()
    for head in ("rpn", "detector", "mask"):
        np.testing.assert_array_equal(getattr(po, head).falkon.exists.numpy(),
                                      np.asarray(getattr(jo, head).falkon.exists), err_msg=head)
    np.testing.assert_array_equal(po.detector.rls.exists.numpy(),
                                  np.asarray(jo.detector.rls.exists))


@pytest.mark.parametrize("round_", [0, 1])
def test_teacher_detections_on_a_probe_match_jax(teaching, round_):
    (gd, gm, _, gpv), (wd, wm, _, wpv) = teaching[round_][2:]
    np.testing.assert_array_equal(gpv.numpy(), np.asarray(wpv))
    np.testing.assert_array_equal(gd.valid.numpy(), np.asarray(wd.valid))
    np.testing.assert_array_equal(gd.labels.numpy(), np.asarray(wd.labels))
    assert gd.valid.any()
    np.testing.assert_allclose(gd.scores.numpy(), np.asarray(wd.scores), atol=2e-3)
    np.testing.assert_allclose(gd.boxes.numpy(), np.asarray(wd.boxes), atol=1e-2)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-2)


def test_teacher_result_lines_match_jax(teaching):
    import re

    jl, pl = ([re.sub(r"\d+min:\d+s", "T", ln) for ln in lines] for lines in _TEACH["lines"])
    assert pl == jl
    assert sum("Online Segmentation training time" in ln for ln in pl) == 2


def test_teacher_without_device_raises(monkeypatch, network):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = network[2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_demo.IncrementalTeacher(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_demo.OnlineSegmentationDemo(params, network[3], ["bg"])
