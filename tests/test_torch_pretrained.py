"""The stock Mask R-CNN path through both packages on the CPU in float32:
``detect_pretrained`` on a narrow R-50 (3/4/6/3 blocks) with and without a
mask head, and its parts ``mask_pretrained_logits``,
``postprocess_detections_standalone``, ``roi_align_nchw`` and
``preprocess_image``.

Tolerances: boxes 1e-3 px, scores 1e-5, labels and validity exact, mask
probabilities 1e-5; ``preprocess_image`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.data import transforms as jtf
from online_detection_tpu.models import detector as jdet
from online_detection_tpu.models import heads as jheads
from online_detection_tpu.models import postprocess as jpost
from online_detection_tpu.ops.roi_align import roi_align_nchw as j_roi_align_nchw
from online_detection_tpu_torch.data import transforms as ptf
from online_detection_tpu_torch.models import detector as pdet
from online_detection_tpu_torch.models import heads as pheads
from online_detection_tpu_torch.models import postprocess as ppost
from online_detection_tpu_torch.models import resnet
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.ops import roi_align as proi
from tests.test_torch_weights import r50_narrow_tree

torch.set_num_threads(2)

H, W = 128, 160
CFG = dict(pre_nms_top_n=60, post_nms_top_n=20, detections_per_img=8)


def _image(seed=1):
    return np.random.default_rng(seed).uniform(-100, 100, (H, W, 3)).astype(np.float32)


def centred_tree(seed, image, mask=True, gain=0.3):
    """``r50_narrow_tree`` with its class logits centred on this image's RoI
    features: random res5 features share a large mean, which alone would
    make one class win every RoI. The scores then spread over several
    classes with gaps far above the tolerance."""
    tree = r50_narrow_tree(seed=seed, mask=mask)
    p = params_from_jax(tree)
    boxes = torch.tensor([[0, 0, W / 2, H / 2], [W / 4, H / 4, W - 1, H - 1], [10, 30, 90, 120]])
    with torch.no_grad():
        c4 = resnet.backbone_c4(p.backbone, torch.from_numpy(image)[None])
        mean = resnet.res5_head(p.backbone, proi.roi_align(c4[0], boxes)).mean(0).numpy()
    bp = tree["box_predictor"]
    bp["cls_w"] = bp["cls_w"] * np.float32(gain)
    bp["cls_b"] = -(mean @ bp["cls_w"]).astype(np.float32)
    return tree


@pytest.mark.parametrize("mask", [True, False])
def test_detect_pretrained_matches_jax(mask):
    image = _image()
    tree = centred_tree(4, image, mask=mask)
    anchors = grid_anchors(H // 16, W // 16)
    size = (W - 12, H - 8)
    jcfg = jdet.DetectorConfig(**CFG, compute_dtype="float32")
    jd, jm, jp, jv = jdet.detect_pretrained(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(anchors), jnp.asarray(image),
        jnp.asarray(size), jcfg, with_masks=True)
    pd, pm, pp, pv = pdet.detect_pretrained(
        params_from_jax(tree), anchors, image, size, pdet.DetectorConfig(**CFG),
        with_masks=True, device="cpu")

    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-3)
    valid = np.asarray(jd.valid)
    assert valid.sum() >= 3  # the comparison sees real detections
    np.testing.assert_array_equal(pd.valid.numpy(), valid)
    np.testing.assert_array_equal(pd.labels.numpy(), np.asarray(jd.labels))
    np.testing.assert_allclose(pd.boxes.numpy(), np.asarray(jd.boxes), atol=1e-3)
    np.testing.assert_allclose(pd.scores.numpy(), np.asarray(jd.scores), atol=1e-5)
    assert len(set(pd.labels.numpy()[valid].tolist())) >= 2  # more than one class kept
    if mask:
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=1e-5)
    else:
        assert pm is None and jm is None


def test_detect_pretrained_uint8_canvas_and_defaults():
    """A uint8 canvas is normalized on the device, as ``detect_batched`` does,
    and masks are off by default."""
    tree = r50_narrow_tree(seed=4)
    rgb = np.random.default_rng(3).integers(0, 256, (H, W, 3), dtype=np.uint8)
    anchors = grid_anchors(H // 16, W // 16)
    jd, jm, _, _ = jdet.detect_pretrained(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(anchors), jnp.asarray(rgb),
        jnp.asarray([W, H]), jdet.DetectorConfig(**CFG, compute_dtype="float32"))
    pd, pm, _, _ = pdet.detect_pretrained(params_from_jax(tree), anchors, rgb, (W, H),
                                          pdet.DetectorConfig(**CFG), device="cpu")
    assert pm is None and jm is None
    np.testing.assert_array_equal(pd.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_array_equal(pd.labels.numpy(), np.asarray(jd.labels))
    np.testing.assert_allclose(pd.scores.numpy(), np.asarray(jd.scores), atol=1e-5)


def test_mask_pretrained_logits_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 14, 14, 256)).astype(np.float32)
    lw = rng.normal(size=(256, 9)).astype(np.float32) * 0.1
    lb = rng.normal(size=9).astype(np.float32)
    want = jheads.mask_pretrained_logits({"logits_w": jnp.asarray(lw),
                                          "logits_b": jnp.asarray(lb)}, jnp.asarray(x))
    head = pheads.MaskHead(torch.zeros(1), torch.zeros(1), torch.from_numpy(lw),
                           torch.from_numpy(lb))
    got = pheads.mask_pretrained_logits(head, torch.from_numpy(x))
    assert got.shape == (5, 14, 14, 9) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _standalone_inputs(seed=0, r=30, n_cls=4):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-40, 300, (r, n_cls, 2))  # past the left/top edge and the far edges
    wh = rng.uniform(10, 120, (r, n_cls, 2))
    boxes = np.concatenate([xy, xy + wh], -1).reshape(r, -1).astype(np.float32)
    # scores on a 1/8 grid: exact in float32, and ties within and across classes
    scores = (rng.integers(0, 8, (r, n_cls)) / 8.0).astype(np.float32)
    scores[:, 0] = -1.0
    valid = rng.uniform(size=r) > 0.1
    return boxes, scores, valid


@pytest.mark.parametrize("dpi", [5, 12, 0])
def test_postprocess_detections_standalone_matches_jax(dpi):
    boxes, scores, valid = _standalone_inputs()
    size = (256, 200)
    kw = dict(score_thresh=0.3, nms_thresh=0.5, detections_per_img=dpi, per_class_cap=10)
    want = jpost.postprocess_detections_standalone(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), jnp.asarray(size), **kw)
    got = ppost.postprocess_detections_standalone(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(valid),
        torch.tensor(size), **kw)
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    kept = got.boxes.numpy()[v]
    assert kept.min() >= 0 and kept[:, 2].max() <= size[0] - 1 and kept[:, 3].max() <= size[1] - 1
    if dpi == 5:  # the ties at the k-th score survive the cap
        assert v.sum() > dpi
        kth = np.sort(got.scores.numpy()[v])[::-1][dpi - 1]
        assert (got.scores.numpy()[v] >= kth).all()


def test_roi_align_nchw_matches_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(32, 12, 15)).astype(np.float32)
    rois = np.array([[0, 0, 100, 80], [30.5, 20.25, 200, 180], [-20, -10, 40, 30],
                     [50, 60, 50, 60]], np.float32)
    want = j_roi_align_nchw(jnp.asarray(feats), jnp.asarray(rois), pooled_h=7, pooled_w=7,
                               spatial_scale=1.0 / 16.0)
    got = proi.roi_align_nchw(torch.from_numpy(feats), torch.from_numpy(rois), 7, 1.0 / 16.0)
    assert got.shape == (4, 32, 7, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw,canvas,min_size,max_size", [
    ((240, 320), (128, 192), 128, 320),  # PIL bilinear resize
    ((75, 500), (64, 448), 64, 448),  # the long side truncated, then a max-size cap
    ((128, 160), (128, 160), 128, 1333),  # no resize
])
def test_preprocess_image_bit_equal(hw, canvas, min_size, max_size):
    rgb = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    jc, js, jsz = jtf.preprocess_image(rgb, canvas, min_size, max_size)
    pc, ps, psz = ptf.preprocess_image(rgb, canvas, min_size, max_size)
    assert pc.dtype == np.float32 and pc.shape == canvas + (3,)
    assert ps == js and psz == jsz
    np.testing.assert_array_equal(pc, jc)
