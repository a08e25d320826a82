"""The training slice as a whole, through both packages on the CPU: harvest
(``harvest_dataset_device``), training (``train_online_modules_device``) and
``detect_batched`` with the trained models, on a tiny synthetic teaching set
(4 images of 96x128, one ellipse each, 3 classes) and the narrow network of
``test_torch_detector``; then the inference stage, ``run_inference`` with
its VOC07 scoring, through both packages with the JAX-trained models.

Both sides run without draws that matter: the harvest in the pinned
``parity_sampling`` mode (set on both packages' ``HarvestConfig``), and the
solvers sized so that every pool stays under its quota (Nystrom centers,
feature statistics), where both take every row. The reservoirs' feature
widths follow the narrow network (set on both packages' ``init_reservoirs``).

Tolerances: reservoir counts equal, rows within 1e-4 (fp32 convs in another
order); head scores on probe rows within 2e-3 and RLS predictions within
2e-3 (fp32 Cholesky solves of M=160 systems); detections: equal validity
and labels, scores within 2e-3, boxes within 1e-2 px; mask probabilities
within 1e-2 (the segmenter's ridge is 1e-6, so its per-pixel solve carries
fp32 rounding further than the other heads').

Both packages train with an ``output_dir``: their ``result.txt`` lines, and
the port's ``timings`` keys, name the same stages in the same order. The
port's stage clocks are recorded as events, to show that each clock that
follows the feature statistics starts after them and after a device sync,
where the JAX package starts it.

``run_inference`` runs over the 4 teaching images at batch 3 (the tail batch
padded), masks on, with the detections and with the GT boxes substituted:
equal per-image valid counts and labels, boxes within 1e-2 px, scores within
2e-3, mask probabilities within 1e-2 (the tolerances above), det and segm
mAP@0.5 within 1e-3, and the same ``result.txt`` lines once the time is
masked."""

import functools
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.engine import device_accumulate as j_dacc
from online_detection_tpu.models import detector as jdet
from online_detection_tpu.pipelines import device_pipeline as j_dpipe
from online_detection_tpu.pipelines.online_pipeline import OnlineTrainConfig as JCfg
from online_detection_tpu.solvers.falkon import falkon_predict_classes as j_predict
from online_detection_tpu.solvers.rls import rls_predict as j_rls_predict
from online_detection_tpu_torch.engine import device_accumulate as dacc
from online_detection_tpu_torch.models import detector
from online_detection_tpu_torch.models.anchors import grid_anchors
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.pipelines import device_pipeline as dpipe
from online_detection_tpu_torch.pipelines import online_pipeline as opipe
from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes
from online_detection_tpu_torch.solvers.rls import rls_predict
from tests.test_torch_detector import STAGES, narrow_tree

torch.set_num_threads(2)

H, W, N_IMG, N_CLS = 96, 128, 4, 3
CFG = dict(num_classes=N_CLS, det_m=64, rpn_m=64, segm_m=160, iterations=2, batch_size=24,
           segm_batch_size=64, rpn_pos_cap=64, det_pos_cap=32, coxy_cap=128, segm_pos_cap=64,
           solver_class_chunk=2)
DCFG = dict(pre_nms_top_n=150, post_nms_top_n=40, detections_per_img=12)
HARVEST = dict(gt_cap=4, min_size=96, max_size=400, batch_size=2)


class _Anno:
    def __init__(self, boxes, labels):
        self.boxes, self.labels = boxes, labels


class TinyTeachingSet:
    """One coloured ellipse per image, with its box and mask; class i % 3 + 1."""

    def __init__(self, n, h, w):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def _make(self, i):
        rng = np.random.default_rng(100 + i)
        img = rng.integers(0, 60, (self.h, self.w, 3), dtype=np.uint8)
        bw = int(rng.integers(self.w // 4, self.w // 2))
        bh = int(rng.integers(self.h // 4, self.h // 2))
        x1, y1 = int(rng.integers(0, self.w - bw)), int(rng.integers(0, self.h - bh))
        yy, xx = np.mgrid[:self.h, :self.w]
        ell = ((xx - x1 - bw / 2) / (bw / 2)) ** 2 + ((yy - y1 - bh / 2) / (bh / 2)) ** 2 <= 1
        img[ell] = [(i * 70) % 255, (i * 130) % 255, (i * 40 + 100) % 255]
        box = np.array([[x1, y1, x1 + bw, y1 + bh]], np.float32)
        return img, box, np.array([i % N_CLS + 1]), ell[None].astype(np.float32)

    def load_image(self, i):
        return self._make(i)[0]

    def get_annotation(self, i):
        _, box, label, _ = self._make(i)
        return _Anno(box, label)

    def load_masks(self, i, anno=None):
        return self._make(i)[3]


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """(JAX reservoirs, JAX models, JAX detections, port reservoirs, port
    models, port detections); ``TRAINING`` gets each package's result.txt
    lines, the port's timings and its clock events."""
    rng = np.random.default_rng(7)
    tree = narrow_tree(rng)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    params = params_from_jax(tree)
    ds = TinyTeachingSet(N_IMG, H, W)
    c4, c5 = STAGES[2][1], STAGES[3][1]
    mp = pytest.MonkeyPatch()
    try:
        for mod in (j_dpipe, dpipe):
            mp.setattr(mod, "HarvestConfig",
                       functools.partial(mod.HarvestConfig, parity_sampling=True))
        for mod in (j_dacc, dacc):
            mp.setattr(mod, "init_reservoirs",
                       functools.partial(mod.init_reservoirs, rpn_dim=c4, det_dim=c5))
        jcfg = JCfg(**CFG)
        jstate, _ = j_dpipe.harvest_dataset_device(
            jax.random.key(1), jtree, ds, jcfg, (H, W),
            dcfg=jdet.DetectorConfig(**DCFG), **HARVEST)
        jcounts = {k: np.asarray(getattr(jstate, k).counts) for k in _POOLS}
        jrows = {k: np.asarray(getattr(jstate, k).rows) for k in _POOLS}
        jdir = tmp_path_factory.mktemp("jax_train")
        jonline = j_dpipe.train_online_modules_device(jax.random.key(2), [jstate], jcfg,
                                                      output_dir=str(jdir))

        cfg = OnlineTrainConfig(**CFG)
        gen = torch.Generator().manual_seed(0)
        state, _ = dpipe.harvest_dataset_device(
            gen, params, ds, cfg, (H, W), dcfg=detector.DetectorConfig(**DCFG),
            device="cpu", **HARVEST)
        counts = {k: getattr(state, k).counts.numpy() for k in _POOLS}
        rows = {k: getattr(state, k).rows.numpy().copy() for k in _POOLS}
        pdir = tmp_path_factory.mktemp("port_train")
        events, timings = [], {}
        _record_clock_events(mp, events)
        online = dpipe.train_online_modules_device(gen, [state], cfg, output_dir=str(pdir),
                                                   device="cpu", timings=timings)
    finally:
        mp.undo()
    TRAINING.update(jax_lines=_result_lines(jdir), port_lines=_result_lines(pdir),
                    timings=timings, events=events, jtree=jtree, params=params)

    images = np.stack([ds.load_image(i) for i in range(2)])
    sizes = np.array([[W, H]] * 2, np.float32)
    anchors = grid_anchors(H // 16, W // 16)
    jd = jdet.detect_batched(jtree, jonline, jnp.asarray(anchors), jnp.asarray(images),
                             jnp.asarray(sizes), jdet.DetectorConfig(**DCFG), True)
    pd = detector.detect_batched(params, online, anchors, images, sizes,
                                 detector.DetectorConfig(**DCFG), True, device="cpu")
    return (jcounts, jrows, jonline, jd), (counts, rows, online, pd)


TRAINING = {}


def _record_clock_events(mp, events):
    """Log the port's feature statistics, and the device syncs and clock
    reads of its stage clocks (``online_pipeline._StageClock``)."""
    stats, sync = dacc.device_feature_stats_pool, opipe.sync

    def logged(name, fn):
        def call(*args, **kwargs):
            events.append(name)
            return fn(*args, **kwargs)
        return call

    clock = type("Clock", (), {"time": staticmethod(logged("clock", time.time))})
    mp.setattr(dacc, "device_feature_stats_pool", logged("stats", stats))
    mp.setattr(opipe, "sync", logged("sync", sync))
    mp.setattr(opipe, "time", clock)


def _result_lines(out_dir):
    """result.txt's lines with the times taken out."""
    text = (out_dir / "result.txt").read_text()
    return [re.sub(r"\d+min:\d+s", "T", line) for line in text.splitlines()]


_POOLS = ("rpn_neg", "rpn_pos", "rpn_coxy_y", "det_neg", "det_pos", "det_coxy", "mask_pos",
          "mask_neg")


def test_reservoirs_match(slice_runs):
    (jcounts, jrows, _, _), (counts, rows, _, _) = slice_runs
    for k in _POOLS:
        np.testing.assert_array_equal(counts[k], jcounts[k], err_msg=k)
        valid = np.arange(rows[k].shape[1])[None, :] < counts[k][:, None]
        np.testing.assert_allclose(rows[k][valid], jrows[k][valid], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert counts["det_neg"].min() > 0 and counts["mask_neg"].min() > 0


def _probe(rng, d):
    return rng.normal(size=(32, d)).astype(np.float32) * 3.0


@pytest.mark.parametrize("head", ["rpn", "detector", "mask"])
def test_trained_heads_score_alike(slice_runs, head):
    (_, _, jonline, _), (_, _, online, _) = slice_runs
    jm, m = getattr(jonline, head), getattr(online, head)
    np.testing.assert_array_equal(m.falkon.exists.numpy(), np.asarray(jm.falkon.exists))
    assert m.falkon.exists.any()
    x = _probe(np.random.default_rng(3), m.falkon.centers.shape[-1])
    x = x + m.stats.mean.numpy()  # around the features, before z-scoring
    from online_detection_tpu.utils.stats import zscore as j_zscore
    from online_detection_tpu_torch.utils.stats import zscore

    want = np.asarray(j_predict(jm.falkon, j_zscore(jnp.asarray(x), jm.stats)))
    got = falkon_predict_classes(m.falkon, zscore(torch.from_numpy(x), m.stats)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    if head != "mask":
        np.testing.assert_array_equal(m.rls.exists.numpy(), np.asarray(jm.rls.exists))
        np.testing.assert_allclose(rls_predict(m.rls, torch.from_numpy(x)).numpy(),
                                   np.asarray(j_rls_predict(jm.rls, jnp.asarray(x))),
                                   atol=2e-3, rtol=2e-3)


def test_detections_with_trained_models_match(slice_runs):
    (_, _, _, (wd, wm, _, wpv)), (_, _, _, (gd, gm, _, gpv)) = slice_runs
    np.testing.assert_array_equal(gpv.numpy(), np.asarray(wpv))
    np.testing.assert_array_equal(gd.valid.numpy(), np.asarray(wd.valid))
    np.testing.assert_array_equal(gd.labels.numpy(), np.asarray(wd.labels))
    assert gd.valid.any()
    np.testing.assert_allclose(gd.scores.numpy(), np.asarray(wd.scores), atol=2e-3)
    np.testing.assert_allclose(gd.boxes.numpy(), np.asarray(wd.boxes), atol=1e-2)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-2)


_STAGE_LINES = {
    "rpn_falkon": "RPN's Online Classifier training time: T ",
    "rpn_rls": "RPN's Online Region Refiner training time: T ",
    "det_rls": "Detector's Online Region Refiner training time: T ",
    "det_falkon": "Detector's Online Classifier training time: T ",
    "segm_falkon": "Online Segmentation training time: T ",
}


def test_training_stages_and_result_lines_match_jax(slice_runs):
    assert TRAINING["port_lines"] == TRAINING["jax_lines"]
    stage_lines = [line for line in TRAINING["jax_lines"] if line.strip()]
    assert list(TRAINING["timings"]) == list(_STAGE_LINES)
    assert stage_lines == list(_STAGE_LINES.values())


def test_stage_clocks_start_after_feature_stats_and_a_sync(slice_runs):
    events = TRAINING["events"]
    starts = [i for i, e in enumerate(events) if e == "stats"]
    assert len(starts) == 3  # rpn_falkon, det_rls, segm_falkon
    for i in starts:
        assert events[i + 1:i + 3] == ["sync", "clock"], events


# ---------------------------------------------------------------------------
# the inference stage: run_inference and its VOC07 scoring


class EvalTeachingSet(TinyTeachingSet):
    """The teaching set as a test set: class names, and no difficult object."""

    classes = ("__background__",) + tuple(f"object_{c}" for c in range(1, N_CLS + 1))

    def get_annotation(self, i):
        anno = super().get_annotation(i)
        anno.difficult = np.zeros(len(anno.labels), bool)
        return anno


INFER = dict(dcfg=None, with_masks=True, min_size=H, max_size=400, gt_cap=4, batch_size=3)


@pytest.fixture(scope="module", params=[False, True], ids=["detections", "gt_boxes"])
def inference_runs(slice_runs, tmp_path_factory, request):
    """(JAX results, predictions, result.txt lines), the same for the port:
    ``run_inference`` of each package with the JAX-trained models."""
    from online_detection_tpu.pipelines.online_pipeline import run_inference as j_run
    from online_detection_tpu_torch.models.weights import online_from_jax
    from online_detection_tpu_torch.pipelines.online_pipeline import run_inference

    (_, _, jonline, _), _ = slice_runs
    ds = EvalTeachingSet(N_IMG, H, W)
    kw = dict(INFER, eval_segm_with_gt_bboxes=request.param)
    jdir, pdir = (tmp_path_factory.mktemp(n) for n in ("jax_infer", "port_infer"))
    jres, jpred = j_run(TRAINING["jtree"], jonline, ds, (H, W), output_dir=str(jdir),
                        **dict(kw, dcfg=jdet.DetectorConfig(**DCFG)))
    res, pred = run_inference(TRAINING["params"], online_from_jax(jonline), ds, (H, W),
                              output_dir=str(pdir), device="cpu",
                              **dict(kw, dcfg=detector.DetectorConfig(**DCFG)))
    mask_time = lambda lines: [re.sub(r"\d+\.\d+ seconds", "T seconds", ln) for ln in lines]
    return ((jres, jpred, mask_time(_result_lines(jdir))),
            (res, pred, mask_time(_result_lines(pdir))))


def test_run_inference_predictions_match(inference_runs):
    (_, jpred, _), (_, pred, _) = inference_runs
    assert len(pred) == len(jpred) == N_IMG
    for k, (g, w) in enumerate(zip(pred, jpred)):
        assert sorted(g) == sorted(w) == ["boxes", "labels", "masks", "scores"]
        assert len(g["labels"]) == len(w["labels"]) > 0, k
        np.testing.assert_array_equal(g["labels"], w["labels"], err_msg=str(k))
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-2, err_msg=str(k))
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2e-3, err_msg=str(k))
        np.testing.assert_allclose(g["masks"], w["masks"], atol=1e-2, err_msg=str(k))


def test_run_inference_map_matches(inference_runs):
    (jres, _, _), (res, _, _) = inference_runs
    assert sorted(res) == sorted(jres) == ["det_ap_0.5", "det_map_0.5", "segm_ap_0.5",
                                           "segm_map_0.5"]
    for k in ("det_map_0.5", "segm_map_0.5"):
        assert abs(res[k] - jres[k]) <= 1e-3, (k, res[k], jres[k])
    for k in ("det_ap_0.5", "segm_ap_0.5"):
        np.testing.assert_allclose(res[k], jres[k], atol=1e-3, err_msg=k)
    assert max(res["det_map_0.5"], res["segm_map_0.5"]) > 0  # not 0 against 0


def test_run_inference_result_lines_match(inference_runs):
    (_, _, jlines), (_, _, lines) = inference_runs
    assert lines == jlines
    assert lines[0] == "Average image testing time: T seconds."
    assert any(ln.startswith("Detection mAP50: ") for ln in lines)
    assert any(ln.startswith("Segmentation mAP50: ") for ln in lines)


def test_detect_with_gt_boxes_matches_jax(slice_runs):
    """The single-image ``detect`` with GT arguments: the detections are the
    GT (labels, score 1, padding zeroed) and the masks are computed on them."""
    from online_detection_tpu_torch.models.weights import online_from_jax

    (_, _, jonline, _), _ = slice_runs
    ds = TinyTeachingSet(N_IMG, H, W)
    image = ds.load_image(1)
    size = np.array([W, H], np.float32)
    anchors = grid_anchors(H // 16, W // 16)
    gb = np.zeros((4, 4), np.float32)
    gb[:2] = [ds.get_annotation(1).boxes[0], [8.0, 10.0, 60.0, 70.0]]
    gl = np.array([2, 3, 0, 0], np.int32)
    gv = np.array([True, True, False, False])
    jd, jm, jp, jpv = jdet.detect(TRAINING["jtree"], jonline, jnp.asarray(anchors),
                                  jnp.asarray(image), jnp.asarray(size),
                                  jdet.DetectorConfig(**DCFG), True, jnp.asarray(gb),
                                  jnp.asarray(gl), jnp.asarray(gv))
    d, m, p, pv = detector.detect(TRAINING["params"], online_from_jax(jonline), anchors, image,
                                  size, detector.DetectorConfig(**DCFG), True, gb, gl, gv,
                                  device="cpu")
    np.testing.assert_array_equal(d.valid.numpy(), gv)
    np.testing.assert_array_equal(d.labels.numpy(), np.asarray(jd.labels))
    np.testing.assert_array_equal(d.boxes.numpy(), np.asarray(jd.boxes))
    np.testing.assert_array_equal(d.scores.numpy(), np.asarray(jd.scores))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jpv))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-2)
    assert m.shape == (4, 14, 14)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-2)
