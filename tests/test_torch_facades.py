"""The module facades (``modules/facades.py``) of the port beside the JAX
package's, on the CPU: the five cases of ``tests/test_modules_facades.py``
(``FALKONWrapper``'s train and predict, ``OnlineRegionClassifier`` on the
reference's list-of-arrays layout with ``testRegionClassifier``,
``updateModel``, ``RegionRefiner`` on a COXY dict, and
``FeatureExtractor.testFeatureExtractor``), run through both packages on the
same numpy inputs, then ``AccuracyEvaluatorStandalone`` on the predictions
the two facades make.

The draws are sized away: each case's M is large enough that every row of
each solve is a Nystrom center (at most M/2 positives, the rest negatives),
so both packages fit the same centers. The JAX cases' own sizes (M = 32 and
16, with draws) run through the port alone with the JAX tests' quality
checks.

Tolerances: scores within 2e-3 (fp32 Cholesky solves in another order),
refined boxes within 1e-2 px, the evaluator's APs within 1e-6 on the same
predictions, and equal ``result.txt`` lines once the time is masked."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from online_detection_tpu.data.evaluation import voc_eval as j_voc_eval
from online_detection_tpu.modules import facades as jf
from online_detection_tpu.solvers.falkon import falkon_predict_classes as j_predict_classes
from online_detection_tpu_torch.data.evaluation import voc_eval as p_voc_eval
from online_detection_tpu_torch.modules import facades as pf
from online_detection_tpu_torch.solvers.falkon import falkon_predict_classes
from online_detection_tpu_torch.utils import boxes as p_boxes

torch.set_num_threads(2)

D = 6


def _mk(rng):
    return lambda n, shift: (rng.normal(size=(n, D)) + shift).astype(np.float32)  # noqa: E731


def _stats():
    return {"mean": np.zeros(D, np.float32), "std": np.ones(D, np.float32),
            "mean_norm": np.float32(20.0)}


def _wrappers(sigma, lam, m):
    jw, pw = jf.FALKONWrapper(), pf.FALKONWrapper(device="cpu")
    for w in (jw, pw):
        w.sigma, w.lam, w.nyst_centers = sigma, lam, m
    return jw, pw


def _times_masked(path):
    return [re.sub(r"\d+min:\d+s", "T", ln) for ln in path.read_text().splitlines()]


# ---------------------------------------------------------------------------
# FALKONWrapper


def test_falkon_wrapper_train_predict_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    y = np.sign(x[:, 0]).astype(np.float32)
    jw, pw = _wrappers(2.0, 1e-5, 256)  # every row a center
    jm, pm = jw.train(x, y), pw.train(x, y)
    assert pm.alpha.shape == (256,) and pm.centers.shape == (256, 8) and bool(pm.exists)
    np.testing.assert_array_equal(pm.centers.numpy(), np.asarray(jm.centers))
    probe = rng.normal(size=(64, 8)).astype(np.float32)
    for rows in (x, probe):
        got, want = pw.predict(pm, rows).numpy(), np.asarray(jw.predict(jm, rows))
        np.testing.assert_allclose(got, want, atol=2e-3)
    assert ((pw.predict(pm, x).numpy() > 0) == (y > 0)).mean() > 0.9


def test_falkon_wrapper_with_draws_learns():
    """The JAX case's sizes (M = 32 < the positives): the centers are drawn
    from the wrapper's generator; each call draws anew."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 8)).astype(np.float32)
    y = np.sign(x[:, 0]).astype(np.float32)
    _, w = _wrappers(2.0, 1e-5, 32)
    model = w.train(x, y)
    assert ((w.predict(model, x).numpy() > 0) == (y > 0)).mean() > 0.9
    again = w.train(x, y)
    assert not torch.equal(again.centers, model.centers)


def test_falkon_wrapper_reads_its_yaml(tmp_path):
    cfg = tmp_path / "online.yaml"
    cfg.write_text("ONLINE_REGION_CLASSIFIER:\n  CLASSIFIER: {lambda: 0.01, sigma: 7, M: 12}\n"
                   "ONLINE_SEGMENTATION:\n  CLASSIFIER: {lambda: 0.02, sigma: 3, M: 8}\n"
                   "RPN:\n  ONLINE_REGION_CLASSIFIER:\n"
                   "    CLASSIFIER: {lambda: 0.5, sigma: 50, M: 24}\n")
    for kw in ({}, {"is_rpn": True}, {"is_segmentation": True}):
        j, p = jf.FALKONWrapper(str(cfg), **kw), pf.FALKONWrapper(str(cfg), device="cpu", **kw)
        assert (p.sigma, p.lam, p.nyst_centers) == (j.sigma, j.lam, j.nyst_centers), kw
    p = pf.FALKONWrapper(device="cpu")
    assert (p.sigma, p.lam, p.nyst_centers) == (5, 0.001, 1000)


# ---------------------------------------------------------------------------
# OnlineRegionClassifier


def _layout(rng):
    mk = _mk(rng)
    positives = [mk(30, 2.0), mk(25, -2.0)]
    negatives = [[mk(40, -1.0), mk(40, -1.5)], [mk(40, 1.0), mk(40, 1.5)]]
    test_boxes = [
        {"boxes": rng.uniform(0, 100, (10, 4)).astype(np.float32),
         "feat": rng.normal(size=(10, D)).astype(np.float32),
         "gt": np.concatenate([np.ones(2), np.zeros(8)]),
         "img_size": np.array([320, 240])},
        None,  # an image without cached boxes is skipped
        {"boxes": rng.uniform(0, 100, (6, 4)).astype(np.float32),
         "feat": (rng.normal(size=(6, D)) + 2.0).astype(np.float32),
         "gt": np.zeros(6), "img_size": np.array([320, 240])},
    ]
    return positives, negatives, test_boxes


def _classifiers(positives, negatives, m, lam=1e-5):
    jw, pw = _wrappers(3.0, lam, m)
    joc = jf.OnlineRegionClassifier(jw, positives, negatives, _stats())
    poc = pf.OnlineRegionClassifier(pw, positives, negatives, _stats())
    for oc in (joc, poc):
        oc.sigma, oc.lam = 3.0, lam
    return joc, poc


def test_online_region_classifier_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    positives, negatives, test_boxes = _layout(rng)
    # M = 128: 30 positives and up to 80 negatives, every cache row a center
    joc, poc = _classifiers(positives, negatives, 128)
    for got, want in zip(poc._to_buffers(), joc._to_buffers()):
        np.testing.assert_array_equal(got, want)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jmodels = joc.trainRegionClassifier(output_dir=str(tmp_path / "jax"))
    pmodels = poc.trainRegionClassifier(output_dir=str(tmp_path / "port"))
    assert pmodels.alpha.shape == (2, 128) and pmodels.exists.all()
    np.testing.assert_array_equal(pmodels.exists.numpy(), np.asarray(jmodels.exists))
    probe = np.concatenate([positives[0], positives[1], rng.normal(size=(20, D)) * 2])
    probe = probe.astype(np.float32)
    got = falkon_predict_classes(pmodels, poc.zScores(probe)).numpy()
    want = np.asarray(j_predict_classes(jmodels, joc.zScores(probe)))
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert (got[:30, 0] > 0).mean() > 0.8
    lines = _times_masked(tmp_path / "port" / "result.txt")
    assert lines == _times_masked(tmp_path / "jax" / "result.txt")
    assert lines == ["Online Classifier training time: T "]

    jpred = joc.testRegionClassifier(jmodels, test_boxes)
    ppred = poc.testRegionClassifier(pmodels, test_boxes)
    assert len(ppred) == len(jpred) == 2
    assert ppred[0]["scores"].shape == (8, 3)  # non-GT rows x (bg + 2 classes)
    for g, w in zip(ppred, jpred):
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["img_size"], w["img_size"])
        np.testing.assert_array_equal(g["scores"][:, 0], -1.0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2e-3)


def test_online_region_classifier_with_draws_learns():
    """The JAX case's sizes (M = 16): drawn centers, the JAX test's checks."""
    rng = np.random.default_rng(0)
    positives, negatives, test_boxes = _layout(rng)
    _, oc = _classifiers(positives, negatives, 16)
    models = oc.trainRegionClassifier()
    assert models.alpha.shape == (2, 16)
    scores = falkon_predict_classes(models, torch.from_numpy(positives[0])).numpy()
    assert (scores[:, 0] > 0).mean() > 0.8
    preds = oc.testRegionClassifier(models, test_boxes)
    assert preds[0]["scores"].shape == (8, 3)
    np.testing.assert_allclose(preds[0]["scores"][:, 0], -1.0)


def test_update_model_matches_jax():
    """``updateModel`` (``OnlineRegionClassifier.py:81-94``): one class
    retrained from a {pos, neg} cache, twice, as the incremental teacher
    does."""
    rng = np.random.default_rng(2)
    mk = _mk(rng)
    joc, poc = _classifiers([mk(10, 2.0)], [[mk(10, -2.0)]], 128)
    cache = {"pos": mk(30, 2.0), "neg": mk(60, -2.0)}
    probe_pos, probe_neg = mk(20, 2.0), mk(20, -2.0)
    for step in range(2):
        jm, pm = joc.updateModel(cache), poc.updateModel(cache)
        for rows in (probe_pos, probe_neg):
            np.testing.assert_allclose(poc.classifier.predict(pm, rows).numpy(),
                                       np.asarray(joc.classifier.predict(jm, rows)), atol=2e-3)
        assert (poc.classifier.predict(pm, probe_pos).numpy() > 0).mean() > 0.9
        assert (poc.classifier.predict(pm, probe_neg).numpy() < 0).mean() > 0.9
        assert pm.centers.shape == (128, D)
        cache["neg"] = np.concatenate([cache["neg"], mk(30, -1.0)])


# ---------------------------------------------------------------------------
# RegionRefiner


def _coxy(rng, n=120, d=10, classes=1):
    x = rng.normal(size=(n, d)).astype(np.float32)
    wtrue = rng.normal(size=(d, 4)) * 0.1
    y = (x @ wtrue).astype(np.float32)
    c = (np.arange(n) % classes + 1).astype(np.float32)
    return {"X": x, "Y": y, "C": c, "O": None}


def _boxes(rng, n):
    boxes = rng.uniform(10, 50, (n, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    return boxes


@pytest.mark.parametrize("classes, num_classes, is_rpn",
                         [(1, 1, False), (3, None, False), (3, 4, False), (4, None, True)])
def test_region_refiner_matches_jax(tmp_path, classes, num_classes, is_rpn):
    rng = np.random.default_rng(3 + classes)
    coxy = _coxy(rng, classes=classes)
    if is_rpn:
        coxy["C"] = coxy["C"] - 1  # anchor classes are 0-based
    jr, pr = jf.RegionRefiner(is_rpn=is_rpn), pf.RegionRefiner(is_rpn=is_rpn, device="cpu")
    for r in (jr, pr):
        r.lam, r.num_classes = 1.0, num_classes
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    jm = jr.trainRegionRefiner(coxy, output_dir=str(tmp_path / "jax"))
    pm = pr.trainRegionRefiner(coxy, output_dir=str(tmp_path / "port"))
    n_cls = classes if num_classes is None else num_classes
    assert pm.beta.shape == tuple(jm.beta.shape) == (n_cls, 11, 4)
    np.testing.assert_array_equal(pm.exists.numpy(), np.asarray(jm.exists))
    lines = _times_masked(tmp_path / "port" / "result.txt")
    assert lines == _times_masked(tmp_path / "jax" / "result.txt")
    assert lines == [("RPN's " if is_rpn else "Detector's ")
                     + "Online Region Refiner training time: T "]
    boxes = _boxes(rng, 9)
    boxes[0] = [300.0, 230.0, 330.0, 260.0]  # past the image: the one-sided clamp bites
    got = pr.predict(boxes, coxy["X"][:9], (320, 240))
    want = np.asarray(jr.predict(boxes, coxy["X"][:9], (320, 240)))
    assert got.shape == want.shape == (9, n_cls * 4)
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert got[0, 2] <= 319.0 and got[0, 0] >= 0.0


def test_decode_with_the_eps_width_convention_matches_jax():
    from online_detection_tpu.utils import boxes as j_boxes

    rng = np.random.default_rng(4)
    boxes = _boxes(rng, 7)
    boxes[1, 2] = boxes[1, 0]  # a zero-width box: eps, not 1
    deltas = (rng.normal(size=(7, 12)) * 0.3).astype(np.float32)
    for offset in (1.0, float(np.spacing(1))):
        want = j_boxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(boxes), clip_exp=False,
                                    src_size_offset=offset)
        got = p_boxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(boxes),
                                   clip_exp=False, src_size_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# AccuracyEvaluatorStandalone


def _standalone_predictions(rng, n_img=3, n=12, classes=2):
    """Classifier scores and refined boxes of the two facades, the
    ``predict_regions.py:74-77`` layout: [N, (C+1)*4], class 0 the raw boxes."""
    coxy = _coxy(rng, n=90, d=D, classes=classes)
    coxy["Y"] *= 0.1  # refinements of a few pixels: the GT boxes below stay matched
    positives = [coxy["X"][coxy["C"] == c + 1] for c in range(classes)]
    negatives = [[coxy["X"][coxy["C"] != c + 1]] for c in range(classes)]
    # 45 positives and 45 negatives a class in one batch, every row a center
    joc, poc = _classifiers(positives, negatives, 128, lam=1e-3)
    jm, pm = joc.trainRegionClassifier(), poc.trainRegionClassifier()
    jr, pr = jf.RegionRefiner(), pf.RegionRefiner(device="cpu")
    for r in (jr, pr):
        r.lam, r.num_classes = 1.0, classes
    jreg, _ = jr.trainRegionRefiner(coxy), pr.trainRegionRefiner(coxy)
    test_boxes, gts = [], []
    for _ in range(n_img):
        boxes = _boxes(rng, n) * 3
        feat = rng.normal(size=(n, D)).astype(np.float32) + 2.0 * rng.choice([-1, 1], (n, 1))
        test_boxes.append({"boxes": boxes, "feat": feat.astype(np.float32),
                           "gt": np.zeros(n), "img_size": (320, 240)})
        gts.append({"boxes": boxes[:3].copy(), "labels": None, "difficult": np.zeros(3, bool)})
    out = {}
    for name, oc, models, r in (("jax", joc, jm, jr), ("port", poc, pm, pr)):
        preds = oc.testRegionClassifier(models, test_boxes)
        for p, t in zip(preds, test_boxes):
            refined = np.asarray(r.predict(p["boxes"], t["feat"], p["img_size"]))
            p["boxes"] = np.concatenate([p["boxes"], refined], axis=1)
        out[name] = preds
    for gt, p in zip(gts, out["jax"]):  # each GT the class its row scores highest
        gt["labels"] = p["scores"][:3, 1:].argmax(1) + 1
    return out, gts


def test_accuracy_evaluator_standalone_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    preds, gts = _standalone_predictions(rng)
    for g, w in zip(preds["port"], preds["jax"]):
        assert g["boxes"].shape == w["boxes"].shape == (12, 12)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-2)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2e-3)
    names = ["__background__", "a", "b"]
    je = jf.AccuracyEvaluatorStandalone()
    pe = pf.AccuracyEvaluatorStandalone(device="cpu")
    for e in (je, pe):
        e.detections_per_img = 5  # the cap with its ties
    # the same predictions through both evaluators: the JAX facade's
    same = preds["jax"]
    jpost, ppost = je.postprocess(same), pe.postprocess(same)
    for g, w in zip(ppost, jpost):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-6)
    assert sum(len(p["labels"]) for p in ppost) > 0
    want = je.evaluate(gts, same, class_names=names)
    got = pe.evaluate(gts, same, class_names=names)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), atol=1e-6, err_msg=k)
    assert got["det_map_0.5"] > 0.0
    # each facade's own predictions, scored by its own evaluator
    own = pe.evaluate(gts, preds["port"], class_names=names)
    np.testing.assert_allclose(own["det_map_0.5"], want["det_map_0.5"], atol=0.05)
    # and the [N, C+1, 4] layout is taken as the flat one
    flat = [dict(p, boxes=p["boxes"].reshape(12, 3, 4)) for p in same]
    for g, w in zip(pe.postprocess(flat), ppost):
        np.testing.assert_array_equal(g["boxes"], w["boxes"])


def test_accuracy_evaluator_reads_its_yaml(tmp_path):
    cfg = tmp_path / "online.yaml"
    cfg.write_text("EVALUATION: {SCORE_THRESH: 0.1, NMS: 0.5, DETECTIONS_PER_IMAGE: 7}\n"
                   "CHOSEN_CLASSES: {0: __background__, 1: a, 2: b}\n")
    j = jf.AccuracyEvaluatorStandalone(str(cfg), output_folder="x")
    p = pf.AccuracyEvaluatorStandalone(str(cfg), output_folder="x", device="cpu")
    for k in ("score_thresh", "nms", "detections_per_img", "class_names", "output_folder"):
        assert getattr(p, k) == getattr(j, k), k
    assert pf.RegionRefiner(str(cfg), device="cpu").num_classes == 2


# ---------------------------------------------------------------------------
# FeatureExtractor.testFeatureExtractor


def test_feature_extractor_test_method_matches_jax(tmp_path, monkeypatch):
    """The stock softmax path over the extractor itself (TesterFeatureTask
    parity), through both facades on one synthetic tree, as
    ``tests/test_torch_feature_task_cli.py`` holds it."""
    from online_detection_tpu.data import loader as j_loader
    from online_detection_tpu.data.datasets.icubworld import ICubWorldDataset as JDataset
    from online_detection_tpu.modules.feature_extractor import FeatureExtractor as JFE
    from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset
    from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
    from online_detection_tpu_torch.models.weights import params_from_jax
    from online_detection_tpu_torch.modules.feature_extractor import FeatureExtractor
    from tests.test_torch_feature_task_cli import Recorder, assert_same_results, checkpoint_tree

    monkeypatch.setattr(j_loader.native_io, "available", lambda: False)  # PIL on both sides
    root = str(tmp_path / "ycbv_synth")  # the directory name selects the class table
    make_synthetic_icwt(root, n_train=2, n_test=2)
    tree = checkpoint_tree(2)
    kw = dict(canvas_hw=(128, 192), min_size=128, max_size=320)
    runs = {}
    for name, module in (("port", p_voc_eval), ("jax", j_voc_eval)):
        rec = Recorder(module.evaluate)
        monkeypatch.setattr(module, "evaluate", rec)
        if name == "port":
            fe = FeatureExtractor(dataset=ICubWorldDataset(root, "Main", "test"),
                                  params=params_from_jax(tree), device="cpu", **kw)
        else:
            fe = JFE(dataset=JDataset(root, "Main", "test"),
                     params=jax.tree_util.tree_map(np.asarray, tree), **kw)
        runs[name] = (fe.testFeatureExtractor(), rec.calls[0])
    assert_same_results(runs["port"][0], runs["jax"][0])
    assert any(k.endswith("map_0.5") for k in runs["port"][0])
    for g, w in zip(runs["port"][1], runs["jax"][1]):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=2e-3)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-2)


def test_facades_without_device_raise_before_running(monkeypatch):
    """With no ``device`` the facades target the card; on a host with no card
    they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (pf.FALKONWrapper, pf.RegionRefiner, pf.AccuracyEvaluatorStandalone):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
