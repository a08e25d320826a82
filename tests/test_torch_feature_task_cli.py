"""The checkpoint CLIs and the FeatureExtractor facade through both packages
on the CPU, on one ``make_synthetic_icwt`` tree:

- the port's feature-task tester with ``--CPU`` beside the JAX tester, with
  the same Caffe2 ``.pkl``, maskrcnn-benchmark ``.pth`` and pickled numpy
  parameter tree in ``--models_dir``: the same predictions per image (labels
  exact, boxes 1e-3 px, scores and masks 1e-5) and det / segm mAP within
  1e-6 per checkpoint;
- the port's ``weights_smoke``: ``--selftest`` passes, and ``--weights``
  prints the JAX script's stage names with checksums within rtol 1e-4;
- ``FeatureExtractor.testFeatureExtractor`` gives the JAX facade's results
  dict; ``trainFeatureExtractor`` trains a copy of its params.

The network is ``r50_narrow_tree`` (3/4/6/3 blocks, narrow widths) with a
box predictor over the dataset's 20 classes whose biases favour the two
classes the images hold, so some detections hit and the mAPs are not 0."""

import json
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from online_detection_tpu.data.datasets.icubworld import ICubWorldDataset as JDataset
from online_detection_tpu.data import loader as j_loader
from online_detection_tpu.data.evaluation import voc_eval as j_voc_eval
from online_detection_tpu.modules.feature_extractor import FeatureExtractor as JFeatureExtractor
from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.data.evaluation import voc_eval as p_voc_eval
from online_detection_tpu_torch.experiments import run_experiment_test_feature_task as tester
from online_detection_tpu_torch.experiments import weights_smoke
from online_detection_tpu_torch.models.weights import params_from_jax
from online_detection_tpu_torch.modules.feature_extractor import FeatureExtractor
from tests.test_experiment_cli import FEAT_CFG
from tests.test_torch_weights import r50_narrow_tree, write_pkl, write_pth

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
import run_experiment_test_feature_task as jax_tester  # noqa: E402
import weights_smoke as jax_weights_smoke  # noqa: E402

torch.set_num_threads(2)

N_CLS = 19  # the YCB-V in-hand table has 19 classes and the background
FAVOURED = (10, 13)  # 011_banana and 025_mug, the synthetic tree's classes
# the 32- and 64-pixel anchors (ratio-major order), the objects' scale here
SMALL_ANCHORS = [0, 1, 5, 6, 10, 11]


def checkpoint_tree(seed):
    """``r50_narrow_tree`` whose RPN proposes the small anchors and whose box
    predictor keeps only the two favoured classes above the score threshold,
    with scores spread apart far beyond the tolerance."""
    tree = r50_narrow_tree(seed=seed, n_cls=N_CLS)
    tree["rpn"]["cls_b"][:] = -5.0
    tree["rpn"]["cls_b"][SMALL_ANCHORS] = 5.0
    bp = tree["box_predictor"]
    bp["cls_w"] = bp["cls_w"] * np.float32(0.05)
    bp["cls_b"][1:] = -4.0
    bp["cls_b"][list(FAVOURED)] = 0.0
    return tree


class Recorder:
    """Wraps a ``voc_eval.evaluate`` and keeps each call's predictions."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, predictions, *args, **kw):
        self.calls.append(predictions)
        return self.fn(predictions, *args, **kw)


def assert_same_predictions(got, want, masks):
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
        assert ("masks" in g) == ("masks" in w) == masks
        if masks:
            np.testing.assert_allclose(g["masks"], w["masks"], atol=1e-5)
        n += len(g["labels"])
    assert n > 0


def assert_same_results(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("feature_task")
    root = str(tmp / "ycbv_synth")
    make_synthetic_icwt(root, n_train=2, n_test=3)
    feat = tmp / "feat.yaml"
    feat.write_text(FEAT_CFG.format(root=root))
    models = tmp / "models"
    models.mkdir()
    tree = checkpoint_tree(2)
    pkl = write_pkl(models / "model_a.pkl", tree)
    write_pth(models / "model_b.pth", checkpoint_tree(1), prefix="module.", tensors=True)
    with open(models / "model_c.pkl", "wb") as f:
        pickle.dump(checkpoint_tree(3), f)  # the SGD trainers' numpy tree
    return {"tmp": tmp, "root": root, "feat": str(feat), "models": str(models), "pkl": pkl,
            "tree": tree}


def test_tester_cli_matches_jax(synth, monkeypatch):
    runs = {}
    for name, main, module in (("port", tester.main, p_voc_eval),
                               ("jax", jax_tester.main, j_voc_eval)):
        rec = Recorder(module.evaluate)
        monkeypatch.setattr(module, "evaluate", rec)
        out = str(synth["tmp"] / f"tester_{name}")
        results = main(["--output_dir", out, "--models_dir", synth["models"],
                        "--config_file", synth["feat"], "--CPU"])
        runs[name] = (results, rec.calls)
    (port, port_preds), (want, want_preds) = runs["port"], runs["jax"]
    assert sorted(port) == sorted(want)
    assert [os.path.basename(k) for k in port] == ["model_a.pkl", "model_b.pth", "model_c.pkl"]
    for i, path in enumerate(port):
        assert_same_results(port[path], want[path])
        assert_same_predictions(port_preds[i], want_preds[i], masks=True)
    assert max(r["det_map_0.5"] for r in port.values()) > 0


def test_tester_cli_without_checkpoints_returns_nothing(synth, tmp_path):
    assert tester.main(["--output_dir", str(tmp_path / "o"), "--models_dir", str(tmp_path),
                        "--config_file", synth["feat"], "--CPU"]) == {}


def test_weights_smoke_selftest_passes(capsys):
    sums = weights_smoke.selftest(seed=0, device="cpu")
    assert "backbone_c4" in sums and "cls_logits" in sums and "mask_deconv_256" in sums
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[-1]["selftest"] == "PASS"
    assert [ln["selftest"] for ln in lines[:2]] == ["caffe2_pkl", "torch_pth"]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_weights_smoke_prints_jax_stages(synth, capsys):
    weights_smoke.main(["--weights", synth["pkl"], "--CPU", "--seed", "1"])
    got = _json_lines(capsys.readouterr().out)
    jax_weights_smoke.main(["--weights", synth["pkl"], "--CPU", "--seed", "1"])
    want = _json_lines(capsys.readouterr().out)
    assert [g["stage"] for g in got] == [w["stage"] for w in want]
    assert len(got) == 8
    for g, w in zip(got, want):
        assert g["shape"] == list(w["shape"]), g["stage"]
        for field in ("mean", "std", "absmax"):
            np.testing.assert_allclose(g[field], w[field], rtol=1e-4, atol=1e-7,
                                       err_msg=f"{g['stage']}/{field}")


def test_feature_extractor_test_method_matches_jax(synth, monkeypatch):
    # the JAX facade's CanvasLoader would decode and resize with the native
    # prefetcher, whose resize is not PIL's; the port has no prefetcher yet
    # (ROADMAP.md §A item 2), so both take the PIL path here
    monkeypatch.setattr(j_loader.native_io, "available", lambda: False)
    kw = dict(cfg_path_target_task=synth["feat"], canvas_hw=(128, 192), min_size=128,
              max_size=320)
    runs = {}
    for name, module in (("port", p_voc_eval), ("jax", j_voc_eval)):
        rec = Recorder(module.evaluate)
        monkeypatch.setattr(module, "evaluate", rec)
        if name == "port":
            fe = FeatureExtractor(dataset=ICubWorldDataset(synth["root"], "Main", "test"),
                                  params=params_from_jax(synth["tree"]), device="cpu", **kw)
        else:
            fe = JFeatureExtractor(dataset=JDataset(synth["root"], "Main", "test"),
                                   params=jax.tree_util.tree_map(np.asarray, synth["tree"]), **kw)
        runs[name] = (fe.testFeatureExtractor(), rec.calls[0])
    assert_same_results(runs["port"][0], runs["jax"][0])
    assert "segm_map_0.5" in runs["port"][0]
    assert_same_predictions(runs["port"][1], runs["jax"][1], masks=True)
    # trainFeatureExtractor SGD-trains a copy of the facade's params
    start = params_from_jax(synth["tree"])
    fe_port = FeatureExtractor(dataset=ICubWorldDataset(synth["root"], "Main", "train"),
                               params=start, device="cpu", **kw)
    trained = fe_port.trainFeatureExtractor(sgd=dict(max_iter=1, warmup_iters=0, base_lr=0.005,
                                                     post_nms_train=30, roi_batch=32))
    assert trained is fe_port.params and trained is not start
    assert not torch.equal(trained.box_predictor.cls_w, start.box_predictor.cls_w)
    np.testing.assert_array_equal(start.box_predictor.cls_w.numpy(),
                                  synth["tree"]["box_predictor"]["cls_w"])
