"""API-parity facades: the reference's public module classes over the port's
functional internals (counterpart of ``modules/facades.py``).

A user of the reference keeps their orchestration code's shape:

    fe = FeatureExtractor(cfg_feat_path, cfg_online_path, dataset, params)
    feats = fe.extractFeaturesRPNDetector(is_train=True, ...)
    classifier = FALKONWrapper(cfg_online_path)
    oc = OnlineRegionClassifier(classifier, positives, negatives, stats, ...)
    models = oc.trainRegionClassifier(output_dir=...)
    refiner = RegionRefiner(cfg_online_path)
    regs = refiner.trainRegionRefiner(COXY, output_dir=...)
    evaluator = AccuracyEvaluatorStandalone(cfg_online_path)
    evaluator.evaluate(ground_truths, predictions)

The classes hold the config and the trained state; the compute is the
port's functions: ``mmv`` (the Gaussian-mmv kernel B1 on the card) for
``FALKONWrapper.predict``, the minibootstrap solver (B1 in its mining
passes) for ``trainRegionClassifier``, ``rls_fit`` for the refiner. Each
class runs on ``device`` (the card by default; on a host without one it
raises unless given ``device="cpu"``). Draws come from a CPU
``torch.Generator`` seeded 0 where the JAX package takes
``jax.random.key(0)``. The products run in IEEE fp32 (TF32 off,
``utils.device.ieee_fp32``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from online_detection_tpu_torch.config.config import load_yaml
from online_detection_tpu_torch.modules import abstract
from online_detection_tpu_torch.ops.gaussian_mmv import mmv
from online_detection_tpu_torch.solvers.falkon import (
    FalkonModel,
    falkon_fit,
    falkon_predict_classes,
    select_nystrom_centers,
)
from online_detection_tpu_torch.solvers.minibootstrap import (
    MinibootstrapParams,
    train_classifiers_minibootstrap,
)
from online_detection_tpu_torch.solvers.rls import RLSModel, rls_fit, rls_predict
from online_detection_tpu_torch.utils import boxes as box_ops
from online_detection_tpu_torch.utils.device import host_array, ieee_fp32, resolve_device
from online_detection_tpu_torch.utils.stats import FeatureStats, zscore


def _f32(a, dev: torch.device) -> torch.Tensor:
    """Array or tensor -> float32 tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev, torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev)


def _write_time(output_dir: Optional[str], name: str, dt: float):
    with open(os.path.join(output_dir, "result.txt"), "a") as fid:
        fid.write(name + "training time: {}min:{}s \n".format(int(dt / 60), round(dt % 60)))


class FALKONWrapper(abstract.ClassifierAbstract):
    """``FALKONWrapper_with_centers_selection.py:16-95``: builds and applies
    one Gaussian-kernel FALKON model per call, with the <= M/2-positives
    Nystrom center selection."""

    def __init__(self, cfg_path=None, is_rpn=False, is_segmentation=False, device=None):
        opts = {}
        if cfg_path is not None:
            cfg = load_yaml(cfg_path)
            if is_rpn:
                cfg = cfg.get("RPN", cfg)
            key = "ONLINE_SEGMENTATION" if is_segmentation else "ONLINE_REGION_CLASSIFIER"
            opts = cfg.get(key, {}).get("CLASSIFIER", {})
        self.sigma = opts.get("sigma", 5)
        self.lam = opts.get("lambda", 0.001)
        self.nyst_centers = opts.get("M", 1000)
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(0)

    @ieee_fp32()
    @torch.inference_mode()
    def train(self, X, y, sigma=None, lam=None) -> FalkonModel:
        sigma = self.sigma if sigma is None else sigma
        lam = self.lam if lam is None else lam
        x, y = _f32(X, self.device), _f32(y, self.device)
        every = torch.ones(y.shape[0], dtype=torch.bool, device=self.device)
        idx = select_nystrom_centers(y > 0, every, self.nyst_centers, self.generator)
        centers = x[idx]
        alpha = falkon_fit(x, y, every.float(), centers, float(sigma), float(lam))
        return FalkonModel(centers, alpha, torch.tensor(True, device=self.device),
                           float(sigma))

    @ieee_fp32()
    @torch.inference_mode()
    def predict(self, model: FalkonModel, X, y=None) -> torch.Tensor:
        return mmv(_f32(X, self.device), model.centers, model.alpha, model.sigma)

    def test(self):  # parity no-op (reference stub)
        pass


class OnlineRegionClassifier(abstract.RegionClassifierAbstract):
    """``OnlineRegionClassifier.py:19-227`` over the class-batched
    minibootstrap.

    positives: a list per class of [n_i, d] arrays; negatives: a list per
    class of per-batch arrays (the reference's layout). Training packs them
    into the solver's fixed-capacity masked buffers and trains all classes
    at once, on the classifier's device."""

    def __init__(self, classifier: FALKONWrapper, positives, negatives, stats,
                 cfg_path=None, is_rpn=False, is_segmentation=False):
        self.classifier = classifier
        self.device = classifier.device
        self.positives = positives
        self.negatives = negatives
        cfg = load_yaml(cfg_path) if cfg_path else {}
        if is_rpn:
            cfg = cfg.get("RPN", cfg)
        sect = cfg.get(
            "ONLINE_SEGMENTATION" if is_segmentation else "ONLINE_REGION_CLASSIFIER", {})
        self.hard_tresh = sect.get("MINIBOOTSTRAP", {}).get("HARD_THRESH", -0.7)
        self.easy_tresh = sect.get("MINIBOOTSTRAP", {}).get("EASY_THRESH", -0.9)
        self.lam = sect.get("CLASSIFIER", {}).get("lambda", classifier.lam)
        self.sigma = sect.get("CLASSIFIER", {}).get("sigma", classifier.sigma)
        if isinstance(stats, dict):
            stats = FeatureStats(*(_f32(stats[k], self.device)
                                   for k in ("mean", "std", "mean_norm")))
        self.stats = stats.to(self.device)
        self.num_classes = len(positives)
        self.models: Optional[FalkonModel] = None

    def _to_buffers(self):
        c = self.num_classes
        d = None
        for p in self.positives:
            if len(p):
                d = np.asarray(p).shape[1]
                break
        if d is None:
            for nb in self.negatives:
                for b in nb:
                    if len(b):
                        d = np.asarray(b).shape[1]
                        break
        p_cap = max(1, max((len(p) for p in self.positives), default=1))
        n_iter = max(1, max((len(n) for n in self.negatives), default=1))
        b_cap = max([1] + [len(b) for nb in self.negatives for b in nb])
        pos = np.zeros((c, p_cap, d), np.float32)
        pv = np.zeros((c, p_cap), bool)
        neg = np.zeros((c, n_iter, b_cap, d), np.float32)
        nv = np.zeros((c, n_iter, b_cap), bool)
        for i in range(c):
            n = len(self.positives[i])
            if n:
                pos[i, :n] = host_array(self.positives[i])
                pv[i, :n] = True
            for b, rows in enumerate(self.negatives[i]):
                if len(rows):
                    neg[i, b, : len(rows)] = host_array(rows)
                    nv[i, b, : len(rows)] = True
        return pos, pv, neg, nv

    def zScores(self, feat, target_norm=20):
        return zscore(_f32(feat, self.device), self.stats, target_norm)

    @ieee_fp32()
    @torch.inference_mode()
    def trainRegionClassifier(self, opts=None, output_dir=None) -> FalkonModel:
        dev = self.device
        pos, pv, neg, nv = (torch.from_numpy(a).to(dev) for a in self._to_buffers())
        pos = self.zScores(pos) * pv[..., None]
        neg = self.zScores(neg) * nv[..., None]
        t0 = time.time()
        self.models = train_classifiers_minibootstrap(
            pos, pv, neg, nv,
            MinibootstrapParams(m=self.classifier.nyst_centers, sigma=float(self.sigma),
                                lam=float(self.lam), hard_thresh=self.hard_tresh,
                                easy_thresh=self.easy_tresh),
            generator=torch.Generator().manual_seed(0))
        if output_dir:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            _write_time(output_dir, "Online Classifier ", time.time() - t0)
        return self.models

    def updateModel(self, cache: Dict) -> FalkonModel:
        """Retrains one class's FALKON from a {pos, neg} cache
        (``OnlineRegionClassifier.py:81-94``): the public incremental-
        retraining surface."""
        x_pos = np.asarray(host_array(cache["pos"]), np.float32)
        x_neg = np.asarray(host_array(cache["neg"]), np.float32)
        x = np.concatenate([x_pos, x_neg], axis=0)
        y = np.concatenate([np.ones(len(x_pos), np.float32),
                            -np.ones(len(x_neg), np.float32)])
        return self.classifier.train(x, y, sigma=self.sigma, lam=self.lam)

    @ieee_fp32()
    @torch.inference_mode()
    def testRegionClassifier(self, model: FalkonModel, test_boxes: List[Dict]):
        """Scores cached test_boxes (``OnlineRegionClassifier.py:182-219``):
        per image, z-scores the non-GT rows (``feat``: an array, or a tensor
        on any device) and gives [N, C+1] numpy scores with background -1."""
        predictions = []
        for entry in test_boxes:
            if entry is None:
                continue
            keep = ~np.asarray(entry["gt"]).astype(bool).reshape(-1)
            feats = self.zScores(entry["feat"])[torch.from_numpy(keep).to(self.device)]
            scores = host_array(falkon_predict_classes(model, feats))
            out = -np.ones((scores.shape[0], self.num_classes + 1), np.float32)
            out[:, 1:] = scores
            predictions.append({"boxes": np.asarray(entry["boxes"])[keep], "scores": out,
                                "img_size": entry["img_size"]})
        return predictions

    def predict(self, dataset):  # parity stub (reference leaves it empty)
        pass


class RegionRefiner(abstract.RegionRefinerAbstract):
    """``region-refiner/region_refiner.py:8-36`` with its trainer and its
    predictor."""

    def __init__(self, cfg_path=None, is_rpn=False, device=None):
        cfg = load_yaml(cfg_path) if cfg_path else {}
        if is_rpn:
            cfg = cfg.get("RPN", cfg)
        self.lam = float(cfg.get("REGION_REFINER", {}).get("opts", {}).get("lambda", 1000))
        self.num_classes = (len(cfg.get("CHOSEN_CLASSES", {})) - 1
                            if cfg.get("CHOSEN_CLASSES") else None)
        self.is_rpn = is_rpn
        self.device = resolve_device(device)
        self.models: Optional[RLSModel] = None

    @ieee_fp32()
    @torch.inference_mode()
    def trainRegionRefiner(self, COXY: Dict, output_dir=None) -> RLSModel:
        x = np.asarray(host_array(COXY["X"]), np.float32)
        y = np.asarray(host_array(COXY["Y"]), np.float32)
        c = np.asarray(host_array(COXY["C"])).reshape(-1).astype(int)
        if self.is_rpn:
            classes = sorted(set(c.tolist())) or [0]
            n_cls = max(classes) + 1
            base = 0
        else:
            # the JAX package's precedence, kept as it is:
            # (num_classes or c.max()) if len(c) else 1
            n_cls = self.num_classes or int(c.max()) if len(c) else 1
            base = 1
        cap = max(1, max((int((c == base + i).sum()) for i in range(n_cls)), default=1))
        d = x.shape[1] if len(x) else 1
        xb = np.zeros((n_cls, cap, d), np.float32)
        yb = np.zeros((n_cls, cap, 4), np.float32)
        w = np.zeros((n_cls, cap), np.float32)
        for i in range(n_cls):
            rows = c == base + i
            n = min(int(rows.sum()), cap)
            if n:
                xb[i, :n] = x[rows][:n]
                yb[i, :n] = y[rows][:n]
                w[i, :n] = 1.0
        t0 = time.time()
        dev = self.device
        self.models = rls_fit(*(torch.from_numpy(a).to(dev) for a in (xb, yb, w)), self.lam)
        if output_dir:
            name = "RPN's " if self.is_rpn else "Detector's "
            _write_time(output_dir, name + "Online Region Refiner ", time.time() - t0)
        return self.models

    @ieee_fp32()
    @torch.inference_mode()
    def predict(self, boxes, features, image_size) -> np.ndarray:
        """``region_predictor/predict_regions.py:16-80``: applies each class's
        refiner, decodes with the standalone predictor's eps width
        convention and clamps one-sidedly -> [N, C*4] numpy boxes."""
        dev = self.device
        deltas = rls_predict(self.models, _f32(features, dev))  # [N, C, 4]
        n, c = deltas.shape[0], deltas.shape[1]
        decoded = box_ops.decode_boxes(deltas.reshape(n, c * 4), _f32(boxes, dev),
                                       clip_exp=False,
                                       src_size_offset=float(np.spacing(1)))
        size = torch.tensor(tuple(image_size), dtype=torch.float32, device=dev)
        return host_array(box_ops.clip_boxes_one_sided(decoded, size))


class AccuracyEvaluatorStandalone:
    """``accuracy-evaluator/AccuracyEvaluator.py:11-43``: the standalone
    evaluator of the cached-test_boxes experiments
    (``run_experiment_online_rpn_ood.py:204-215``). It applies the
    standalone postprocessor to refined predictions
    (``testRegionClassifier``'s scores and ``RegionRefiner.predict``'s
    boxes) on ``device`` and runs the VOC evaluator on the survivors.

    ``predictions``: per-image dicts with ``boxes`` [N, (C+1)*4] (class 0 =
    the raw boxes, the ``predict_regions.py:74-77`` layout), ``scores``
    [N, C+1] and ``img_size`` (w, h). ``ground_truths``: the voc_eval dicts.
    """

    def __init__(self, cfg_path=None, output_folder=None, device=None):
        cfg = load_yaml(cfg_path) if cfg_path else {}
        ev = cfg.get("EVALUATION", {})
        self.score_thresh = float(ev.get("SCORE_THRESH", -2.0))
        self.nms = float(ev.get("NMS", 0.3))
        self.detections_per_img = int(ev.get("DETECTIONS_PER_IMAGE", 100))
        self.class_names = cfg.get("CHOSEN_CLASSES")
        self.output_folder = output_folder
        self.device = resolve_device(device)

    @ieee_fp32()
    @torch.inference_mode()
    def postprocess(self, predictions):
        from online_detection_tpu_torch.models.postprocess import (
            postprocess_detections_standalone,
        )

        dev = self.device
        out = []
        for p in predictions:
            boxes = np.asarray(host_array(p["boxes"]), np.float32)
            scores = np.asarray(host_array(p["scores"]), np.float32)
            if boxes.ndim == 3:  # [N, C+1, 4] -> [N, (C+1)*4]
                boxes = boxes.reshape(boxes.shape[0], -1)
            dets = postprocess_detections_standalone(
                _f32(boxes, dev), _f32(scores, dev),
                torch.ones((boxes.shape[0],), dtype=torch.bool, device=dev),
                tuple(p["img_size"]), score_thresh=self.score_thresh, nms_thresh=self.nms,
                detections_per_img=self.detections_per_img)
            keep = host_array(dets.valid)
            out.append({"boxes": host_array(dets.boxes)[keep],
                        "scores": host_array(dets.scores)[keep],
                        "labels": host_array(dets.labels)[keep]})
        return out

    def evaluate(self, ground_truths, predictions, iou_thresholds=(0.5,),
                 use_07_metric=True, class_names=None, **_):
        from online_detection_tpu_torch.data.evaluation import voc_eval

        names = class_names or self.class_names or [
            str(i) for i in range(np.asarray(predictions[0]["scores"]).shape[1])]
        return voc_eval.evaluate(
            self.postprocess(predictions), ground_truths, names,
            iou_thresholds=iou_thresholds, use_07_metric=use_07_metric,
            output_dir=self.output_folder)
