"""FeatureExtractor and AccuracyEvaluator facades (counterpart of the JAX
package's ``modules/feature_extractor.py``).

``FeatureExtractor``'s ``extract*`` methods run the port's host-route
harvest (``harvest_dataset``) with the flags of each reference backend
(``feature-extractor/feature_extractor.py:10-82``), and the injected on-line
RPN models (``falkon_rpn_models`` etc.) become its ``online_rpn`` argument.
``trainFeatureExtractor`` SGD-trains the network (``engine/trainer.py::
do_train``), and ``testFeatureExtractor`` evaluates it through the stock
softmax path (``detect_pretrained``). ``AccuracyEvaluator`` runs
``run_inference`` with the on-line models passed in. Both run on ``device``
(the card by default; the parameters are moved there).
"""

from __future__ import annotations

from typing import Optional

import torch

from online_detection_tpu_torch.config.config import build_configs, load_yaml
from online_detection_tpu_torch.models.detector import DetectorConfig, OnlineModelSet
from online_detection_tpu_torch.models.rpn import OnlineRPNModels
from online_detection_tpu_torch.modules import abstract
from online_detection_tpu_torch.pipelines import online_pipeline as pipe
from online_detection_tpu_torch.utils import checkpoint
from online_detection_tpu_torch.utils.device import resolve_device


class FeatureExtractor(abstract.FeatureExtractorAbstract):
    """Facade over ``harvest_dataset`` with ``FeatureExtractor``'s public
    methods. Built from config paths, a dataset and the network's
    ``DetectorParams``; the harvest's draws come from a ``torch.Generator``
    seeded with ``seed``, on the CPU (so a card run and a CPU run draw
    alike)."""

    def __init__(self, cfg_path_target_task: Optional[str] = None,
                 cfg_online_path: Optional[str] = None, dataset=None, params=None,
                 canvas_hw=None, min_size: int = 600, max_size: int = 1333, seed: int = 0,
                 device=None):
        feat_cfg = load_yaml(cfg_path_target_task) if cfg_path_target_task else {}
        online_cfg = load_yaml(cfg_online_path) if cfg_online_path else {}
        self.train_cfg, self.det_cfg, self.extras = build_configs(feat_cfg, online_cfg)
        self.device = resolve_device(device)
        self.dataset = dataset
        self.params = None if params is None else params.to(self.device)
        self.canvas_hw = canvas_hw
        self.min_size = min_size
        self.max_size = max_size
        self.generator = torch.Generator().manual_seed(seed)
        # injection points of the reference's attribute assignment
        # (``run_experiment_online_rpn_ood_oos_serial.py:119-125``)
        self.falkon_rpn_models = None
        self.regressors_rpn_models = None
        self.stats_rpn = None

    def _injected_rpn(self) -> Optional[OnlineRPNModels]:
        if self.falkon_rpn_models is None:
            return None
        return OnlineRPNModels(self.falkon_rpn_models, self.regressors_rpn_models,
                               self.stats_rpn).to(self.device)

    def _harvest(self, cfg, output_dir=None, online_rpn=None):
        return pipe.harvest_dataset(
            self.generator, self.params, self.dataset, cfg, self.canvas_hw,
            online_rpn=online_rpn, dcfg=self.det_cfg, output_dir=output_dir,
            min_size=self.min_size, max_size=self.max_size, device=self.device)

    # the four reference methods (feature_extractor.py:33-82)

    def extractRPNFeatures(self, is_train=True, output_dir=None, save_features=False):
        harvest = self._harvest(self.train_cfg._replace(with_segmentation=False), output_dir)
        if save_features and output_dir:
            checkpoint.save_features(output_dir, {"rpn": harvest["rpn"]})
        return harvest["rpn"]

    def extractFeatures(self, is_train=True, output_dir=None, save_features=False,
                        extract_features_segmentation=False):
        cfg = self.train_cfg._replace(with_rpn=False,
                                      with_segmentation=extract_features_segmentation)
        harvest = self._harvest(cfg, output_dir, online_rpn=self._injected_rpn())
        if save_features and output_dir:
            checkpoint.save_features(output_dir, harvest)
        return harvest

    def extractFeaturesRPNDetector(self, is_train=True, output_dir=None, save_features=False,
                                   extract_features_segmentation=False):
        cfg = self.train_cfg._replace(with_segmentation=extract_features_segmentation)
        harvest = self._harvest(cfg, output_dir)
        if save_features and output_dir:
            checkpoint.save_features(output_dir, harvest)
        return harvest

    def trainFeatureExtractor(self, output_dir=None, **kw):
        """SGD-trains the network on the dataset (``do_train``; ``sgd``: the
        ``SGDConfig`` fields, ``time_budget``: seconds) with the facade's
        generator; the trained params replace ``self.params`` and are
        returned."""
        from online_detection_tpu_torch.engine.trainer import SGDConfig, do_train

        cfg = SGDConfig(**kw.get("sgd", {}))
        params, _ = do_train(
            self.params, self.dataset, self.canvas_hw, cfg, self.generator,
            with_mask=self.extras.get("mask_on", False), time_budget=kw.get("time_budget"),
            min_size=self.min_size, max_size=self.max_size, device=self.device)
        self.params = params
        return params

    def testFeatureExtractor(self, output_dir=None, dataset=None, score_thresh: float = 0.05,
                             nms_thresh: float = 0.5):
        """Evaluates the network itself with the stock softmax path
        (``TesterFeatureTask``, ``test_feature_task.py:66-125``) -> the VOC
        results dict; writes result.txt when ``output_dir`` is given. Masks
        are scored when MASK_ON is set and the network has a mask head."""
        from online_detection_tpu_torch.data.evaluation import voc_eval
        from online_detection_tpu_torch.data.loader import CanvasLoader
        from online_detection_tpu_torch.models.anchors import grid_anchors
        from online_detection_tpu_torch.models.detector import detect_pretrained

        ds = dataset if dataset is not None else self.dataset
        dev = self.device
        ch, cw = self.canvas_hw
        anchors = torch.from_numpy(grid_anchors(ch // 16, cw // 16)).to(dev)
        with_masks = bool(self.extras.get("mask_on", False)) and self.params.mask_head is not None
        predictions, ground_truths = [], []
        with CanvasLoader(ds, self.canvas_hw, self.min_size, self.max_size) as loader:
            for i in range(len(ds)):
                anno = ds.get_annotation(i)
                canvas, scale, (sw, sh) = loader.get(i)
                dets, mask_probs, _, _ = detect_pretrained(
                    self.params, anchors, torch.from_numpy(canvas), (sw, sh), self.det_cfg,
                    with_masks=with_masks, score_thresh=score_thresh, nms_thresh=nms_thresh,
                    device=dev)
                v = dets.valid.cpu().numpy()
                pred = {"boxes": dets.boxes.cpu().numpy()[v] / scale,
                        "scores": dets.scores.cpu().numpy()[v],
                        "labels": dets.labels.cpu().numpy()[v]}
                if with_masks:
                    pred["masks"] = mask_probs.cpu().numpy()[v]
                predictions.append(pred)
                gt = {"boxes": anno.boxes, "labels": anno.labels, "difficult": anno.difficult}
                if with_masks:
                    gt["masks"] = ds.load_masks(i, anno)
                ground_truths.append(gt)
        return voc_eval.evaluate(
            predictions, ground_truths, ds.classes,
            iou_thresholds=self.extras.get("iou_thresholds", (0.5,)),
            use_07_metric=self.extras.get("use_07_metric", True),
            evaluate_segmentation=with_masks, output_dir=output_dir)


class AccuracyEvaluator(abstract.AccuracyEvaluatorAbstract):
    """Facade over ``run_inference`` (``accuracy_evaluator.py`` +
    ``evaluate_accuracy_detector.py:131-196``): the on-line models are
    passed in, and moved to ``device`` with the network."""

    def __init__(self, params, dataset, canvas_hw, det_cfg: DetectorConfig,
                 iou_thresholds=(0.5,), use_07_metric=True, min_size=600, max_size=1333,
                 device=None):
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.dataset = dataset
        self.canvas_hw = canvas_hw
        self.det_cfg = det_cfg
        self.iou_thresholds = iou_thresholds
        self.use_07_metric = use_07_metric
        self.min_size = min_size
        self.max_size = max_size

    def evaluate(self, online: OnlineModelSet, output_dir=None, evaluate_segmentation=True):
        return self.evaluateAccuracyDetection(online, output_dir=output_dir,
                                              evaluate_segmentation=evaluate_segmentation)

    def evaluateAccuracyDetection(self, online: OnlineModelSet, is_train=False,
                                  output_dir=None, evaluate_segmentation=True, **_):
        results, _ = pipe.run_inference(
            self.params, online.to(self.device), self.dataset, self.canvas_hw, self.det_cfg,
            with_masks=evaluate_segmentation, output_dir=output_dir,
            iou_thresholds=self.iou_thresholds, use_07_metric=self.use_07_metric,
            min_size=self.min_size, max_size=self.max_size, device=self.device)
        return results
