"""Unified configuration: loads the reference's shipped YAML files unchanged
(a copy of the JAX package's ``config/config.py`` that builds the port's own
``DetectorConfig`` and ``OnlineTrainConfig``; PyYAML is imported only by
``load_yaml``).

The reference runs a three-headed config system (SURVEY.md §5): a yacs tree
for the CNN side (``config_feature_extraction_*`` / ``config_detector_*`` /
``config_rpn_*``), raw-YAML dicts for the on-line learners
(``config_online_*``), and argparse overrides. This module reads both YAML
families into plain dicts and projects them onto the framework's typed
configs (OnlineTrainConfig / DetectorConfig), so the 33 files under
``experiments/configs/`` work as-is.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Optional, Tuple

from online_detection_tpu_torch.models.detector import DetectorConfig
from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

# Dataset catalog: name -> (data_dir under Data/datasets, image_set, split)
# (``config/paths_catalog.py:107-274``; COCO/VOC/cityscapes entries are used
# only by the FEATURE-TASK baselines and resolve the same way when present.)
DATASET_CATALOG: Dict[str, Tuple[str, str, str]] = {
    "icubworld_id_100objects_train": ("iCWT/iCubWorld-Transformations", "", "old/train_iCWT_TASK1_100objs_feature"),
    "icubworld_id_100objects_test": ("iCWT/iCubWorld-Transformations", "", "old/test_iCWT_TASK1_100objs_feature"),
    "icubworld_id_30objects_train_target_task": ("iCWT/iCubWorld-Transformations", "", "train_TASK2_30objs_1over4"),
    "icubworld_id_30objects_train_val_target_task": ("iCWT/iCubWorld-Transformations", "", "train_TASK2_30objs_train_val"),
    "icubworld_id_30objects_val_target_task": ("iCWT/iCubWorld-Transformations", "", "old/val_TASK2_30objs_revisions"),
    "icubworld_id_30objects_test_target_task": ("iCWT/iCubWorld-Transformations_manual", "", "test_TASK2_30objs_manual"),
    "icubworld_id_21objects_train_target_task": ("iCWT/TABLE-TOP", "", "test_TASK2_21objs_white_train_sample_50"),
    "icubworld_id_21objects_train_val_target_task": ("iCWT/TABLE-TOP", "", "test_TASK2_21objs_white"),
    "icubworld_id_21objects_val_target_task": ("iCWT/TABLE-TOP", "", "test_TASK2_21objs_white_val_sample_50"),
    "icubworld_id_21objects_test_target_task": ("iCWT/TABLE-TOP", "", "test_TASK2_21objs_pois_odd"),
    "icubworld_id_21objects_train_target_task_with_masks": ("iCWT/TABLE-TOP-single-object-masks/train", "", "train_val_AutomSegm_tabletop_21objs"),
    "icubworld_id_21objects_test_target_task_with_masks": ("iCWT/TABLE-TOP-single-object-masks/test", "", "test_AutomSegm_tabletop_21objs"),
    "ycb_video_train_pbr": ("YCB-Video/train_pbr", "", "imageset_train"),
    "ycb_video_train_real": ("YCB-Video/train_real", "", "imageset_train"),
    "ycb_video_train_real_1_out_of_10": ("YCB-Video/train_real", "", "imageset_train_1_out_of_10"),
    "ycb_video_train_real_1_out_of_10_from_feat": ("YCB-Video/train_real", "", "imageset_train_1_out_of_10"),
    "ycb_video_test": ("YCB-Video/test", "", "imageset_test"),
    "ycb_video_test_keyframe": ("YCB-Video/test", "", "keyframe"),
    "ycb_video_val": ("YCB-Video/test", "", "imageset_val"),
    "ycb_video_demo": ("YCB-Video/test", "", "imageset_demo"),
    "ycb_video_test_1_out_of_10": ("YCB-Video/test", "", "imageset_test_1_out_of_10"),
    "ycb_video_train_pbr_1_out_of_3": ("YCB-Video/train_pbr", "", "imageset_train_1_out_of_3"),
    "ycbv_in_hand_icubworld_format": ("ycbv_in_hand", "", "train_imageset_first_200"),
    "ho3d_v2_train_icubworld_format": ("HO3D_V2_iCWT_format/train", "", "imageset_train"),
    "ho3d_v2_test_icubworld_format": ("HO3D_V2_iCWT_format/train", "", "imageset_test"),
    "ho3d_v2_train_icubworld_format_1_out_of_10": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_10"),
    "ho3d_v2_train_icubworld_format_1_out_of_5": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_5"),
    "ho3d_v2_train_icubworld_format_1_out_of_2": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_2"),
    "ho3d_v2_train_icubworld_format_1_out_of_2_from_feat": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_2"),
    "ho3d_v2_train_icubworld_format_1_out_of_2_3_seq": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_2_3_seq"),
    "ho3d_v2_train_icubworld_format_1_out_of_3": ("HO3D_V2_iCWT_format/train", "", "imageset_train_1_out_of_3"),
    "ho3d_v2_test_icubworld_format_1_out_of_5": ("HO3D_V2_iCWT_format/train", "", "imageset_test_1_out_of_5"),
    "ho3d_v2_val_icubworld_format_1_out_of_5": ("HO3D_V2_iCWT_format/train", "", "imageset_val_1_out_of_5"),
}

MODEL_CATALOG_WEIGHTS = {
    # catalog://... -> local filename users drop under Data/pretrained_feature_extractors
    "catalog://Caffe2Detectron/COCO/35858791/e2e_mask_rcnn_R-50-C4_1x": "e2e_mask_rcnn_R_50_C4_1x.pkl",
}


def load_yaml(path: str) -> Dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _get(d: Dict, path: str, default=None):
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def parse_dataset_tuple(value) -> Tuple[str, ...]:
    """yacs-style tuples arrive as strings like '("name",)' in raw YAML."""
    if isinstance(value, str):
        return tuple(x for x in ast.literal_eval(value) if x)
    if isinstance(value, (list, tuple)):
        return tuple(value)
    return ()


def resolve_dataset(name: str, data_root: str = "Data/datasets"):
    """name -> kwargs for ICubWorldDataset (or YCBVideoDataset for BOP names).

    Returns (factory_name, kwargs). ``ycb_video_*`` names use the BOP reader;
    everything else (incl. ho3d_v2_*/ycbv_in_hand, which are iCWT-format) the
    XML reader (``paths_catalog.get:275-349``). Names of the form
    ``path:<dir>:<image_set>:<split>`` bypass the catalog (custom datasets)."""
    if name.startswith("path:"):
        _, data_dir, image_set, split = name.split(":")
        return (
            "iCubWorldDataset",
            dict(data_dir=data_dir, image_set=image_set, split=split),
        )
    data_dir, image_set, split = DATASET_CATALOG[name]
    kwargs = dict(
        data_dir=os.path.join(data_root, data_dir),
        image_set=image_set,
        split=split,
    )
    if name.startswith("ycb_video"):
        return ("YCBVideoDataset", kwargs)
    factory = "iCubWorldDataset"
    kwargs["is_target_task"] = "target_task" in name
    kwargs["icwt_21_objs"] = "21objects" in name
    return (factory, kwargs)


def build_configs(
    feat_cfg: Dict,
    online_cfg: Dict,
    minibootstrap_iterations: Optional[int] = None,
) -> Tuple[OnlineTrainConfig, DetectorConfig, Dict]:
    """Project the two YAML dicts onto the typed configs.

    Returns (train_cfg, detector_cfg, extras) where extras carries dataset
    names, weight path, input sizes, evaluation thresholds, class names.
    """
    o = online_cfg
    mb_iters = minibootstrap_iterations or _get(
        feat_cfg, "MINIBOOTSTRAP.DETECTOR.ITERATIONS", 10
    )
    chosen = o.get("CHOSEN_CLASSES", {})
    num_classes = (len(chosen) - 1) if chosen else _get(
        feat_cfg, "MINIBOOTSTRAP.DETECTOR.NUM_CLASSES", 21
    )

    train_cfg = OnlineTrainConfig(
        num_classes=num_classes,
        det_sigma=_get(o, "ONLINE_REGION_CLASSIFIER.CLASSIFIER.sigma", 15.0),
        det_lam=_get(o, "ONLINE_REGION_CLASSIFIER.CLASSIFIER.lambda", 1e-5),
        det_m=_get(o, "ONLINE_REGION_CLASSIFIER.CLASSIFIER.M", 1000),
        rpn_sigma=_get(o, "RPN.ONLINE_REGION_CLASSIFIER.CLASSIFIER.sigma", 50.0),
        rpn_lam=_get(o, "RPN.ONLINE_REGION_CLASSIFIER.CLASSIFIER.lambda", 1e-3),
        rpn_m=_get(o, "RPN.ONLINE_REGION_CLASSIFIER.CLASSIFIER.M", 1000),
        segm_sigma=_get(o, "ONLINE_SEGMENTATION.CLASSIFIER.sigma", 10.0),
        segm_lam=_get(o, "ONLINE_SEGMENTATION.CLASSIFIER.lambda", 1e-6),
        segm_m=_get(o, "ONLINE_SEGMENTATION.CLASSIFIER.M", 500),
        det_reg_lam=float(_get(o, "REGION_REFINER.opts.lambda", 1000)),
        rpn_reg_lam=float(_get(o, "RPN.REGION_REFINER.opts.lambda", 0.01)),
        iterations=mb_iters,
        batch_size=_get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.BATCH_SIZE", 2000),
        hard_thresh=_get(o, "ONLINE_REGION_CLASSIFIER.MINIBOOTSTRAP.HARD_THRESH", -0.7),
        easy_thresh=_get(o, "ONLINE_REGION_CLASSIFIER.MINIBOOTSTRAP.EASY_THRESH", -0.9),
        segm_batch_size=_get(feat_cfg, "SEGMENTATION.BATCH_SIZE", 20000),
        shuffle_negatives=bool(
            _get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.SHUFFLE_NEGATIVES", False)
        ),
        rpn_shuffle_negatives=bool(
            _get(feat_cfg, "MINIBOOTSTRAP.RPN.SHUFFLE_NEGATIVES", False)
        ),
        # fixed-capacity reservoir sizes (framework extension keys — the
        # reference's unbounded python lists have no capacity knob; these are
        # real deployment levers: they bound the HBM working set AND the
        # solver-program shapes, see docs/SCALING.md "streaming minibootstrap")
        rpn_pos_cap=int(_get(feat_cfg, "MINIBOOTSTRAP.RPN.POS_CAP", 4096)),
        det_pos_cap=int(_get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.POS_CAP", 2048)),
        coxy_cap=int(_get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.COXY_CAP", 30000)),
        segm_pos_cap=int(_get(feat_cfg, "SEGMENTATION.POS_CAP", 8192)),
        solver_class_chunk=int(
            _get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.SOLVER_CLASS_CHUNK", 8)
        ),
    )

    det_cfg = DetectorConfig(
        pre_nms_top_n=_get(feat_cfg, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 1000),
        post_nms_top_n=_get(feat_cfg, "MODEL.RPN.POST_NMS_TOP_N_TEST", 300),
        rpn_nms_thresh=_get(feat_cfg, "MODEL.RPN.NMS_THRESH", 0.7),
        score_thresh=float(_get(o, "EVALUATION.SCORE_THRESH",
                                _get(feat_cfg, "MODEL.ROI_HEADS.SCORE_THRESH", -2.0))),
        nms_thresh=float(_get(o, "EVALUATION.NMS",
                              _get(feat_cfg, "MODEL.ROI_HEADS.NMS", 0.3))),
        detections_per_img=int(
            _get(o, "EVALUATION.DETECTIONS_PER_IMAGE",
                 _get(feat_cfg, "TEST.DETECTIONS_PER_IMG", 100))
        ),
    )

    iou_thr = _get(feat_cfg, "EVALUATION.IOU_THRESHOLDS", (0.5,))
    if isinstance(iou_thr, str):
        iou_thr = ast.literal_eval(iou_thr)
    steps = _get(feat_cfg, "SOLVER.STEPS", (30000,))
    if isinstance(steps, str):
        steps = ast.literal_eval(steps)
    # SGD solver knobs for the baseline trainers (yacs SOLVER tree +
    # sampling sizes, ``defaults.py:150,193,394-409``)
    sgd = dict(
        base_lr=float(_get(feat_cfg, "SOLVER.BASE_LR", 0.001)),
        momentum=float(_get(feat_cfg, "SOLVER.MOMENTUM", 0.9)),
        weight_decay=float(_get(feat_cfg, "SOLVER.WEIGHT_DECAY", 0.0005)),
        warmup_iters=int(_get(feat_cfg, "SOLVER.WARMUP_ITERS", 500)),
        warmup_factor=float(_get(feat_cfg, "SOLVER.WARMUP_FACTOR", 1.0 / 3)),
        steps=tuple(steps),
        gamma=float(_get(feat_cfg, "SOLVER.GAMMA", 0.1)),
        max_iter=int(_get(feat_cfg, "SOLVER.MAX_ITER", 40000)),
        roi_batch=int(_get(feat_cfg, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 512)),
        post_nms_train=int(_get(feat_cfg, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 300)),
    )
    extras = {
        "train_datasets": parse_dataset_tuple(_get(feat_cfg, "DATASETS.TRAIN", ())),
        "test_datasets": parse_dataset_tuple(_get(feat_cfg, "DATASETS.TEST", ())),
        "weight": _get(feat_cfg, "MODEL.WEIGHT", ""),
        "min_size_test": _get(feat_cfg, "INPUT.MIN_SIZE_TEST", 600),
        "max_size_test": _get(feat_cfg, "INPUT.MAX_SIZE_TEST", 1333),
        "min_size_train": _get(feat_cfg, "INPUT.MIN_SIZE_TRAIN", (600,)),
        "max_size_train": _get(feat_cfg, "INPUT.MAX_SIZE_TRAIN", 1333),
        "iou_thresholds": tuple(iou_thr),
        "use_07_metric": bool(_get(feat_cfg, "EVALUATION.USE_VOC07_METRIC", True)),
        "mask_on": bool(_get(feat_cfg, "MODEL.MASK_ON", False)),
        "class_names": [chosen[k] for k in sorted(chosen)] if chosen else None,
        "shuffle_negatives": bool(
            _get(feat_cfg, "MINIBOOTSTRAP.DETECTOR.SHUFFLE_NEGATIVES", False)
        ),
        "sgd": sgd,
        # training-time horizontal flip (``defaults.py:64``; the shipped
        # experiment configs set 0.0, the yacs default is 0.5)
        "flip_prob_train": float(
            _get(feat_cfg, "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", 0.5)
        ),
    }
    return train_cfg, det_cfg, extras
