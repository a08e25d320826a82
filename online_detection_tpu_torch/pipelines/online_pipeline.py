"""On-line training configuration and the result.txt contract (counterpart
of the parts of ``pipelines/online_pipeline.py`` that the device route
uses)."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional


class OnlineTrainConfig(NamedTuple):
    """Hyperparameters of the on-line modules; defaults are the flagship
    configuration (``config_online_rpn_detection_segmentation_ycbv.yaml`` with
    its feature-extraction config)."""

    num_classes: int = 21
    num_anchor_classes: int = 15
    # FALKON (sigma, lambda, M)
    det_sigma: float = 15.0
    det_lam: float = 1e-5
    det_m: int = 1000
    rpn_sigma: float = 50.0
    rpn_lam: float = 1e-3
    rpn_m: int = 1000
    segm_sigma: float = 10.0
    segm_lam: float = 1e-6
    segm_m: int = 500
    # RLS
    det_reg_lam: float = 1000.0
    rpn_reg_lam: float = 0.01
    # minibootstrap
    iterations: int = 10
    batch_size: int = 2000
    hard_thresh: float = -0.7
    easy_thresh: float = -0.9
    # misc
    pos_fraction_feat_stats: float = 0.8
    use_only_gt_positives_detection: bool = False
    # fraction of the COXY rows used as classifier positives when
    # use_only_gt_positives_detection is off
    sampling_ratio_positives_detection: float = 1.0
    normalize_features_regressor_detector: bool = False
    segm_batch_size: int = 20000
    with_rpn: bool = True
    with_segmentation: bool = True
    # SHUFFLE_NEGATIVES: True -> negative pools shuffled, then split into
    # batches; False -> the round-robin deal of the arrival order
    shuffle_negatives: bool = False
    rpn_shuffle_negatives: bool = False
    # reservoir capacities: per-class positives and the shared COXY rows kept
    rpn_pos_cap: int = 4096
    det_pos_cap: int = 2048
    coxy_cap: int = 30000
    segm_pos_cap: int = 8192  # positive pixels kept per class
    # classes trained at once by the minibootstrap solver
    solver_class_chunk: int = 8


def _write_result(output_dir: Optional[str], text: str):
    """Append ``text`` to ``output_dir/result.txt`` (nothing without a dir)."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "result.txt"), "a") as fid:
            fid.write(text)
