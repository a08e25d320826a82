"""On-line detection + on-line segmentation with the frozen pretrained RPN
(no on-line RPN); counterpart of ``experiments/run_experiment_segmentation.py``.

Extracts detector and segmentation features with the pretrained RPN's
proposals (``harvest_dataset``), trains the detector's FALKON + RLS and the
per-pixel segmentation FALKON (``train_online_modules``), then scores the
test set (``run_inference``; with ``--eval_segm_with_gt_bboxes`` the GT
boxes stand in for the detections before the mask head). The JAX CLI's
flags. Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_segmentation \\
        --output_dir out [--CPU] [...]

Without ``--CPU`` the run needs a CUDA card and raises before any work when
there is none.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, default="segmentation_experiment_ycbv")
    parser.add_argument("--save_detector_segmentation_models", action="store_true")
    parser.add_argument("--load_detector_segmentation_models", action="store_true")
    parser.add_argument("--save_detector_segmentation_features", action="store_true")
    parser.add_argument("--load_detector_segmentation_features", action="store_true")
    parser.add_argument("--use_only_gt_positives_detection", action="store_true")
    parser.add_argument("--eval_segm_with_gt_bboxes", action="store_true")
    parser.add_argument("--sampling_ratio_segmentation", type=float, default=0.3)
    parser.add_argument("--pos_fraction_feat_stats", type=float, default=0.8)
    parser.add_argument("--normalize_features_regressor_detector", action="store_true")
    parser.add_argument("--config_file_feature_extraction", type=str,
                        default="config_feature_extraction_segmentation_ycbv.yaml")
    parser.add_argument("--config_file_online_detection_segmentation", type=str,
                        default="config_online_detection_segmentation_ycbv.yaml")
    parser.add_argument("--minibootstrap_iterations", type=int)
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--weights", type=str, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card

    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe
    from online_detection_tpu_torch.utils import checkpoint as ckpt

    train_cfg, det_cfg, extras = _common.load_configs(
        args.config_file_feature_extraction, args.config_file_online_detection_segmentation,
        args.minibootstrap_iterations)
    # the frozen pretrained RPN: no on-line RPN module in this pipeline
    train_cfg = train_cfg._replace(
        with_rpn=False,
        pos_fraction_feat_stats=args.pos_fraction_feat_stats,
        use_only_gt_positives_detection=args.use_only_gt_positives_detection,
        normalize_features_regressor_detector=args.normalize_features_regressor_detector,
    )
    det_cfg = det_cfg._replace(
        normalize_regressor_features=args.normalize_features_regressor_detector)

    output_dir = args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    train_ds = _common.make_dataset(extras["train_datasets"][0], args.data_root)
    test_ds = _common.make_dataset(extras["test_datasets"][0], args.data_root)
    params = _common.load_params(args.weights, extras, train_cfg.num_classes).to(dev)
    canvas = _common.dataset_canvas(train_ds, extras)

    t0 = time.time()
    if args.load_detector_segmentation_models:
        online = ckpt.load_online_models(output_dir).to(dev)
    else:
        if args.load_detector_segmentation_features:
            harvest = ckpt.load_features(
                output_dir, det_shuffle_negatives=train_cfg.shuffle_negatives,
                iterations=train_cfg.iterations, batch_size=train_cfg.batch_size,
                sampling_ratio_segmentation=args.sampling_ratio_segmentation)
        else:
            harvest = pipe.harvest_dataset(
                torch.Generator(device=dev).manual_seed(1), params, train_ds, train_cfg,
                canvas, dcfg=det_cfg, output_dir=output_dir, min_size=extras["min_size_test"],
                max_size=extras["max_size_test"], device=dev, prefetch="threads")
            if args.save_detector_segmentation_features:
                ckpt.save_features(output_dir, harvest)
        online = pipe.train_online_modules(torch.Generator(device=dev).manual_seed(2), harvest,
                                           train_cfg, output_dir, device=dev)
        if args.save_detector_segmentation_models:
            ckpt.save_online_models(output_dir, online)
    train_time = time.time() - t0
    with open(os.path.join(output_dir, "result.txt"), "a") as fid:
        fid.write("Total training time: {}min:{}s \n".format(
            int(train_time / 60), round(train_time % 60)))

    results, _ = pipe.run_inference(
        params, online, test_ds, canvas, det_cfg, output_dir=output_dir,
        iou_thresholds=extras["iou_thresholds"], use_07_metric=extras["use_07_metric"],
        min_size=extras["min_size_test"], max_size=extras["max_size_test"],
        eval_segm_with_gt_bboxes=args.eval_segm_with_gt_bboxes, device=dev, prefetch="threads")
    for k, v in results.items():
        if "map" in k:
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
