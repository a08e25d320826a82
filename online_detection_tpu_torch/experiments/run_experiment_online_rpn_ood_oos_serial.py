"""Serial flagship: the O-RPN trained first, then detector and segmentation
features extracted with the trained O-RPN's proposals ("Ours Serial");
counterpart of ``experiments/run_experiment_online_rpn_ood_oos_serial.py``.

Pass 1 harvests the RPN features (``harvest_dataset``) and trains the O-RPN
(FALKON + RLS); pass 2 harvests the detector and segmentation features with
the O-RPN's proposals and trains those heads; then ``run_inference`` scores
the test set. The JAX CLI's flags and its save and load file contracts:
per-stage models (``--save/load_{RPN,detector,segmentation}_models``), per-
stage feature caches (``--save/load_RPN_features``,
``--save_detector_segmentation_features``, ``--load_detector_features``,
``--load_segmentation_features``), ``--no_rpn``, ``--config_file_rpn`` and
the sampling and normalisation knobs. Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood_oos_serial \\
        --output_dir out [--CPU] [...]

Without ``--CPU`` the run needs a CUDA card and raises before any work when
there is none. ``--n_devices N`` (N > 1) splits each head's classes over a
mesh of N cards (``parallel/mesh.py``); with ``--CPU``, over N virtual CPU
entries.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str,
                        default="online_rpn_detection_segmentation_experiment_ycbv_serial")
    parser.add_argument("--save_RPN_models", action="store_true")
    parser.add_argument("--save_detector_models", action="store_true")
    parser.add_argument("--save_segmentation_models", action="store_true")
    parser.add_argument("--load_RPN_models", action="store_true")
    parser.add_argument("--load_detector_models", action="store_true")
    parser.add_argument("--load_segmentation_models", action="store_true")
    parser.add_argument("--save_RPN_features", action="store_true")
    parser.add_argument("--load_RPN_features", action="store_true")
    parser.add_argument("--save_detector_segmentation_features", action="store_true")
    parser.add_argument("--load_detector_features", action="store_true")
    parser.add_argument("--load_segmentation_features", action="store_true")
    parser.add_argument("--no_rpn", action="store_true",
                        help="Skip the O-RPN stage (pretrained proposals only)")
    parser.add_argument("--use_only_gt_positives_detection", action="store_true")
    parser.add_argument("--eval_segm_with_gt_bboxes", action="store_true")
    parser.add_argument("--sampling_ratio_segmentation", type=float, default=0.3)
    parser.add_argument("--pos_fraction_feat_stats", type=float, default=0.8)
    parser.add_argument("--normalize_features_regressor_detector", action="store_true")
    parser.add_argument("--config_file_feature_extraction", type=str,
                        default="config_feature_extraction_online_rpn_det_segm_ycbv_serial.yaml")
    parser.add_argument("--config_file_rpn", type=str, default="config_rpn_ycbv.yaml",
                        help="Feature-extraction config for the RPN pass")
    parser.add_argument("--config_file_online_rpn_detection_segmentation", type=str,
                        default="config_online_rpn_detection_segmentation_ycbv_serial.yaml")
    parser.add_argument("--minibootstrap_iterations", type=int)
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Split each head's classes over this many devices (more than 1; "
                        "virtual CPU entries with --CPU); the slices run one after another, "
                        "so this spreads memory, not time")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--weights", type=str, default=None)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card
    mesh = None
    if args.n_devices and args.n_devices > 1:
        from online_detection_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.n_devices, device=dev)

    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.models.detector import OnlineModelSet
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe
    from online_detection_tpu_torch.utils import checkpoint as ckpt

    train_cfg, det_cfg, extras = _common.load_configs(
        args.config_file_feature_extraction,
        args.config_file_online_rpn_detection_segmentation, args.minibootstrap_iterations)
    train_cfg = train_cfg._replace(
        pos_fraction_feat_stats=args.pos_fraction_feat_stats,
        use_only_gt_positives_detection=args.use_only_gt_positives_detection,
        normalize_features_regressor_detector=args.normalize_features_regressor_detector,
    )
    det_cfg = det_cfg._replace(
        normalize_regressor_features=args.normalize_features_regressor_detector)
    # the RPN pass reads its own feature-extraction config (the reference's
    # --config_file_rpn); a name that resolves to no file leaves it the main
    # one, as in the JAX CLI
    rpn_cfg = train_cfg
    if _common.config_resolves(args.config_file_rpn):
        rpn_cfg, _, _ = _common.load_configs(
            args.config_file_rpn, args.config_file_online_rpn_detection_segmentation,
            args.minibootstrap_iterations)
        rpn_cfg = rpn_cfg._replace(pos_fraction_feat_stats=args.pos_fraction_feat_stats)

    output_dir = args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    train_ds = _common.make_dataset(extras["train_datasets"][0], args.data_root)
    test_ds = _common.make_dataset(extras["test_datasets"][0], args.data_root)
    params = _common.load_params(args.weights, extras, train_cfg.num_classes).to(dev)
    canvas = _common.dataset_canvas(train_ds, extras)
    t_total = time.time()
    hkw = dict(dcfg=det_cfg, output_dir=output_dir, min_size=extras["min_size_test"],
               max_size=extras["max_size_test"], device=dev, prefetch="threads")

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # ---- pass 1: O-RPN ----
    online_rpn = None
    if not args.no_rpn:
        if args.load_RPN_models:
            online_rpn = ckpt.load_rpn_models(output_dir).to(dev)
        else:
            rpn_harvest_cfg = rpn_cfg._replace(with_segmentation=False)
            if args.save_RPN_features or args.load_RPN_features:
                if args.save_RPN_features:
                    h1 = pipe.harvest_dataset(generator(1), params, train_ds, rpn_harvest_cfg,
                                              canvas, **hkw)
                    ckpt.save_features(output_dir, h1, heads=("rpn",))
                rpn_head = ckpt.load_features(
                    output_dir, rpn_shuffle_negatives=rpn_cfg.rpn_shuffle_negatives,
                    iterations=rpn_cfg.iterations, batch_size=rpn_cfg.batch_size)["rpn"]
            else:
                h1 = pipe.harvest_dataset(generator(1), params, train_ds, rpn_harvest_cfg,
                                          canvas, **hkw)
                rpn_head = h1["rpn"]
            online_rpn = pipe.train_rpn_module(generator(2), rpn_head, train_cfg, output_dir,
                                               mesh=mesh, device=dev)
            if args.save_RPN_models:
                ckpt.save_rpn_models(output_dir, online_rpn)

    # ---- pass 2: detector + segmentation with the O-RPN's proposals ----
    cfg2 = train_cfg._replace(with_rpn=False)
    need_det = not args.load_detector_models
    need_seg = not args.load_segmentation_models
    harvest2 = None
    if need_det or need_seg:
        if (args.load_detector_features or args.load_segmentation_features
                or args.save_detector_segmentation_features):
            if args.save_detector_segmentation_features:
                h2 = pipe.harvest_dataset(generator(3), params, train_ds, cfg2, canvas,
                                          online_rpn=online_rpn, **hkw)
                ckpt.save_features(output_dir, h2, heads=("det", "mask"))
            harvest2 = ckpt.load_features(
                output_dir, det_shuffle_negatives=cfg2.shuffle_negatives,
                iterations=cfg2.iterations, batch_size=cfg2.batch_size,
                sampling_ratio_segmentation=args.sampling_ratio_segmentation)
        else:
            harvest2 = pipe.harvest_dataset(generator(3), params, train_ds, cfg2, canvas,
                                            online_rpn=online_rpn, **hkw)

    if args.load_detector_models:
        online_det = ckpt.load_detector_models(output_dir).to(dev)
    else:
        online_det = pipe.train_detector_module(generator(4), harvest2["det"], cfg2,
                                                output_dir, mesh=mesh, device=dev)
        if args.save_detector_models:
            ckpt.save_detector_models(output_dir, online_det)

    online_mask = None
    if args.load_segmentation_models:
        online_mask = ckpt.load_segmentation_models(output_dir).to(dev)
    elif cfg2.with_segmentation and harvest2 is not None and "mask" in harvest2:
        online_mask = pipe.train_segmentation_module(generator(5), harvest2["mask"], cfg2,
                                                     output_dir, mesh=mesh, device=dev)
        if args.save_segmentation_models:
            ckpt.save_segmentation_models(output_dir, online_mask)

    online = OnlineModelSet(rpn=online_rpn, detector=online_det, mask=online_mask)

    train_time = time.time() - t_total
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
