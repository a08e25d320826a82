"""On-line RPN + on-line detection (no segmentation): the iCWT and TABLE-TOP
experiment; counterpart of ``experiments/run_experiment_online_rpn_ood.py``.

The JAX CLI's flags: ``--icwt30`` selects the iCWT-30 TARGET-TASK configs
(default: TABLE-TOP), ``--only_ood`` (or ``--no_rpn``) skips the O-RPN
stage, per-stage model save/load (``--save/load_{RPN,detector}_models``) and
feature caches (``--save/load_{RPN,detector}_features``). Run it as a
module:

    python -m online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood \\
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
    parser.add_argument("--icwt30", action="store_true",
                        help="iCWT-30 TARGET-TASK (default: TABLE-TOP)")
    parser.add_argument("--only_ood", "--no_rpn", dest="only_ood", action="store_true",
                        help="Run only on-line detection (no O-RPN update)")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--save_RPN_models", action="store_true")
    parser.add_argument("--save_detector_models", action="store_true")
    parser.add_argument("--load_RPN_models", action="store_true")
    parser.add_argument("--load_detector_models", action="store_true")
    parser.add_argument("--save_RPN_features", action="store_true")
    parser.add_argument("--save_detector_features", action="store_true")
    parser.add_argument("--load_RPN_features", action="store_true")
    parser.add_argument("--load_detector_features", action="store_true")
    parser.add_argument("--use_only_gt_positives_detection", action="store_true")
    parser.add_argument("--pos_fraction_feat_stats", type=float, default=0.8)
    parser.add_argument("--normalize_features_regressor_detector", action="store_true")
    parser.add_argument("--config_file_feature_extraction", type=str, default=None)
    parser.add_argument("--config_file_rpn_detection", type=str, default=None)
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
    from online_detection_tpu_torch.models.detector import OnlineModelSet
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe
    from online_detection_tpu_torch.utils import checkpoint as ckpt

    # config selection per the reference (``run_experiment_online_rpn_ood.py:53-71``)
    task = "icwt30" if args.icwt30 else "tabletop"
    feat_cfg_name = args.config_file_feature_extraction or f"config_detector_{task}.yaml"
    if args.config_file_rpn_detection:
        online_cfg_name = args.config_file_rpn_detection
    elif args.only_ood:
        online_cfg_name = f"config_online_detection_{task}.yaml"
    else:
        online_cfg_name = f"config_online_rpn_online_detection_{task}.yaml"

    train_cfg, det_cfg, extras = _common.load_configs(feat_cfg_name, online_cfg_name,
                                                      args.minibootstrap_iterations)
    train_cfg = train_cfg._replace(
        with_segmentation=False,
        pos_fraction_feat_stats=args.pos_fraction_feat_stats,
        use_only_gt_positives_detection=args.use_only_gt_positives_detection,
        normalize_features_regressor_detector=args.normalize_features_regressor_detector,
    )
    det_cfg = det_cfg._replace(
        normalize_regressor_features=args.normalize_features_regressor_detector)

    output_dir = args.output_dir or f"{task}_experiment"
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

    # ---- pass 1: O-RPN training (skipped with --only_ood) ----
    online_rpn = None
    if not args.only_ood:
        if args.load_RPN_models:
            online_rpn = ckpt.load_rpn_models(output_dir).to(dev)
        else:
            if args.save_RPN_features or args.load_RPN_features:
                if args.save_RPN_features:
                    h1 = pipe.harvest_dataset(generator(1), params, train_ds, train_cfg, canvas,
                                              **hkw)
                    ckpt.save_features(output_dir, h1, heads=("rpn",))
                rpn_head = ckpt.load_features(
                    output_dir, rpn_shuffle_negatives=train_cfg.rpn_shuffle_negatives,
                    iterations=train_cfg.iterations, batch_size=train_cfg.batch_size)["rpn"]
            else:
                h1 = pipe.harvest_dataset(generator(1), params, train_ds, train_cfg, canvas,
                                          **hkw)
                rpn_head = h1["rpn"]
            online_rpn = pipe.train_rpn_module(generator(2), rpn_head, train_cfg, output_dir,
                                               device=dev)
            if args.save_RPN_models:
                ckpt.save_rpn_models(output_dir, online_rpn)

    # ---- pass 2: detector features with the (trained) O-RPN's proposals ----
    cfg2 = train_cfg._replace(with_rpn=False)
    if args.load_detector_models:
        online_det = ckpt.load_detector_models(output_dir).to(dev)
    else:
        if args.save_detector_features or args.load_detector_features:
            if args.save_detector_features:
                h2 = pipe.harvest_dataset(generator(3), params, train_ds, cfg2, canvas,
                                          online_rpn=online_rpn, **hkw)
                ckpt.save_features(output_dir, h2, heads=("det",))
            det_head = ckpt.load_features(
                output_dir, det_shuffle_negatives=cfg2.shuffle_negatives,
                iterations=cfg2.iterations, batch_size=cfg2.batch_size)["det"]
        else:
            h2 = pipe.harvest_dataset(generator(3), params, train_ds, cfg2, canvas,
                                      online_rpn=online_rpn, **hkw)
            det_head = h2["det"]
        online_det = pipe.train_detector_module(generator(4), det_head, cfg2, output_dir,
                                                device=dev)
        if args.save_detector_models:
            ckpt.save_detector_models(output_dir, online_det)

    online = OnlineModelSet(rpn=online_rpn, detector=online_det, mask=None)

    train_time = time.time() - t_total
    with open(os.path.join(output_dir, "result.txt"), "a") as fid:
        fid.write("Total training time: {}min:{}s \n".format(
            int(train_time / 60), round(train_time % 60)))

    results, _ = pipe.run_inference(
        params, online, test_ds, canvas, det_cfg, with_masks=False, output_dir=output_dir,
        iou_thresholds=extras["iou_thresholds"], use_07_metric=extras["use_07_metric"],
        min_size=extras["min_size_test"], max_size=extras["max_size_test"], device=dev,
        prefetch="threads")
    for k, v in results.items():
        if "map" in k:
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
