"""Flagship experiment: on-line RPN + on-line detection + on-line
segmentation (counterpart of ``experiments/run_experiment_online_rpn_ood_oos.py``).

One feature-extraction pass -> O-RPN FALKON + RLS -> detector FALKON + RLS
-> per-pixel segmentation FALKON -> evaluation, with the JAX CLI's flags and
its save and load file contracts. Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood_oos \\
        --output_dir out [--CPU] [...]

Two training routes, as in the JAX CLI:

- the device route (``harvest_dataset_device`` + ``train_online_modules_device``:
  the reservoirs and the solvers stay on the card), on the card or with
  ``--n_devices`` above 1, unless a save- or load-features flag is given;
- the host route (``harvest_dataset`` -> ``HarvestAccumulator`` ->
  ``save_features`` / ``load_features`` -> ``train_online_modules``), with
  those flags and with ``--CPU``.

``--n_devices N`` (N > 1) builds a mesh of N cards (``parallel/mesh.py``;
with ``--CPU``, N virtual CPU entries): the harvest trunk and inference
split each canvas batch over it, the solvers each head's classes; the
slices run one after another, so the mesh spreads memory, not time. The
loaders prefetch canvases on a thread pool (``prefetch="threads"``).

Without ``--CPU`` the run needs a CUDA card and raises before any work when
there is none. Config names resolve against ``experiments/configs``. The
feature extractor comes from ``--weights``, or from the file MODEL.WEIGHT
resolves to (a Detectron ``.pkl`` or a maskrcnn-benchmark ``.pth``); with
neither, it is random from seed 0, with a warning.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str,
                        default="online_rpn_detection_segmentation_experiment_ycbv")
    parser.add_argument("--save_RPN_detector_segmentation_models", action="store_true")
    parser.add_argument("--load_RPN_detector_segmentation_models", action="store_true")
    parser.add_argument("--save_RPN_detector_segmentation_features", action="store_true")
    parser.add_argument("--load_RPN_detector_segmentation_features", action="store_true")
    parser.add_argument("--use_only_gt_positives_detection", action="store_true")
    parser.add_argument("--sampling_ratio_segmentation", type=float, default=0.3)
    parser.add_argument("--pos_fraction_feat_stats", type=float, default=0.8)
    parser.add_argument("--normalize_features_regressor_detector", action="store_true")
    parser.add_argument("--sampling_ratio_positives_detection", type=float, default=1.0)
    parser.add_argument("--config_file_feature_extraction", type=str,
                        default="config_feature_extraction_online_rpn_det_segm_ycbv.yaml")
    parser.add_argument("--config_file_online_rpn_detection_segmentation", type=str,
                        default="config_online_rpn_detection_segmentation_ycbv.yaml")
    parser.add_argument("--minibootstrap_iterations", type=int)
    parser.add_argument("--images_per_batch", type=int, default=8,
                        help="Canvas batch of the device-route harvest and of inference "
                        "(the reference is hard-wired to 1)")
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels) "
                        "and take the host route")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="Shard the harvest, the solvers and inference over this many "
                        "devices (more than 1; virtual CPU entries with --CPU); the slices "
                        "run one after another, so this spreads memory, not time")
    parser.add_argument("--data_root", type=str, default="Data/datasets",
                        help="Root of the dataset tree (reference layout)")
    parser.add_argument("--weights", type=str, default=None,
                        help="A .pkl (Caffe2 Detectron) or .pth (maskrcnn-benchmark) "
                        "checkpoint of the feature extractor")
    parser.add_argument("--eval_segm_with_gt_bboxes", action="store_true")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card

    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.pipelines import device_pipeline as dpipe
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe
    from online_detection_tpu_torch.utils import checkpoint as ckpt

    train_cfg, det_cfg, extras = _common.load_configs(
        args.config_file_feature_extraction,
        args.config_file_online_rpn_detection_segmentation, args.minibootstrap_iterations)
    train_cfg = train_cfg._replace(
        pos_fraction_feat_stats=args.pos_fraction_feat_stats,
        use_only_gt_positives_detection=args.use_only_gt_positives_detection,
        normalize_features_regressor_detector=args.normalize_features_regressor_detector,
        sampling_ratio_positives_detection=args.sampling_ratio_positives_detection,
    )
    det_cfg = det_cfg._replace(
        normalize_regressor_features=args.normalize_features_regressor_detector)

    output_dir = args.output_dir
    os.makedirs(output_dir, exist_ok=True)
    train_ds = _common.make_dataset(extras["train_datasets"][0], args.data_root)
    test_ds = _common.make_dataset(extras["test_datasets"][0], args.data_root)
    params = _common.load_params(args.weights, extras, train_cfg.num_classes).to(dev)
    canvas = _common.dataset_canvas(train_ds, extras)
    sizes = dict(min_size=extras["min_size_test"], max_size=extras["max_size_test"],
                 prefetch="threads")

    total_t0 = time.time()
    mesh = None
    if args.n_devices and args.n_devices > 1:
        from online_detection_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.n_devices, device=dev)
    use_device_route = ((dev.type == "cuda" or mesh is not None)
                        and not args.save_RPN_detector_segmentation_features
                        and not args.load_RPN_detector_segmentation_features)
    extraction_end = None
    if args.load_RPN_detector_segmentation_models:
        online = ckpt.load_online_models(output_dir).to(dev)
    elif use_device_route:
        # the reservoirs and the solvers stay on the card
        state, _ = dpipe.harvest_dataset_device(
            torch.Generator(device=dev).manual_seed(1), params, train_ds, train_cfg, canvas,
            dcfg=det_cfg, output_dir=output_dir, batch_size=args.images_per_batch,
            device=dev, mesh=mesh, **sizes)
        extraction_end = time.time()
        holder = [state]  # hands the reservoirs over: freed stage by stage
        del state
        online = dpipe.train_online_modules_device(
            torch.Generator(device=dev).manual_seed(2), holder, train_cfg, output_dir,
            device=dev, mesh=mesh)
        solver_end = time.time()
        if args.save_RPN_detector_segmentation_models:
            ckpt.save_online_models(output_dir, online)
    else:
        if args.load_RPN_detector_segmentation_features:
            # the reference loader's semantics: negatives re-batched under
            # SHUFFLE_NEGATIVES with the (possibly overridden) ITERATIONS and
            # BATCH_SIZE; segmentation pools subsampled at the ratio
            harvest = ckpt.load_features(
                output_dir,
                det_shuffle_negatives=train_cfg.shuffle_negatives,
                rpn_shuffle_negatives=train_cfg.rpn_shuffle_negatives,
                iterations=train_cfg.iterations,
                batch_size=train_cfg.batch_size,
                sampling_ratio_segmentation=args.sampling_ratio_segmentation,
            )
            extraction_end = time.time()  # solver time excludes the load
        else:
            harvest = pipe.harvest_dataset(
                torch.Generator(device=dev).manual_seed(1), params, train_ds, train_cfg,
                canvas, dcfg=det_cfg, output_dir=output_dir, device=dev, **sizes)
            extraction_end = time.time()
            if args.save_RPN_detector_segmentation_features:
                ckpt.save_features(output_dir, harvest)
        online = pipe.train_online_modules(
            torch.Generator(device=dev).manual_seed(2), harvest, train_cfg, output_dir,
            device=dev)
        solver_end = time.time()
        if args.save_RPN_detector_segmentation_models:
            ckpt.save_online_models(output_dir, online)

    train_time = time.time() - total_t0
    with open(os.path.join(output_dir, "result.txt"), "a") as fid:
        fid.write("\nTotal training time: {}min:{}s \n".format(
            int(train_time / 60), round(train_time % 60)))
        # the solver-only time (``run_experiment_online_rpn_ood_oos.py:275-277``)
        if extraction_end is not None:
            tr_time = solver_end - extraction_end
            fid.write("Training time for the online modules: {}min:{}s \n\n".format(
                int(tr_time / 60), round(tr_time % 60)))

    results, _ = pipe.run_inference(
        params, online, test_ds, canvas, det_cfg, output_dir=output_dir,
        iou_thresholds=extras["iou_thresholds"], use_07_metric=extras["use_07_metric"],
        eval_segm_with_gt_bboxes=args.eval_segm_with_gt_bboxes,
        batch_size=args.images_per_batch, device=dev, mesh=mesh, **sizes)
    for k, v in results.items():
        if k.endswith("map_0.5") or k.endswith("map_0.7"):
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
