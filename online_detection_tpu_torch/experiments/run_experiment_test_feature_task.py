"""Checkpoint evaluation: saved Mask R-CNN checkpoints through the stock
inference path (``detect_pretrained``), scored by VOC mAP (counterpart of
``experiments/run_experiment_test_feature_task.py``, the reference's
``TesterFeatureTask`` loop). Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_test_feature_task \\
        --models_dir <dir of model_*.pkl / model_*.pth> [--CPU] [...]

Each ``model_*.pkl`` is a Detectron/Caffe2 blob pickle or the SGD trainers'
pickled parameter tree with numpy leaves (the JAX schema); each
``model_*.pth`` a maskrcnn-benchmark checkpoint. Without ``--CPU`` the run
needs a CUDA card and raises before any work when there is none.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, default="test_feature_task")
    parser.add_argument("--models_dir", type=str, required=False, default=None,
                        help="Directory of checkpoints (model_*.pkl/.pth) to test")
    parser.add_argument("--config_file", type=str, default="config_full_train_ycbv.yaml")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    return parser.parse_args(argv)


def load_any_checkpoint(path: str):
    """``DetectorParams`` on the CPU from a Caffe2 ``.pkl``, a pickled JAX-schema
    tree with numpy leaves, or a maskrcnn-benchmark ``.pth``."""
    from online_detection_tpu_torch.models.weights import load_checkpoint, params_from_jax

    if not path.endswith(".pkl"):
        return load_checkpoint(path)
    with open(path, "rb") as f:
        tree = pickle.load(f)
    if "blobs" in tree or "conv1_w" in tree:
        return load_checkpoint(path)
    return params_from_jax(tree)


def main(argv=None):
    args = parse_args(argv)
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card

    import torch

    from online_detection_tpu_torch.data import transforms
    from online_detection_tpu_torch.data.evaluation import voc_eval
    from online_detection_tpu_torch.experiments._common import (
        dataset_canvas,
        load_configs,
        make_dataset,
    )
    from online_detection_tpu_torch.models.anchors import grid_anchors
    from online_detection_tpu_torch.models.detector import detect_pretrained

    _, det_cfg, extras = load_configs(args.config_file, None)
    test_ds = make_dataset(extras["test_datasets"][0], args.data_root)
    canvas = dataset_canvas(test_ds, extras)
    ch, cw = canvas
    anchors = torch.from_numpy(grid_anchors(ch // 16, cw // 16)).to(dev)
    os.makedirs(args.output_dir, exist_ok=True)

    ckpts = []
    if args.models_dir:
        ckpts = sorted(glob.glob(os.path.join(args.models_dir, "model_*.pkl"))
                       + glob.glob(os.path.join(args.models_dir, "model_*.pth")))
    if not ckpts:
        print("No checkpoints found in", args.models_dir)
        return {}

    all_results = {}
    for path in ckpts:
        params = load_any_checkpoint(path).to(dev)
        predictions, ground_truths = [], []
        t0 = time.time()
        for i in range(len(test_ds)):
            anno = test_ds.get_annotation(i)
            cimg, scale, (sw, sh) = transforms.preprocess_image(
                test_ds.load_image(i), canvas, extras["min_size_test"], extras["max_size_test"])
            dets, mask_probs, _, _ = detect_pretrained(
                params, anchors, torch.from_numpy(cimg), (sw, sh), det_cfg,
                with_masks=extras["mask_on"], device=dev)
            v = dets.valid.cpu().numpy()
            pred = {"boxes": dets.boxes.cpu().numpy()[v] / scale,
                    "scores": dets.scores.cpu().numpy()[v],
                    "labels": dets.labels.cpu().numpy()[v]}
            if mask_probs is not None:
                pred["masks"] = mask_probs.cpu().numpy()[v]
            predictions.append(pred)
            gt = {"boxes": anno.boxes, "labels": anno.labels, "difficult": anno.difficult}
            if extras["mask_on"]:
                gt["masks"] = test_ds.load_masks(i, anno)
            ground_truths.append(gt)
        results = voc_eval.evaluate(
            predictions, ground_truths, test_ds.classes,
            iou_thresholds=extras["iou_thresholds"], use_07_metric=extras["use_07_metric"],
            evaluate_segmentation=extras["mask_on"], output_dir=args.output_dir)
        print(os.path.basename(path), {k: round(v, 4) for k, v in results.items()
                                       if isinstance(v, float)},
              f"({time.time() - t0:.1f}s)")
        all_results[path] = results
    return all_results


if __name__ == "__main__":
    main()
