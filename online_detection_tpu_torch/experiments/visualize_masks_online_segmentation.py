"""Overlays predicted boxes and masks of trained on-line models on test
images; counterpart of ``experiments/visualize_masks_online_segmentation.py``.

Loads the on-line models a previous experiment saved (``--models_dir``),
runs ``OnlineSegmentationDemo`` on the first ``--num_images`` test images
and writes ``overlay_<i>.png`` into ``--output_dir``. The JAX CLI's flags.
Run it as a module:

    python -m online_detection_tpu_torch.experiments.visualize_masks_online_segmentation \\
        --models_dir out --output_dir viz [--CPU] [...]

Without ``--CPU`` the run needs a CUDA card and raises before any work when
there is none.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--models_dir", type=str, required=True,
                        help="Directory with classifier_*/regressor_*/stats_* files")
    parser.add_argument("--output_dir", type=str, default="visualizations")
    parser.add_argument("--config_file_feature_extraction", type=str,
                        default="config_feature_extraction_online_rpn_det_segm_ycbv.yaml")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--num_images", type=int, default=20)
    parser.add_argument("--confidence_threshold", type=float, default=0.0)
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card

    from PIL import Image

    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.modules.demo import OnlineSegmentationDemo
    from online_detection_tpu_torch.utils.checkpoint import load_online_models

    train_cfg, det_cfg, extras = _common.load_configs(args.config_file_feature_extraction, None)
    test_ds = _common.make_dataset(extras["test_datasets"][0], args.data_root)
    params = _common.load_params(args.weights, extras, train_cfg.num_classes)
    online = load_online_models(args.models_dir)
    canvas = _common.dataset_canvas(test_ds, extras)

    demo = OnlineSegmentationDemo(
        params, online, test_ds.classes, canvas, det_cfg,
        min_size=extras["min_size_test"], max_size=extras["max_size_test"],
        confidence_threshold=args.confidence_threshold, device=dev)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i in range(min(args.num_images, len(test_ds))):
        overlay = demo.overlay(test_ds.load_image(i))
        out_path = os.path.join(args.output_dir, f"overlay_{i:04d}.png")
        Image.fromarray(overlay).save(out_path)
        print("wrote", out_path)
        paths.append(out_path)
    return paths


if __name__ == "__main__":
    main()
