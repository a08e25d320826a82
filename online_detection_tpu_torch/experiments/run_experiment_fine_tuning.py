"""Mask R-CNN fine-tuning baseline: freeze the backbone (and optionally the
RPN), re-initialise and SGD-train the output layers (counterpart of
``experiments/run_experiment_fine_tuning.py``), with the same freeze groups
and time-budget protocol. Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_fine_tuning \\
        --output_dir out [--use_backbone_features] [--max_iter N] [--CPU]

``--use_backbone_features`` trains from cached C4 maps
(``engine/backbone_cache.py``): they are extracted into
``<output_dir>/features`` when that directory is missing or
``--extract_backbone_features`` is given. Writes ``loss_history.npy`` and
``model_final.pkl`` as the full-train CLI does. Without ``--CPU`` the run
needs a CUDA card and raises before any work when there is none.
"""

from __future__ import annotations

import argparse
import os

from online_detection_tpu_torch.experiments.run_experiment_full_train import run


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, default="fine_tuning_experiment")
    parser.add_argument("--train_for_time", type=str, default=None)
    parser.add_argument("--fine_tune_RPN", action="store_true",
                        help="Also train the RPN logits (otherwise frozen)")
    parser.add_argument("--fine_tune_last_layers", action="store_true",
                        help="Freeze everything except the final predictors")
    parser.add_argument("--use_backbone_features", action="store_true",
                        help="Train from cached backbone feature maps (the backbone is "
                        "frozen, so it is never recomputed)")
    parser.add_argument("--extract_backbone_features", action="store_true",
                        help="Force (re-)extraction of the cached backbone feature maps "
                        "before training (only with --use_backbone_features, as in the "
                        "reference's run_experiment_fine_tuning.py:17,69)")
    parser.add_argument("--config_file", type=str, default="config_fine_tuning_ycbv.yaml")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--base_lr", type=float, default=None,
                        help="Override SOLVER.BASE_LR")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    def freeze(cfg):
        return cfg._replace(freeze_backbone=True,
                            freeze_rpn_except_logits=not args.fine_tune_RPN,
                            freeze_heads_except_predictor=args.fine_tune_last_layers)

    def backbone_features(params, dataset, canvas, extras, dev):
        from online_detection_tpu_torch.engine.backbone_cache import (
            FromFeatDataset,
            dump_backbone_features,
        )

        feat_dir = os.path.join(args.output_dir, "features")
        if args.extract_backbone_features or not os.path.isdir(feat_dir):
            dump_backbone_features(params, dataset, args.output_dir, canvas,
                                   extras["min_size_test"], extras["max_size_test"], device=dev)
        return FromFeatDataset(dataset, feat_dir)

    return run(args, freeze, backbone_features if args.use_backbone_features else None)


if __name__ == "__main__":
    main()
