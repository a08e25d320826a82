"""Mask R-CNN full-training baseline: SGD-train the whole network on the
target task (counterpart of ``experiments/run_experiment_full_train.py``),
with the ``--train_for_time XXh:YYm:ZZs`` budget of the papers' equal-time
comparisons. Run it as a module:

    python -m online_detection_tpu_torch.experiments.run_experiment_full_train \\
        --output_dir out [--config_file cfg.yaml] [--max_iter N] [--CPU]

The output layers are re-initialised for NUM_CLASSES + 1 classes from
``np.random.default_rng(0)``, the sampler draws come from a CPU
``torch.Generator`` seeded 0, and the run writes ``loss_history.npy`` and
``model_final.pkl`` (the JAX parameter tree with numpy leaves, which both
packages' testers read). Without ``--CPU`` the run needs a CUDA card and
raises before any work when there is none.
"""

from __future__ import annotations

import argparse
import os
import pickle


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, default="full_train_experiment")
    parser.add_argument("--train_for_time", type=str, default=None,
                        help="Training time budget, format XXh:YYm:ZZs")
    parser.add_argument("--config_file", type=str, default="config_full_train_ycbv.yaml")
    parser.add_argument("--data_root", type=str, default="Data/datasets")
    parser.add_argument("--weights", type=str, default=None)
    parser.add_argument("--CPU", action="store_true",
                        help="Run on the CPU (plain PyTorch in place of the CUDA kernels)")
    parser.add_argument("--max_iter", type=int, default=None)
    parser.add_argument("--base_lr", type=float, default=None,
                        help="Override SOLVER.BASE_LR")
    return parser.parse_args(argv)


def run(args, fine_tune_cfg=None, backbone_features=None):
    """The two SGD CLIs' shared body: configs, dataset, re-initialised
    predictors, ``do_train``, then ``loss_history.npy`` and
    ``model_final.pkl``. ``fine_tune_cfg`` (an ``SGDConfig`` -> ``SGDConfig``
    function) sets the freeze groups; ``backbone_features(params, dataset,
    canvas, extras, device)`` may swap the dataset for cached C4 maps."""
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)  # raises here without a card

    import numpy as np
    import torch

    from online_detection_tpu_torch.engine.trainer import SGDConfig, do_train, parse_time_budget
    from online_detection_tpu_torch.experiments._common import (
        dataset_canvas,
        load_configs,
        load_params,
        make_dataset,
        reinit_predictors,
    )
    from online_detection_tpu_torch.models.weights import tree_from_params

    train_cfg, _, extras = load_configs(args.config_file, None)
    os.makedirs(args.output_dir, exist_ok=True)
    train_ds = make_dataset(extras["train_datasets"][0], args.data_root)
    params = load_params(args.weights, extras, train_cfg.num_classes)
    reinit_predictors(params, train_cfg.num_classes, extras["mask_on"])
    canvas = dataset_canvas(train_ds, extras)

    cfg = SGDConfig(**extras["sgd"])
    if fine_tune_cfg is not None:
        cfg = fine_tune_cfg(cfg)
    if args.base_lr is not None:
        cfg = cfg._replace(base_lr=args.base_lr)
    if args.max_iter:
        cfg = cfg._replace(max_iter=args.max_iter)
    if backbone_features is not None:
        params = params.to(dev)
        train_ds = backbone_features(params, train_ds, canvas, extras, dev)

    params, hist = do_train(
        params, train_ds, canvas, cfg, torch.Generator().manual_seed(0),
        with_mask=extras["mask_on"], time_budget=parse_time_budget(args.train_for_time),
        min_size=extras["min_size_test"], max_size=extras["max_size_test"],
        flip_prob=extras["flip_prob_train"], device=dev)
    np.save(os.path.join(args.output_dir, "loss_history.npy"), np.asarray(hist))
    with open(os.path.join(args.output_dir, "model_final.pkl"), "wb") as f:
        pickle.dump(tree_from_params(params), f)
    print("final loss:", hist[-1] if hist else None)
    return params


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
