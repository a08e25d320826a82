"""Shared plumbing of the experiment CLIs: config resolution, datasets and
the feature extractor's weights (counterpart of ``experiments/_common.py``).

Config names resolve against the repository's ``experiments/configs/``, the
reference's YAML files, which the port reads as data.
"""

from __future__ import annotations

import os
from pathlib import Path

# the repository's shipped configs (data, shared with the JAX package's CLIs)
CONFIG_DIR = Path(__file__).resolve().parents[2] / "experiments" / "configs"


def _found_config(path):
    """The file a config name resolves to (``experiments/configs`` first,
    then as a path), or None."""
    if not os.path.isabs(path):
        local = CONFIG_DIR / path
        if local.exists():
            return str(local)
    return path if os.path.exists(path) else None


def resolve_config(path):
    """Resolve a config name against ``experiments/configs``, else as a path.

    A named-but-missing config raises instead of falling back to built-in
    defaults: a run on the wrong hyperparameters is worse than no run. Pass
    an empty string or None to ask for the defaults."""
    if not path:
        return None
    found = _found_config(path)
    if found is None:
        raise FileNotFoundError(
            f"config file {path!r} not found (looked in experiments/configs and "
            f"as a path); pass '' to run on built-in defaults")
    return found


def config_resolves(path) -> bool:
    """False where ``resolve_config`` would raise."""
    return not path or _found_config(path) is not None


def load_configs(feat_path, online_path, minibootstrap_iterations=None):
    """(train config, detector config, extras) from the two YAML files."""
    from online_detection_tpu_torch.config.config import build_configs, load_yaml

    feat_cfg, online_cfg = {}, {}
    p = resolve_config(feat_path)
    if p:
        feat_cfg = load_yaml(p)
    p = resolve_config(online_path)
    if p:
        online_cfg = load_yaml(p)
    return build_configs(feat_cfg, online_cfg, minibootstrap_iterations)


def make_dataset(name, data_root="Data/datasets"):
    from online_detection_tpu_torch.config.config import resolve_dataset
    from online_detection_tpu_torch.data.datasets.icubworld import ICubWorldDataset

    factory, kwargs = resolve_dataset(name, data_root)
    if factory == "YCBVideoDataset":
        from online_detection_tpu_torch.data.datasets.ycb_video import YCBVideoDataset

        return YCBVideoDataset(data_dir=kwargs["data_dir"], image_set=kwargs["image_set"],
                               split=kwargs["split"])
    return ICubWorldDataset(
        kwargs["data_dir"], kwargs["image_set"], kwargs["split"],
        is_target_task=kwargs.get("is_target_task", False),
        icwt_21_objs=kwargs.get("icwt_21_objs", False),
    )


def resolve_weight(weight_ref):
    """MODEL.WEIGHT -> local file path, or None.

    The reference's configs use three forms (``paths_catalog.py:350-403``):
    ``catalog://...`` model-zoo URIs, bare file names (resolved under
    Data/pretrained_feature_extractors/) and plain paths."""
    if not weight_ref:
        return None
    candidates = [
        weight_ref.replace("catalog://", "Data/pretrained_feature_extractors/"),
        os.path.join("Data/pretrained_feature_extractors", weight_ref),
        weight_ref,
    ]
    for c in candidates:
        if "catalog://" not in c and os.path.exists(c):
            return c
    return None


def load_params(weights_arg, extras, num_classes):
    """The feature extractor, on the CPU: an existing ``--weights`` file, else
    the file that MODEL.WEIGHT resolves to, through ``load_checkpoint``
    (``.pkl`` or ``.pth``); else random weights from seed 0, with a warning."""
    from online_detection_tpu_torch.models.detector import init_detector_params
    from online_detection_tpu_torch.models.weights import load_checkpoint

    if weights_arg and os.path.exists(weights_arg):
        return load_checkpoint(weights_arg)
    local = resolve_weight(extras.get("weight") or "")
    if local:
        return load_checkpoint(local)
    print("WARNING: no pretrained weights found — using random init "
          "(pass --weights for real runs)")
    return init_detector_params(0, 15, num_classes + 1)


def dataset_canvas(dataset, extras):
    from online_detection_tpu_torch.data.transforms import canvas_size

    info = dataset.get_annotation(0)
    return canvas_size(info.width, info.height, extras["min_size_test"], extras["max_size_test"])


def reinit_predictors(params, num_classes, mask_on):
    """Re-initialises the output layers for NUM_CLASSES + 1 classes, in place,
    from ``np.random.default_rng(0)`` as the JAX package's SGD CLIs do
    (``train_feature_task.py:109-120``): the box predictor always, the mask
    logits when MASK_ON is set and the network has a mask head."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.heads import BoxPredictor

    n_cls = num_classes + 1
    rng = np.random.default_rng(0)

    def normal(std, shape):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))

    params.box_predictor = BoxPredictor(normal(0.01, (2048, n_cls)), torch.zeros(n_cls),
                                        normal(0.001, (2048, 4 * n_cls)), torch.zeros(4 * n_cls))
    if mask_on and params.mask_head is not None:
        params.mask_head.logits_w = normal(0.01, (256, n_cls))
        params.mask_head.logits_b = torch.zeros(n_cls)
    return params
