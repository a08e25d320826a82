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


def resolve_config(path):
    """Resolve a config name against ``experiments/configs``, else as a path.

    A named-but-missing config raises instead of falling back to built-in
    defaults: a run on the wrong hyperparameters is worse than no run. Pass
    an empty string or None to ask for the defaults."""
    if not path:
        return None
    if not os.path.isabs(path):
        local = CONFIG_DIR / path
        if local.exists():
            return str(local)
    if os.path.exists(path):
        return path
    raise FileNotFoundError(
        f"config file {path!r} not found (looked in experiments/configs and "
        f"as a path); pass '' to run on built-in defaults")


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
    """The feature extractor: random weights from seed 0 (on the CPU) when
    no weights file is named. Reading a weights file is not ported yet
    (ROADMAP.md, section A, item 5), so a ``--weights`` argument, or a
    MODEL.WEIGHT that resolves to a file, raises: the run would otherwise
    train on random weights without saying so."""
    from online_detection_tpu_torch.models.detector import init_detector_params

    local = weights_arg or resolve_weight(extras.get("weight") or "")
    if local:
        raise NotImplementedError(
            f"weights file {local!r}: loading Detectron .pkl / maskrcnn-benchmark .pth "
            "weights is not ported yet (ROADMAP.md, section A, item 5)")
    print("WARNING: no pretrained weights found — using random init "
          "(weights files wait for ROADMAP.md, section A, item 5)")
    return init_detector_params(0, 15, num_classes + 1)


def dataset_canvas(dataset, extras):
    from online_detection_tpu_torch.data.transforms import canvas_size

    info = dataset.get_annotation(0)
    return canvas_size(info.width, info.height, extras["min_size_test"], extras["max_size_test"])
