"""Checkpoint converter smoke (counterpart of ``experiments/weights_smoke.py``).

    python -m online_detection_tpu_torch.experiments.weights_smoke --weights <ckpt> [--CPU]

loads a ``.pkl`` (Caffe2 Detectron) or ``.pth`` (maskrcnn-benchmark)
checkpoint through ``load_checkpoint``, runs every stage of the forward pass
on a fixed synthetic image (``activation_checksums``) and prints one JSON
line per stage with its shape, mean, std and absmax. Compared with a known
good run, a layout or BN-folding fault shows in the row of its stage.

``--selftest`` needs no checkpoint: random weights (R-50-C4, 15 anchors, 22
classes, a box predictor) are written in both formats by the port's
exporters, loaded back through both converters, and all three must give the
same checksums (rtol 1e-5). Without ``--CPU`` the run needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile


def random_params(seed: int, num_anchors: int = 15, num_classes: int = 22):
    """Random R-50-C4 weights with a stock box predictor, from numpy seeds, on
    the CPU (the selftest's and the card smoke's checkpoint)."""
    import numpy as np
    import torch

    from online_detection_tpu_torch.models.detector import init_detector_params
    from online_detection_tpu_torch.models.heads import BoxPredictor

    params = init_detector_params(seed, num_anchors, num_classes)
    rng = np.random.default_rng(seed + 1)
    d = params.backbone.res5[-1].branch2c.weight.shape[0]

    def normal(*shape):
        return torch.from_numpy(rng.normal(0.0, 0.01, shape).astype(np.float32))

    params.box_predictor = BoxPredictor(normal(d, num_classes), torch.zeros(num_classes),
                                        normal(d, 4 * num_classes), torch.zeros(4 * num_classes))
    return params


def write_checkpoints(params, out_dir: str, prefix: str = "ckpt"):
    """``params`` written as ``<prefix>.pkl`` (Caffe2 blobs under "blobs") and
    ``<prefix>.pth`` (a state dict under "model", with the ``module.`` prefix
    a data-parallel save leaves) -> (pkl path, pth path)."""
    import torch

    from online_detection_tpu_torch.models.weights import (
        export_caffe2_blobs,
        export_torch_state_dict,
    )

    pkl_path = os.path.join(out_dir, prefix + ".pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump({"blobs": export_caffe2_blobs(params)}, f)
    pth_path = os.path.join(out_dir, prefix + ".pth")
    sd = {"module." + k: torch.from_numpy(v) for k, v in export_torch_state_dict(params).items()}
    torch.save({"model": sd}, pth_path)
    return pkl_path, pth_path


def compare_checksums(ref, got, name: str, rtol: float = 1e-5, atol: float = 1e-7):
    """Raises ``AssertionError`` unless ``got`` has ``ref``'s stages, shapes
    and statistics (within ``rtol``/``atol``)."""
    import numpy as np

    if set(got) != set(ref):
        raise AssertionError(f"{name}: stages differ: {set(got) ^ set(ref)}")
    for stage in ref:
        if tuple(ref[stage]["shape"]) != tuple(got[stage]["shape"]):
            raise AssertionError(f"{name}/{stage}: shape {got[stage]['shape']} != "
                                 f"{ref[stage]['shape']}")
        for field in ("mean", "std", "absmax"):
            a, b = ref[stage][field], got[stage][field]
            if not np.isclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(f"{name}/{stage}/{field}: original {a} != reloaded {b}: "
                                     "converter layout or folding fault")


def selftest(seed: int = 0, device=None):
    """Round trip through both formats; returns the original's checksums."""
    from online_detection_tpu_torch.models.weights import activation_checksums, load_checkpoint
    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    params = random_params(seed)
    with tempfile.TemporaryDirectory(prefix="odtpu_weights_selftest_") as tmp:
        paths = write_checkpoints(params, tmp)
        ref = activation_checksums(params.to(dev), seed=seed, device=dev)
        for name, path in zip(("caffe2_pkl", "torch_pth"), paths):
            got = activation_checksums(load_checkpoint(path).to(dev), seed=seed, device=dev)
            compare_checksums(ref, got, name)
            print(json.dumps({"selftest": name, "stages": len(got), "ok": True}))
    print(json.dumps({"selftest": "PASS", "stages": sorted(ref)}))
    return ref


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default=None,
                        help=".pkl (Caffe2 Detectron) or .pth checkpoint")
    parser.add_argument("--selftest", action="store_true",
                        help="round trip of random weights through both formats")
    parser.add_argument("--CPU", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    from online_detection_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cpu" if args.CPU else None)
    if args.selftest:
        return selftest(seed=args.seed, device=dev)
    if not args.weights:
        raise SystemExit("one of --weights or --selftest is required")

    from online_detection_tpu_torch.models.weights import activation_checksums, load_checkpoint

    sums = activation_checksums(load_checkpoint(args.weights).to(dev), seed=args.seed,
                                device=dev)
    for stage, rec in sums.items():
        print(json.dumps({"stage": stage, **rec}))
    return sums


if __name__ == "__main__":
    main()
