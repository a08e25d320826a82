"""The port's flagship CLI (``online_detection_tpu_torch.experiments.
run_experiment_online_rpn_ood_oos``) with ``--CPU`` on the synthetic tree
and the YAML of the JAX CLI's smoke test (``tests/test_experiment_cli.py``):
save the models and the feature caches, train from the caches, then reload
the models; the JAX CLI runs the same three commands on the same tree.

Both CLIs get the same network: the JAX CLI's random init
(``init_detector_params(jax.random.key(0), ...)``) converted with
``params_from_jax`` is patched into the port CLI's ``load_params``. Their
harvests draw differently (JAX keys against a torch generator), so the
runs are compared by their ``result.txt`` line sequence with the numbers
masked; the port must learn (det and segm mAP@0.5 > 0.3, as the JAX test
asks) and its reloaded models must score within 1e-6 of the saved ones."""

import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

from online_detection_tpu.models.detector import init_detector_params as j_init
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.experiments import _common
from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli
from online_detection_tpu_torch.models.weights import params_from_jax
from tests.test_experiment_cli import FEAT_CFG, ONLINE_CFG
from tests.test_torch_weights import assert_same_params, r50_narrow_tree, write_pkl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
import run_experiment_online_rpn_ood_oos as jax_cli  # noqa: E402

torch.set_num_threads(2)

MODES = {
    "save": ["--save_RPN_detector_segmentation_models",
             "--save_RPN_detector_segmentation_features"],
    "load_features": ["--load_RPN_detector_segmentation_features"],
    "load_models": ["--load_RPN_detector_segmentation_models"],
}
_NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?|nan")


def masked_lines(path):
    """result.txt's lines with every number after the first colon masked."""
    out = []
    for ln in open(path).read().splitlines():
        key, colon, rest = ln.partition(":")
        out.append(key + colon + _NUMBER.sub("N", rest))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flagship_cli")
    root = str(tmp / "ycbv_synth")
    make_synthetic_icwt(root, n_train=4, n_test=3)
    feat, online = tmp / "feat.yaml", tmp / "online.yaml"
    feat.write_text(FEAT_CFG.format(root=root))
    online.write_text(ONLINE_CFG)

    def same_network(weights_arg, extras, num_classes):
        tree = j_init(jax.random.key(0), 15, num_classes + 1)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, tree))

    mp = pytest.MonkeyPatch()
    results = {"port": {}, "jax": {}}
    try:
        mp.setattr(_common, "load_params", same_network)
        for name, main in (("port", cli.main), ("jax", jax_cli.main)):
            out = tmp / name
            for mode, flags in MODES.items():
                results[name][mode] = main(
                    ["--output_dir", str(out), "--config_file_feature_extraction", str(feat),
                     "--config_file_online_rpn_detection_segmentation", str(online), "--CPU"]
                    + flags)
    finally:
        mp.undo()
    return tmp, results


def test_port_cli_learns_and_writes_its_files(runs):
    tmp, results = runs
    port = results["port"]
    for mode in MODES:
        for k in ("det_map_0.5", "segm_map_0.5"):
            assert np.isfinite(port[mode][k]), (mode, k)
    assert port["save"]["det_map_0.5"] > 0.3
    assert port["save"]["segm_map_0.5"] > 0.3
    out = tmp / "port"
    for name in ("classifier_rpn.npz", "classifier_detector.npz",
                 "classifier_segmentation.npz", "regressor_detector.npz",
                 "features_RPN/positives_cl_0_batch_0.npy",
                 "features_detector/negatives_cl_0_batch_0.npy",
                 "features_detector/reg_x_batch_0.npy",
                 "features_segmentation/positives_cl_0_batch_0.npy"):
        assert (out / name).exists(), name


def test_reloaded_models_score_alike(runs):
    _, results = runs
    port = results["port"]
    np.testing.assert_allclose(port["load_models"]["det_map_0.5"], port["save"]["det_map_0.5"],
                               atol=1e-6)
    np.testing.assert_allclose(port["load_models"]["segm_map_0.5"],
                               port["save"]["segm_map_0.5"], atol=1e-6)


def test_result_lines_match_the_jax_cli(runs):
    tmp, _ = runs
    port = masked_lines(tmp / "port" / "result.txt")
    want = masked_lines(tmp / "jax" / "result.txt")
    assert port == want
    assert port[0] == "Detector's features extracted in: Nmin:Ns "
    assert sum(ln.startswith("Detection mAP50") for ln in port) == len(MODES)


def test_unported_options_raise(tmp_path):
    """``--n_devices`` above 1 raises; a weights file, named by ``--weights``
    or by a MODEL.WEIGHT that resolves to it, is loaded."""
    base = ["--output_dir", str(tmp_path), "--CPU"]
    with pytest.raises(NotImplementedError, match="item 10"):
        cli.main(base + ["--n_devices", "2"])
    tree = r50_narrow_tree()
    pkl = write_pkl(tmp_path / "model.pkl", tree)
    want = params_from_jax(tree)
    for args in ((pkl, {}), (str(tmp_path / "missing.pth"), {"weight": pkl}),
                 (None, {"weight": pkl})):
        got = _common.load_params(*args, 21)
        assert_same_params(got, want)
        assert got.rpn.conv_w.device.type == "cpu"


def test_load_params_without_weights_warns_and_builds_random_init(capsys):
    params = _common.load_params(None, {"weight": ""}, 3)
    assert "WARNING" in capsys.readouterr().out
    assert params.rpn.conv_w.device.type == "cpu"
