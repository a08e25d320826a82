"""The port's two SGD CLIs with ``--CPU`` beside the JAX package's, on one
``make_synthetic_icwt`` tree and the SGD test config of
``tests/test_experiment_cli_all.py`` (random full-width weights from seed 0
in each package, so the losses differ in value): the same files written,
finite loss histories of the same length, the cached backbone maps where
asked; then the port's tester over the port's fine-tuned
``model_final.pkl``."""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.experiments import run_experiment_fine_tuning as p_ft
from online_detection_tpu_torch.experiments import run_experiment_full_train as p_full
from online_detection_tpu_torch.experiments import run_experiment_test_feature_task as p_tester
from tests.test_experiment_cli_all import FEAT_CFG

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
import run_experiment_fine_tuning as j_ft  # noqa: E402
import run_experiment_full_train as j_full  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    base = tmp_path_factory.mktemp("sgd_cli")
    root = str(base / "ycbv_synth")
    make_synthetic_icwt(root, n_train=3, n_test=2)
    feat = base / "feat.yaml"
    feat.write_text(FEAT_CFG.format(root=root))
    return {"base": base, "feat": str(feat)}


def outputs(out):
    hist = np.load(os.path.join(out, "loss_history.npy"))
    with open(os.path.join(out, "model_final.pkl"), "rb") as f:
        tree = pickle.load(f)
    return sorted(os.listdir(out)), hist, tree


def assert_like_jax(port_out, jax_out, steps):
    (pnames, phist, ptree), (jnames, jhist, jtree) = outputs(port_out), outputs(jax_out)
    assert [n for n in pnames if n != "log.txt"] == [n for n in jnames if n != "log.txt"]
    assert len(phist) == len(jhist) == steps and np.isfinite(phist).all()
    shapes = lambda t: jax.tree_util.tree_map(lambda a: np.shape(a), t)  # noqa: E731
    assert shapes(ptree) == shapes(jtree)
    assert ptree["box_predictor"]["cls_w"].shape == (2048, 20)


def test_full_train_cli_matches_jax(synth):
    args = ["--config_file", synth["feat"], "--max_iter", "3", "--CPU"]
    p_out, j_out = str(synth["base"] / "port_full"), str(synth["base"] / "jax_full")
    params = p_full.main(["--output_dir", p_out] + args)
    assert params.rpn.conv_w.device.type == "cpu"
    j_full.main(["--output_dir", j_out] + args)
    assert_like_jax(p_out, j_out, 3)


def test_fine_tuning_cli_and_tester(synth):
    args = ["--config_file", synth["feat"], "--max_iter", "2", "--train_for_time", "0h:5m:0s",
            "--use_backbone_features", "--CPU"]
    p_out, j_out = str(synth["base"] / "port_ft"), str(synth["base"] / "jax_ft")
    p_ft.main(["--output_dir", p_out] + args)
    j_ft.main(["--output_dir", j_out] + args)
    assert_like_jax(p_out, j_out, 2)
    feats = sorted(os.listdir(os.path.join(p_out, "features")))
    assert feats == sorted(os.listdir(os.path.join(j_out, "features"))) and len(feats) == 4

    results = p_tester.main(["--output_dir", str(synth["base"] / "tester"), "--models_dir",
                             p_out, "--config_file", synth["feat"], "--CPU"])
    ckpt = os.path.join(p_out, "model_final.pkl")
    assert list(results) == [ckpt]
    assert np.isfinite(results[ckpt]["det_map_0.5"]) and "segm_map_0.5" in results[ckpt]

