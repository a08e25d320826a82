"""The port's flagship CLI with ``--weights <a Caffe2 .pkl>`` beside the JAX
CLI given the same file, with ``--CPU`` on one ``make_synthetic_icwt`` tree
and the YAML of the JAX CLI's smoke test: both must write the same masked
``result.txt`` lines. The file holds the JAX package's random init at full
width, written by its exporter: the host route's accumulators hold rows of
the network's full feature widths (1024 / 2048 / 256)."""

import os
import pickle
import sys

import jax
import numpy as np
import torch

from online_detection_tpu.models import weights as jw
from online_detection_tpu.models.detector import init_detector_params as j_init
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli
from tests.test_experiment_cli import FEAT_CFG, ONLINE_CFG
from tests.test_torch_flagship_cli import masked_lines

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
import run_experiment_online_rpn_ood_oos as jax_cli  # noqa: E402

torch.set_num_threads(2)


def test_flagship_cli_with_weights_file_matches_jax(tmp_path):
    root = str(tmp_path / "ycbv_synth")
    make_synthetic_icwt(root, n_train=2, n_test=2)
    feat, online = tmp_path / "feat.yaml", tmp_path / "online.yaml"
    feat.write_text(FEAT_CFG.format(root=root))
    online.write_text(ONLINE_CFG)
    pkl = tmp_path / "full_width.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": jw.export_caffe2_blobs(j_init(jax.random.key(0), 15, 20))}, f)
    base = ["--config_file_feature_extraction", str(feat),
            "--config_file_online_rpn_detection_segmentation", str(online), "--CPU",
            "--weights", str(pkl)]
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        results = main(["--output_dir", str(tmp_path / name)] + base)
        assert np.isfinite(results["det_map_0.5"]), name
    port = masked_lines(tmp_path / "port" / "result.txt")
    assert port == masked_lines(tmp_path / "jax" / "result.txt")
    assert sum(ln.startswith("Detection mAP50") for ln in port) == 1
