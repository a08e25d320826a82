"""The port's four remaining experiment CLIs with ``--CPU`` beside the JAX
package's, on one ``make_synthetic_icwt`` tree and the YAML of
``tests/test_experiment_cli_all.py``: the serial flagship, O-RPN + OOD with
``--no_rpn``, segmentation with ``--eval_segm_with_gt_bboxes``, and the
mask visualizer over the segmentation run's saved models.

Both packages get the same network: the JAX CLIs' random init
(``init_detector_params(jax.random.key(0), ...)``) converted with
``params_from_jax`` is patched into the port's ``load_params``. Their
harvests draw differently (JAX keys against torch generators), so the
runs are compared as ``tests/test_torch_flagship_cli.py`` compares them:
the same sorted ``--flag`` sets, the same ``result.txt`` keys (each line's
text before its first colon) in the same order, the mAPs each JAX test asks
for, and the port's models reloaded from its own files scoring within 1e-6
of the run that saved them. With the GT boxes substituted, det mAP is 1 in
both packages (within 1e-6 of each other). The visualizers of both
packages write the same overlays from the same saved models.

The serial CLI's RPN pass reads ``--config_file_rpn``; it is given the
tree's YAML, since the shipped ``config_rpn_ycbv.yaml`` asks for 8 x 2000
negatives a class (a ~1 GB pool per package on the CPU)."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from online_detection_tpu.models.detector import init_detector_params as j_init
from online_detection_tpu_torch.data.datasets.synthetic import make_synthetic_icwt
from online_detection_tpu_torch.experiments import _common
from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood as p_ood
from online_detection_tpu_torch.experiments import (
    run_experiment_online_rpn_ood_oos_serial as p_serial,
)
from online_detection_tpu_torch.experiments import run_experiment_segmentation as p_segm
from online_detection_tpu_torch.experiments import visualize_masks_online_segmentation as p_viz
from online_detection_tpu_torch.models.weights import params_from_jax
from tests.test_experiment_cli_all import FEAT_CFG, ONLINE_CFG

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
import run_experiment_online_rpn_ood as j_ood  # noqa: E402
import run_experiment_online_rpn_ood_oos_serial as j_serial  # noqa: E402
import run_experiment_segmentation as j_segm  # noqa: E402
import visualize_masks_online_segmentation as j_viz  # noqa: E402

torch.set_num_threads(2)

PAIRS = {"serial": (p_serial, j_serial), "ood": (p_ood, j_ood), "segmentation": (p_segm, j_segm),
         "visualizer": (p_viz, j_viz)}


def result_keys(path):
    """result.txt's lines as their text before the first colon."""
    return [ln.split(":")[0].strip() for ln in open(path).read().splitlines()]


def flags_of(module, monkeypatch):
    """The sorted option strings of a CLI's parser."""
    import argparse

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, argv=None: self)
    parser = module.parse_args([])
    monkeypatch.undo()
    return sorted(s for s in parser._option_string_actions if s.startswith("--"))


@pytest.mark.parametrize("cli", sorted(PAIRS))
def test_flags_match_the_jax_cli(cli, monkeypatch):
    port, ref = PAIRS[cli]
    got, want = flags_of(port, monkeypatch), flags_of(ref, monkeypatch)
    assert got == want and "--CPU" in got and "--help" in got


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each CLI through both packages: {name: {"port"|"jax": (results, out)}}."""
    tmp = tmp_path_factory.mktemp("experiment_clis")
    root = str(tmp / "ycbv_synth")
    make_synthetic_icwt(root, n_train=3, n_test=2)
    feat, online = tmp / "feat.yaml", tmp / "online.yaml"
    feat.write_text(FEAT_CFG.format(root=root))
    online.write_text(ONLINE_CFG)
    cache = {}

    def same_network(weights_arg, extras, num_classes):
        if num_classes not in cache:
            tree = j_init(jax.random.key(0), 15, num_classes + 1)
            cache[num_classes] = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        return cache[num_classes]

    cfgs = {"serial": ["--config_file_feature_extraction", str(feat), "--config_file_rpn",
                       str(feat), "--config_file_online_rpn_detection_segmentation",
                       str(online)],
            "ood": ["--config_file_feature_extraction", str(feat),
                    "--config_file_rpn_detection", str(online), "--no_rpn"],
            "segmentation": ["--config_file_feature_extraction", str(feat),
                             "--config_file_online_detection_segmentation", str(online),
                             "--eval_segm_with_gt_bboxes"]}
    saves = {"serial": (["--save_RPN_models", "--save_detector_models",
                         "--save_segmentation_models"],
                        ["--load_RPN_models", "--load_detector_models",
                         "--load_segmentation_models"]),
             "ood": (["--save_detector_models"], ["--load_detector_models"]),
             "segmentation": (["--save_detector_segmentation_models"],
                              ["--load_detector_segmentation_models"])}
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(_common, "load_params", same_network)
        for cli, args in cfgs.items():
            port, ref = PAIRS[cli]
            save, load = saves[cli]
            out[cli] = {}
            for name, main in (("port", port.main), ("jax", ref.main)):
                d = str(tmp / f"{cli}_{name}")
                first = main(["--output_dir", d, "--CPU"] + args + save)
                out[cli][name] = (first, d)
            d = out[cli]["port"][1]
            reloaded = port.main(["--output_dir", d, "--CPU"] + args + load)
            out[cli]["port_reloaded"] = (reloaded, d)
        models = out["segmentation"]["port"][1]
        for name, main in (("port", p_viz.main), ("jax", j_viz.main)):
            d = str(tmp / f"viz_{name}")
            main(["--models_dir", models, "--output_dir", d,
                  "--config_file_feature_extraction", str(feat), "--num_images", "2", "--CPU"])
            out.setdefault("visualizer", {})[name] = (None, d)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("cli", ["serial", "ood", "segmentation"])
def test_result_keys_match_the_jax_cli(runs, cli):
    port = result_keys(os.path.join(runs[cli]["port"][1], "result.txt"))
    want = result_keys(os.path.join(runs[cli]["jax"][1], "result.txt"))
    n = len(want)
    # the port's file holds the reload run's lines after the first run's
    assert port[:n] == want
    assert "Total training time" in port and "Detection mAP50" in port


@pytest.mark.parametrize("cli", ["serial", "ood", "segmentation"])
def test_maps_finite_and_reloaded_models_score_alike(runs, cli):
    port, jax_res, reloaded = (runs[cli][k][0] for k in ("port", "jax", "port_reloaded"))
    assert sorted(port) == sorted(jax_res)
    for k in ("det_map_0.5",) + (("segm_map_0.5",) if cli != "ood" else ()):
        assert np.isfinite(port[k]) and np.isfinite(jax_res[k]), k
        np.testing.assert_allclose(reloaded[k], port[k], atol=1e-6, err_msg=k)
    if cli == "ood":
        assert "segm_map_0.5" not in port


def test_serial_writes_the_rpn_stage_and_recall(runs):
    """As ``tests/test_experiment_cli_all.py::test_serial_cli`` asks."""
    txt = open(os.path.join(runs["serial"]["port"][1], "result.txt")).read()
    assert "RPN's Online Classifier training time" in txt
    assert "Average Recall (AR):" in txt
    for f in ("classifier_rpn.npz", "classifier_detector.npz", "classifier_segmentation.npz"):
        assert os.path.exists(os.path.join(runs["serial"]["port"][1], f)), f


def test_ood_without_rpn_trains_no_rpn(runs):
    """``--no_rpn``: no O-RPN stage timings, and no RPN model file."""
    txt = open(os.path.join(runs["ood"]["port"][1], "result.txt")).read()
    assert "RPN's Online Classifier" not in txt
    assert not os.path.exists(os.path.join(runs["ood"]["port"][1], "classifier_rpn.npz"))


def test_segmentation_with_gt_boxes_detects_exactly(runs):
    """GT-box substitution: detection mAP against the GT boxes is exact by
    design, in both packages."""
    port, jax_res = runs["segmentation"]["port"][0], runs["segmentation"]["jax"][0]
    assert port["det_map_0.5"] > 0.99
    np.testing.assert_allclose(port["det_map_0.5"], jax_res["det_map_0.5"], atol=1e-6)
    assert "segm_map_0.5" in port


def test_visualizers_write_the_same_overlays(runs):
    from PIL import Image

    got_dir, want_dir = runs["visualizer"]["port"][1], runs["visualizer"]["jax"][1]
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names == ["overlay_0000.png", "overlay_0001.png"]
    for n in names:
        got = np.asarray(Image.open(os.path.join(got_dir, n)))
        want = np.asarray(Image.open(os.path.join(want_dir, n)))
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=n)


def test_config_resolves_as_resolve_config(tmp_path):
    cfg = tmp_path / "x.yaml"
    cfg.write_text("{}\n")
    for name, want in (("", True), (None, True), ("config_rpn_ycbv.yaml", True),
                       (str(cfg), True), ("no_such_config.yaml", False),
                       (str(tmp_path / "missing.yaml"), False)):
        assert _common.config_resolves(name) is want, name
        if want:
            _common.resolve_config(name)
        else:
            with pytest.raises(FileNotFoundError):
                _common.resolve_config(name)


def test_clis_without_cpu_flag_raise_before_any_work(monkeypatch, tmp_path):
    """Without ``--CPU`` the CLIs target the card; on a host with no card they
    raise before they read a config or make their output directory. The
    serial CLI's ``--n_devices`` above 1 builds its mesh (of virtual CPU
    entries with ``--CPU``) before any work, as the flagship's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    touched = []
    monkeypatch.setattr(_common, "resolve_config", lambda *a: touched.append(a))
    out = tmp_path / "out"
    for main, extra in ((p_serial.main, []), (p_ood.main, []), (p_segm.main, []),
                        (p_viz.main, ["--models_dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--output_dir", str(out)] + extra)
    assert touched == [] and not out.exists()
    monkeypatch.undo()
    from online_detection_tpu_torch.parallel import mesh as mesh_mod

    meshes = []

    def no_mesh(n_devices, **kw):
        meshes.append((n_devices, str(kw.get("device"))))
        raise LookupError("mesh asked for")

    monkeypatch.setattr(mesh_mod, "make_mesh", no_mesh)
    monkeypatch.setattr(_common, "resolve_config", lambda *a: touched.append(a))
    with pytest.raises(LookupError, match="mesh asked for"):
        p_serial.main(["--output_dir", str(out), "--CPU", "--n_devices", "2"])
    assert meshes == [(2, "cpu")] and touched == [] and not out.exists()
