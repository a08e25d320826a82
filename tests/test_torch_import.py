"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no source of it imports them, and its entry points refuse to fall
back to the CPU when no card is present."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "online_detection_tpu_torch"
# an import of jax, or of the JAX package itself (not of the port, whose name
# starts with the JAX package's name)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|online_detection_tpu)(\.|\s|,|$)", re.MULTILINE
)


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_fresh_import_loads_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import online_detection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'online_detection_tpu' or k.startswith('online_detection_tpu.'))\n"
        "print(len([k for k in sys.modules if k.startswith('online_detection_tpu_torch')]))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split("\n")
    assert int(out[0]) > 15, out  # every module was imported
    assert out[1] == "[]", out


# modules of the inference stage, the host route, the CLIs, the checkpoint
# files and the facades, and what each must import without
_STAGE_MODULES = {
    "online_detection_tpu_torch.engine.accumulate": None,
    "online_detection_tpu_torch.engine.device_accumulate": None,
    "online_detection_tpu_torch.engine.harvest": None,
    "online_detection_tpu_torch.utils.stats": None,
    "online_detection_tpu_torch.experiments._common": "yaml",
    "online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood_oos": "yaml",
    "online_detection_tpu_torch.config.config": "yaml",
    "online_detection_tpu_torch.data.datasets.icubworld": "PIL",
    "online_detection_tpu_torch.data.datasets.ycb_video": "PIL",
    "online_detection_tpu_torch.data.datasets.synthetic": "PIL",
    "online_detection_tpu_torch.data.evaluation.voc_eval": None,
    "online_detection_tpu_torch.data.evaluation.coco_rle": None,
    "online_detection_tpu_torch.utils.checkpoint": None,
    "online_detection_tpu_torch.utils.telemetry": None,
    "online_detection_tpu_torch.pipelines.online_pipeline": None,
    "online_detection_tpu_torch.models.weights": None,
    "online_detection_tpu_torch.experiments.run_experiment_test_feature_task": "yaml",
    "online_detection_tpu_torch.experiments.weights_smoke": "yaml",
    "online_detection_tpu_torch.modules": "yaml",
    "online_detection_tpu_torch.modules.abstract": None,
    "online_detection_tpu_torch.modules.feature_extractor": "PIL",
    "online_detection_tpu_torch.engine.losses": None,
    "online_detection_tpu_torch.engine.trainer": "PIL",
    "online_detection_tpu_torch.engine.backbone_cache": "PIL",
    "online_detection_tpu_torch.experiments.run_experiment_full_train": "yaml",
    "online_detection_tpu_torch.experiments.run_experiment_fine_tuning": "yaml",
    "online_detection_tpu_torch.modules.facades": "yaml",
    "online_detection_tpu_torch.modules.demo": "PIL",
    "online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood_oos_serial": "yaml",
    "online_detection_tpu_torch.experiments.run_experiment_online_rpn_ood": "yaml",
    "online_detection_tpu_torch.experiments.run_experiment_segmentation": "yaml",
    "online_detection_tpu_torch.experiments.visualize_masks_online_segmentation": "PIL",
    "online_detection_tpu_torch.data.ho3d_to_icwt": "PIL",
    "online_detection_tpu_torch.utils.flops": None,
    "online_detection_tpu_torch.parallel.mesh": None,
    "online_detection_tpu_torch.utils.native_io": None,
    "online_detection_tpu_torch.data.loader": "PIL",
}


@pytest.mark.parametrize("module", sorted(_STAGE_MODULES))
def test_stage_module_imports_alone(module):
    """Each module of the inference stage, the host route and the CLI imports
    in a fresh interpreter without JAX, and the config, dataset and CLI
    modules with PyYAML or PIL blocked: they import those only in the
    functions that read a YAML file or an image."""
    blocked = _STAGE_MODULES[module]
    code = (
        "import sys, importlib\n"
        f"if {blocked!r}:\n"
        f"    sys.modules[{blocked!r}] = None  # any import of it raises\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', "
        "'online_detection_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_port_source_imports_jax():
    sources = _port_sources()
    assert len(sources) > 15
    offenders = [str(p) for p in sources if _FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_import_pattern_catches_jax_imports():
    """The pattern above tells the JAX package from the port."""
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from online_detection_tpu.ops import nms")
    assert _FORBIDDEN.search("    import online_detection_tpu\n")
    assert not _FORBIDDEN.search("from online_detection_tpu_torch.ops import nms")
    assert not _FORBIDDEN.search("import jaxlib_free_module")


def test_resolve_device_raises_without_card(monkeypatch):
    from online_detection_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_detect_batched_without_device_raises_before_running(monkeypatch):
    """With no ``device`` the entry point targets the card; on a host with no
    card it raises instead of carrying on on the CPU."""
    from online_detection_tpu_torch.models import detector, resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(resnet, "backbone_c4", lambda *a: ran.append(a))
    images = np.zeros((1, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        detector.detect_batched(None, None, np.zeros((0, 4), np.float32), images,
                                [[32, 32]])
    assert ran == []


def test_detect_batched_scopes_the_tf32_flags(monkeypatch):
    """The entry point runs with TF32 off and gives the caller's flags back,
    also when it raises."""
    from online_detection_tpu_torch.models import detector

    seen = []

    def record(device):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        raise RuntimeError("stop")

    monkeypatch.setattr(detector, "resolve_device", record)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="stop"):
        detector.detect_batched(None, None, None, None, None, device="cpu")
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_kernel_wrappers_take_plain_version_only_on_cpu_tensors():
    """The launch counters stay at zero on CPU tensors: the plain versions ran."""
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped, split_tf32
    from online_detection_tpu_torch.ops.roi_align import (
        roi_align_backward,
        roi_align_batched,
        roi_align_fused2,
    )
    from online_detection_tpu_torch.ops.stem_pool import stem_fused

    _build.reset_launches()
    mmv_grouped(torch.ones(3, 4), torch.ones(2, 5, 4), torch.ones(2, 5), 1.0)
    split_tf32(torch.ones(2, 4))
    stem_fused(torch.ones(1, 8, 8, 3), torch.ones(64, 3, 7, 7), torch.ones(64),
               torch.zeros(64))
    roi_align_batched(torch.ones(1, 4, 4, 2), torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]))
    roi_align_fused2(torch.ones(1, 4, 4, 2), torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]))
    roi_align_backward(torch.ones(1, 1, 14, 14, 2), torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]),
                       4, 4)
    assert _build.LAUNCHES == {"gaussian_mmv": 0, "tf32_split": 0, "stem_pool": 0,
                               "roi_align": 0, "roi_align_fused2": 0, "roi_align_backward": 0}


def test_training_entry_points_without_device_raise_before_running(monkeypatch):
    """With no ``device`` the harvest and the training target the card; on a
    host with no card they raise before reading any data."""
    from online_detection_tpu_torch.pipelines import device_pipeline as dp
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Untouchable:
        def __len__(self):
            raise AssertionError("the dataset was read")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.harvest_dataset_device(None, None, Untouchable(), OnlineTrainConfig(), (64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.train_online_modules_device(None, None, OnlineTrainConfig())


def test_run_inference_without_device_raises_before_running(monkeypatch):
    """With no ``device`` the inference stage targets the card; on a host with
    no card it raises before reading any data."""
    from online_detection_tpu_torch.pipelines.online_pipeline import run_inference

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Untouchable:
        def __len__(self):
            raise AssertionError("the dataset was read")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(None, None, Untouchable(), (64, 64))


def test_host_route_entry_points_without_device_raise_before_running(monkeypatch):
    """With no ``device`` the host route's harvest and training target the
    card; on a host with no card they raise before reading any data."""
    from online_detection_tpu_torch.pipelines import online_pipeline as pipe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Untouchable:
        def __len__(self):
            raise AssertionError("the dataset was read")

        def __getitem__(self, key):
            raise AssertionError("the harvest was read")

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.harvest_dataset(None, None, Untouchable(), pipe.OnlineTrainConfig(), (64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.train_online_modules(None, Untouchable(), pipe.OnlineTrainConfig())


def test_cli_without_cpu_flag_raises_before_any_work(monkeypatch, tmp_path):
    """The flagship CLI without ``--CPU`` targets the card; on a host with no
    card it raises before it reads a config or makes its output directory."""
    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.experiments import run_experiment_online_rpn_ood_oos as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    touched = []
    monkeypatch.setattr(_common, "resolve_config", lambda *a: touched.append(a))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--output_dir", str(out)])
    assert touched == [] and not out.exists()


def test_checkpoint_entry_points_without_device_raise_before_running(monkeypatch, tmp_path):
    """With no ``device`` (or ``--CPU``) the stock path, the checksums, the
    tester CLI, ``weights_smoke`` and the facade target the card; on a host
    with no card they raise before any work."""
    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.experiments import run_experiment_test_feature_task as tester
    from online_detection_tpu_torch.experiments import weights_smoke
    from online_detection_tpu_torch.models import detector, weights
    from online_detection_tpu_torch.modules.feature_extractor import FeatureExtractor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    touched = []
    monkeypatch.setattr(_common, "resolve_config", lambda *a: touched.append(a))
    monkeypatch.setattr(weights, "load_checkpoint", lambda *a: touched.append(a))
    out = tmp_path / "out"
    calls = [
        lambda: detector.detect_pretrained(None, None, np.zeros((32, 32, 3), np.uint8), (32, 32)),
        lambda: weights.activation_checksums(None),
        lambda: tester.main(["--output_dir", str(out), "--models_dir", str(tmp_path)]),
        lambda: weights_smoke.main(["--weights", str(tmp_path / "m.pkl")]),
        lambda: weights_smoke.main(["--selftest"]),
        lambda: FeatureExtractor(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert touched == [] and not out.exists()


def test_sgd_entry_points_without_device_raise_before_running(monkeypatch, tmp_path):
    """With no ``device`` (or ``--CPU``) the SGD trainer, the backbone dump, the
    facade's training and both SGD CLIs target the card; on a host with no
    card they raise before any work."""
    from online_detection_tpu_torch.engine.backbone_cache import dump_backbone_features
    from online_detection_tpu_torch.engine.trainer import SGDConfig, do_train
    from online_detection_tpu_torch.experiments import _common
    from online_detection_tpu_torch.experiments import run_experiment_fine_tuning as ft
    from online_detection_tpu_torch.experiments import run_experiment_full_train as full

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    touched = []
    monkeypatch.setattr(_common, "resolve_config", lambda *a: touched.append(a))

    class Untouchable:
        def __len__(self):
            raise AssertionError("the dataset was read")

    out = tmp_path / "out"
    calls = [
        lambda: do_train(None, Untouchable(), (64, 64), SGDConfig()),
        lambda: dump_backbone_features(None, Untouchable(), str(out), (64, 64)),
        lambda: full.main(["--output_dir", str(out)]),
        lambda: ft.main(["--output_dir", str(out), "--use_backbone_features"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert touched == [] and not out.exists()
