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
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped
    from online_detection_tpu_torch.ops.roi_align import roi_align_batched
    from online_detection_tpu_torch.ops.stem_pool import stem_fused

    _build.reset_launches()
    mmv_grouped(torch.ones(3, 4), torch.ones(2, 5, 4), torch.ones(2, 5), 1.0)
    stem_fused(torch.ones(1, 8, 8, 3), torch.ones(64, 3, 7, 7), torch.ones(64),
               torch.zeros(64))
    roi_align_batched(torch.ones(1, 4, 4, 2), torch.tensor([[[0.0, 0.0, 30.0, 30.0]]]))
    assert _build.LAUNCHES == {"gaussian_mmv": 0, "stem_pool": 0, "roi_align": 0}
