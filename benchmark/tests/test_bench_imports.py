"""Nothing the benchmark runs loads JAX, the JAX package or the chip smoke,
compared by whole top-level names (the port's name begins with the JAX
package's); the reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "online_detection_tpu", "chip_smoke"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "online_detection_tpu_torch" not in tops, path


def test_a_run_loads_no_jax():
    code = (
        "import json, sys, time\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.tests.conftest import tiny\n"
        "from benchmark.harness import run_cell\n"
        "from benchmark.run import loaded_forbidden\n"
        "spec = json.load(open('BENCHMARK.json'))\n"
        "run_cell(spec, 'icwt30.teach', 7, 0.2, False, 'cpu', time.time(), tiny(spec, 'icwt30.teach'))\n"
        "print(loaded_forbidden())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env={"PATH": "/usr/bin:/bin", "ODTPU_COMPUTE_DTYPE": "bfloat16",
                                         "HOME": str(ROOT)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
