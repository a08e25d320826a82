#!/usr/bin/env python3
"""The benchmark of the PyTorch + CUDA port (``online_detection_tpu_torch``).

Runs one cell once, from the root of a checkout, on the machine's card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It makes the weights and the inputs from the seed, warms up every shape the
cell uses (set-up), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints the result as the last
line of standard output: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics) and ``device``. The numbers compared, each with its
limit, are the last lines of standard error and the result's last key,
``check``. It exits non-zero, printing no result, without a CUDA card, in a
directory that lacks the port, or when JAX was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "online_detection_tpu", "chip_smoke")


def fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def loaded_forbidden():
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache lives at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark_cache" / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    # one process with few threads: the host's thread pools neither spin
    # beside the loop that drives the card nor follow the host's core count
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if not (ROOT / "online_detection_tpu_torch" / "csrc").is_dir():
        return fail(f"no online_detection_tpu_torch package in {ROOT}", 4)
    import torch

    from_bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = {w["name"]: w["chips"] for w in from_bench["workloads"]}.get(args.workload)
    if chips is None:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"needs {chips} CUDA card(s); torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found", 3)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import cell_spec, kind_of, run_cell
    from online_detection_tpu_torch.ops import _build

    _build.build_all(kind_of(cell_spec(from_bench, args.workload)[2]["kind"]).KERNELS)
    result, lines = run_cell(from_bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    bad = loaded_forbidden()
    if bad:
        return fail(f"modules loaded that the benchmark may not run: {bad}", 5)
    out, err = result_lines(result, lines)
    print("\n".join(out), flush=True)
    print("\n".join(err), file=sys.stderr, flush=True)
    return 0


def result_lines(result, lines):
    """(standard output's last lines, standard error's last lines): the
    extra readings, then the result object with the numbers compared as its
    last key; on standard error the numbers compared beside their limits."""
    result = dict(result)
    extra = result.pop("extra")
    check = result.pop("check")
    result["check"] = check
    return [json.dumps({"extra": extra}), json.dumps(result)], list(lines)


if __name__ == "__main__":
    sys.exit(main())
