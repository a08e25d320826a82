#!/usr/bin/env python3
"""Where kernel B1 (``online_detection_tpu_torch/csrc/gaussian_mmv.cu``)
spends its time, and how accurate it is, on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/b1_variants.py [--seed 0]

1. Builds the kernel as it is and variants made by editing its source:
   ``rows_64``, the other tile the kernel could take (64 rows a block, one
   consumer warpgroup, 3 stages), and four that each drop one piece of
   work (their outputs are wrong; only their times mean something):

   - ``no_lo_load``: the c_lo tile is not loaded (c_hi stands in for it);
   - ``no_x_load``: the x tile is not loaded;
   - ``no_exp``: the epilogue sums the cross terms without the Gaussian;
   - ``one_pass``: one wgmma per k-step (x_hi c_hi) instead of three;

   and times each through ``mmv_grouped``'s wrapper at the six main-path
   call shapes, on synthetic data at the scale of z-scored features (norm
   20), beside the call's 3xTF32 bound.
2. At the two mining shapes that cancel most (rows drawn next to their
   centers), compares the kernel and the IEEE fp32 plain version each with
   a float64 reference, in units of the sum of the terms' magnitudes.

Prints one line per shape and writes ``chiprun_out/b1_variants.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PEAK_3XTF32_FLOPS = 495e12 / 3  # H100 SXM dense TF32, three passes

# role, groups, rows, centers, d, sigma, x per group, center sets (set_idx)
SHAPES = [
    ("rpn", 15, 15200, 1000, 1024, 50.0, False, None),
    ("detector", 21, 2400, 1000, 2048, 15.0, False, None),
    ("mask", 800, 196, 500, 256, 10.0, True, 21),
    ("mining rpn", 8, 20000, 1000, 1024, 50.0, True, None),
    ("mining detector", 8, 20000, 1000, 2048, 15.0, True, None),
    ("mining mask", 8, 60000, 500, 256, 10.0, True, None),
]

# variant -> (text in the kernel source, its replacement), applied in turn
VARIANTS = {
    "kernel": [],
    "rows_64": [
        ("constexpr int NWG = 2;", "constexpr int NWG = 1;"),
        ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n', ""),
    ],
    "no_lo_load": [
        ("          tma_load_2d(base + X_BYTES + C_BYTES, &tm_lo, &full[stage], kb * BK,\n"
         "                      crow + t * BM);\n", ""),
        ("mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "mbar_expect_tx(&full[stage], STAGE_BYTES - C_BYTES);"),
        ("wgmma_tf32(acc, ah[ks], dlo + 2 * ks);", "wgmma_tf32(acc, ah[ks], dhi + 2 * ks);"),
    ],
    "no_x_load": [
        ("          tma_load_2d(base, &tm_x, &full[stage], kb * BK, xrow);\n", ""),
        ("mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "mbar_expect_tx(&full[stage], STAGE_BYTES - X_BYTES);"),
    ],
    "no_exp": [("return exp2f(fmaxf(fmaf(-2.f, acc, norms), 0.f) * neg_scale);", "return acc;")],
    "one_pass": [
        ("          wgmma_tf32(acc, al[ks], dhi + 2 * ks);\n"
         "          wgmma_tf32(acc, ah[ks], dlo + 2 * ks);\n", ""),
    ],
}


def build_variants(_build):
    """One library per variant (nvcc in parallel) under the build directory."""
    src = (_build.CSRC / "gaussian_mmv.cu").read_text()
    out_dir = _build.BUILD_DIR / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"b1_variants: {name}: the kernel source has changed")
            text = text.replace(old, new)
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                         str(cu)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"b1_variants: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


@contextlib.contextmanager
def library(_build, lib):
    """``mmv_grouped`` launches from ``lib`` inside the block."""
    saved = _build._LIBS.get("gaussian_mmv")
    _build._LIBS["gaussian_mmv"] = lib
    try:
        yield
    finally:
        _build._LIBS["gaussian_mmv"] = saved


def timed(fn, iters=5):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(rng, g, n, m, d, sigma, per_group, sets, near):
    """Centers of norm ~20, and rows either drawn next to their group's
    centers (mining) or at random at the same scale."""
    import torch

    s = sets or g
    c = torch.randn(s, m, d, device="cuda") * (20 / d ** 0.5)
    v = torch.randn(s, m, device="cuda") * 0.1
    if sets:
        set_idx = torch.from_numpy(rng.integers(0, s, g).astype("int32")).cuda()
    else:
        set_idx = torch.arange(g, device="cuda", dtype=torch.int32)
    if near:
        pick = torch.from_numpy(rng.integers(0, m, size=(g, n))).cuda()
        x = c.gather(1, pick[..., None].expand(g, n, d))
        x = x + torch.randn(x.shape, device="cuda") * (0.5 * sigma / d ** 0.5)
    else:
        x = torch.randn((g, n, d) if per_group else (n, d), device="cuda") * (20 / d ** 0.5)
    return x, c, v, set_idx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("b1_variants: this probe needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped, mmv_reference

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    libs = build_variants(_build)
    report = {"card": card, "times_ms": {}, "errors": {}}
    print(f"card: {card}", flush=True)
    for role, g, n, m, d, sigma, per_group, sets in SHAPES:
        x, c, v, set_idx = inputs(rng, g, n, m, d, sigma, per_group, sets, near=False)
        row = {}
        for name, lib in libs.items():
            with library(_build, lib):
                row[name] = timed(lambda: mmv_grouped(x, c, v, sigma, set_idx))
        row["bound"] = 2.0 * g * n * m * (d + 1) / PEAK_3XTF32_FLOPS * 1e3
        report["times_ms"][role] = row
        print(f"{role:16s} " + " | ".join(f"{k} {t:.3f}" for k, t in row.items()), flush=True)
        del x, c, v, set_idx
        torch.cuda.empty_cache()

    with library(_build, libs["kernel"]):
        for role, g, n, m, d, sigma, _, _ in SHAPES[4:]:
            x, c, v, set_idx = inputs(rng, 2, n, m, d, sigma, True, None, near=True)
            exact = mmv_reference(x.double(), c.double(), v.double(), sigma)
            terms = mmv_reference(x.double(), c.double(), v.double().abs(), sigma)
            err = {}
            for name, got in (("kernel", mmv_grouped(x, c, v, sigma)),
                              ("fp32_plain", mmv_reference(x, c, v, sigma))):
                err[name] = float(((got.double() - exact).abs() / terms).max())
            report["errors"][role] = err
            print(f"{role} (2 groups, rows next to centers): max error / sum |terms| vs "
                  f"float64: kernel {err['kernel']:.3g}, fp32 plain {err['fp32_plain']:.3g}",
                  flush=True)
            del x, c, v, exact, terms
            torch.cuda.empty_cache()

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b1_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
