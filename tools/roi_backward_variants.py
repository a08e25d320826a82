#!/usr/bin/env python3
"""Where the RoIAlign backward kernel (``online_detection_tpu_torch/csrc/
roi_align_backward.cu``) spends its time on the card.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 tools/roi_backward_variants.py [--seed 0]

1. Builds the kernel as it is, variants made by editing its source, and the
   kernel it replaced (``tools/roi_align_backward_replaced.cu``, same C
   entry point). Variants that drop one piece of work (their outputs are
   wrong; only their times mean something):

   - ``no_atomics``: every atomic add becomes a plain store into a scratch
     of 4 maps, map ``roi % 4`` (31 MB, in L2);
   - ``no_adds``: the contraction runs, but no atomic is sent;
   - ``loads_only``: the consumers contract nothing and add nothing: the
     producer streams g through the ring and builds the tables;
   - ``no_rows``: the columns are contracted, the rows are not walked;
   - ``no_columns``: the rows are walked, the columns are not contracted;

   and other layouts of the same work (outputs checked): ``one_stage`` (a
   ring of one slab, so the next item's load waits for this item's
   contraction and atomics), ``consumers_4`` and ``consumers_12`` (one or
   three warps a channel quarter, not two; twelve shrink the slab to 13
   pooled rows, two slabs a RoI), ``rows_1`` and ``rows_4`` (one or four
   rows at a time, not 8) and ``rolled_pass`` (the second pass over rows
   that more than three bins reach, one row and one bin at a time).
2. Builds a training step's RoIAlign inputs as ``chip_smoke.py``'s SGD phase
   builds them: ``do_train`` at full width for its 16 steps from the same
   numpy seeds, then one ``sample_rois`` draw of 512 boxes on the first
   608x800 teaching canvas (the C4 map [1, 38, 50, 1024]) and g [1, 512, 14,
   14, 1024] f32 from the seed; and ``chip_smoke.py``'s other layouts onto
   the same map (``backward_stress_rois``): 512 copies of one box, 64 boxes
   past the whole map (8 samples per bin and axis), 512 adversarial boxes
   and 512 boxes of the teaching set's object sizes.
3. Times every library on each layout in turns (kernel, replaced, variants,
   then the reverse order; CUDA events, 20 launches each), after holding
   the right ones against the plain version on the CPU within 1e-5 of
   max|ref|. Per layout: the RoIs' mean footprint in cells
   (``chip_smoke.roi_footprint``: one atomic per cell and channel vector)
   and the atomics' bytes beside g's; the bound is ``chip_smoke.py``'s (g,
   dF and the boxes moved once at 3.35 TB/s).

With ``--timeline`` it also builds the kernel with ``clock64`` stamps
(the first 64 items of every block) and prints, per layout, the median
cycles an item: consumer warp 0 waiting for its slab, its whole item, its
column contraction and its row loop, the producer's tables, and the period
between two items. ``ncu`` does not run on the card's machine, so the split
comes from the variants' times and these stamps. Prints one line per layout
and writes ``chiprun_out/roi_backward_variants.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "roi_align_backward.cu"
HEADERS = ("roi_align_common.cuh", "bulk_copy.cuh")
SCRATCH_MAPS = 4  # the no_atomics variant's scratch: this many dF maps
# the kernel this one replaced, as it was (same C entry point)
REPLACED = ROOT / "tools" / "roi_align_backward_replaced.cu"

# variant -> (text in the kernel's source, its replacement), applied in turn
ADD = "atomicAdd(fy + u * row_stride, acc);"
CONSUMERS = "constexpr int CONSUMERS = 8;"
VARIANTS = {
    "kernel": [],
    "no_atomics": [(ADD, f"fy[u * row_stride + (size_t)(roi % {SCRATCH_MAPS}) * a.h * a.w * C]"
                         f" = acc;")],
    "no_adds": [(ADD, "if (acc == 1234.5f) " + ADD)],
    "loads_only": [("if (cl < a.tw && c0 + cl < C) {", "if (false) {")],
    "one_stage": [("constexpr int STAGES = 2;", "constexpr int STAGES = 1;")],
    "consumers_4": [(CONSUMERS, "constexpr int CONSUMERS = 4;")],
    "consumers_12": [(CONSUMERS, "constexpr int CONSUMERS = 12;")],
    "rows_1": [("constexpr int ROWS = 8;", "constexpr int ROWS = 1;")],
    "rows_4": [("constexpr int ROWS = 8;", "constexpr int ROWS = 4;")],
    "rolled_pass": [("#pragma unroll\n            for (int u = 0; u < ROWS; ++u) {\n"
                     "              if (y0 + u > yhi) break;\n",
                     "#pragma unroll 1\n            for (int u = 0; u < ROWS && y0 + u <= yhi; ++u) {\n"),
                    ("#pragma unroll 4\n              for (int k = k0;", "              for (int k = k0;")],
    "no_rows": [("for (int y0 = ylo; y0 <= yhi; y0 += ROWS, fy += ROWS * row_stride) {",
                 "for (int y0 = ylo; y0 < ylo; y0 += ROWS, fy += ROWS * row_stride) {"),
                ("if (k < kk) tb[32 * k] = t[k];", "if (k < kk && t[k] == 1234.5f) tb[32 * k] = t[k];")],
    "no_columns": [("        for (int q = qlo; q <= qhi; ++q) {", "        for (int q = qlo; q < qlo; ++q) {")],
}
# the timeline library: stamps in a device array per (block, item <
# TIMELINE_ITEMS), read back by an extra entry point. Stamps: 0, 1 consumer
# warp 0 before and after its slab wait, 2 before it empties the slab, 3 the
# producer's copy started, 4, 5 its lane 1 after and before the tables; 6, 7
# warp 0's cycles in the column contraction and in the row loop.
TIMELINE_ITEMS = 64
TIMELINE = [
    ("namespace {\n", "namespace {\n"
     f"__device__ long long g_stamps[132 * {TIMELINE_ITEMS} * 8];\n"
     "__device__ __forceinline__ void stamp(int it, int e, long long v) {\n"
     f"  if (it < {TIMELINE_ITEMS}) g_stamps[(blockIdx.x * {TIMELINE_ITEMS} + it) * 8 + e] = v;\n"
     "}\n"),
    ("      if (lane == 0) {\n        bulk::mbar_expect_tx",
     "      if (lane == 0) {\n        stamp(it, 3, clock64());\n        bulk::mbar_expect_tx"),
    ("      const int l = lane - 1;\n",
     "      const int l = lane - 1;\n      if (l == 0) stamp(it, 5, clock64());\n"),
    ("      bulk::mbar_arrive(&full[s]);  // releases",
     "      if (l == 0) stamp(it, 4, clock64());\n      bulk::mbar_arrive(&full[s]);  // releases"),
    ("    bulk::mbar_wait(&full[s], (it / STAGES) & 1);\n",
     "    if (threadIdx.x == 0) stamp(it, 0, clock64());\n"
     "    bulk::mbar_wait(&full[s], (it / STAGES) & 1);\n"
     "    if (threadIdx.x == 0) stamp(it, 1, clock64());\n    long long tq = 0, tr = 0;\n"),
    ("        float t[PC_MAX], v[PC_MAX];\n",
     "        const long long cq = clock64();\n        float t[PC_MAX], v[PC_MAX];\n"),
    ("        float* fy = fout + (size_t)x * C",
     "        const long long cr = clock64();\n        tq += cr - cq;\n"
     "        float* fy = fout + (size_t)x * C"),
    ("              atomicAdd(fy + u * row_stride, acc);  // result unused: a RED\n"
     "            }\n          }\n        }\n",
     "              atomicAdd(fy + u * row_stride, acc);  // result unused: a RED\n"
     "            }\n          }\n        }\n        tr += clock64() - cr;\n"),
    ("    __syncwarp();\n    if (lane == 0) bulk::mbar_arrive(&empty[s]);",
     "    __syncwarp();\n    if (threadIdx.x == 0) {\n      stamp(it, 2, clock64());\n"
     "      stamp(it, 6, tq);\n      stamp(it, 7, tr);\n    }\n"
     "    if (lane == 0) bulk::mbar_arrive(&empty[s]);"),
]
READ_STAMPS = """
extern "C" int odt_clear_stamps() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_stamps)));
}
extern "C" int odt_read_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));
}
"""
# libraries whose outputs are held against the plain version
CHECKED = ("kernel", "one_stage", "consumers_4", "consumers_12", "rows_1", "rows_4",
           "rolled_pass", "replaced", "timeline")
ORDER = ("kernel", "replaced", "no_atomics", "no_adds", "loads_only", "one_stage", "consumers_4",
         "consumers_12", "rows_1", "rows_4", "rolled_pass", "no_rows", "no_columns")


def build_all(_build, timeline=False):
    """One library per variant, one for the replaced kernel and, with
    ``timeline``, one with stamps, nvcc in parallel, under the build
    directory: ({name: entry point}, {name: register lines}, the stamps'
    (clear, read) entry points or None)."""
    text0 = (_build.CSRC / SOURCE).read_text()
    base = _build.BUILD_DIR / "roi_backward_variants"
    sources = {}
    edited = dict(VARIANTS, timeline=TIMELINE) if timeline else VARIANTS
    for name, edits in edited.items():
        text = text0
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"roi_backward_variants: {name}: the kernel source has changed")
            text = text.replace(old, new)
        sources[name] = text
    if timeline:
        sources["timeline"] += READ_STAMPS
    sources["replaced"] = REPLACED.read_text()
    procs = {}
    for name, text in sources.items():
        d = base / name
        d.mkdir(parents=True, exist_ok=True)
        for h in HEADERS:
            (d / h).write_text((_build.CSRC / h).read_text())
        (d / SOURCE).write_text(text)
        so = d / "libroi_align_backward.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs, read_stamps = {}, {}, None
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"roi_backward_variants: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.odt_roi_align_backward
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        libs[name] = fn
        if name == "timeline":
            clear, read = lib.odt_clear_stamps, lib.odt_read_stamps
            clear.restype, clear.argtypes = ctypes.c_int, []
            read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p]
            read_stamps = (clear, read)
        logs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
    return libs, logs, read_stamps


def timeline_cycles(run, read_stamps):
    """Median cycles an item over every block's first items (see TIMELINE)."""
    import numpy as np
    import torch

    clear, read = read_stamps
    run()  # warm
    torch.cuda.synchronize()
    buf = np.zeros((132, TIMELINE_ITEMS, 8), np.int64)
    if clear():
        raise SystemExit("roi_backward_variants: clearing the stamps failed")
    run()
    torch.cuda.synchronize()
    if read(buf.ctypes.data):
        raise SystemExit("roi_backward_variants: reading the stamps failed")
    started = buf[:, :, 1] > 0  # blocks that ran, and the items each ran
    blocks = started.any(1)
    n = int(started[blocks].sum(1).min())
    t = buf[blocks, :n]
    parts = {"slab_wait": t[:, :, 1] - t[:, :, 0], "item": t[:, :, 2] - t[:, :, 1],
             "columns": t[:, :, 6], "rows": t[:, :, 7], "tables": t[:, :, 4] - t[:, :, 5],
             "period": np.diff(t[:, :, 1], axis=1)}
    return {k: float(np.median(v)) for k, v in parts.items() if v.size}


def launcher(fn, g, rois, out):
    """A closure that zeroes ``out`` and launches ``fn`` on (g, rois) into it,
    as the port's wrapper does."""
    import torch

    b, r, p, _, c = g.shape
    h, w = out.shape[-3], out.shape[-2]
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out[0].zero_()  # the scratch past dF needs no zeros
        status = fn(g.data_ptr(), rois.data_ptr(), out.data_ptr(), b, r, h, w, c, p,
                    1.0 / 16.0, stream)
        if status:
            raise SystemExit(f"roi_backward_variants: CUDA error {status}")
    return run


def inputs(seed):
    """(h, w, c, g, {layout: boxes}) on the card: a training step's as
    ``chip_smoke.py``'s SGD phase makes them (its 16 steps of ``do_train``,
    then one ``sample_rois`` draw), and the two stress layouts."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from online_detection_tpu_torch.engine.trainer import SGDConfig, do_train
    from online_detection_tpu_torch.experiments._common import load_configs
    from online_detection_tpu_torch.utils.device import ieee_fp32

    dev = torch.device("cuda")
    _, _, extras = load_configs("config_full_train_ycbv.yaml", None)
    cfg = SGDConfig(**extras["sgd"])._replace(max_iter=cs.SGD_STEPS)
    ds = cs.teaching_set(cs.SGD_IMAGES, seed + 8)
    trained, _ = do_train(cs.sgd_params(seed + 7), ds, cs.CANVAS, cfg,
                          torch.Generator().manual_seed(seed), with_mask=True,
                          min_size=cs.TRAIN_HW[0], log_every=4, device=dev)
    with torch.no_grad(), ieee_fp32():
        c4, rois = cs.step_inputs(trained, ds, cfg, dev, torch.Generator().manual_seed(1))
    _, h, w, c = c4.shape
    rng = np.random.default_rng(seed + 11)
    g = torch.from_numpy(rng.normal(size=(1, rois.shape[1], 14, 14, c)).astype(np.float32)).to(dev)
    layouts = {"training step": rois.float().contiguous()}
    for k, v in cs.backward_stress_rois(rng, rois.shape[1], h, w).items():
        layouts[k] = torch.from_numpy(v).to(dev)
    return h, w, c, g, layouts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeline", action="store_true",
                    help="also build the kernel with clock64 stamps and print its cycles an item")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("roi_backward_variants: this probe needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from online_detection_tpu_torch.ops import _build
    from online_detection_tpu_torch.ops.roi_align import roi_align_backward_reference

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    libs, logs, read_stamps = build_all(_build, args.timeline)
    for k, lines in logs.items():
        print(f"  {k}: {lines}", flush=True)

    h, w, c, g, layouts = inputs(args.seed)
    dev = g.device

    report = {"card": card, "build": logs, "layouts": {}}
    for role, boxes in layouts.items():
        gl = g[:, :boxes.shape[1]].contiguous()
        ref = roi_align_backward_reference(gl.cpu(), boxes.cpu(), h, w)
        tol = 1e-5 * float(ref.abs().max())
        cells = cs.roi_footprint(boxes.cpu(), h, w)
        g_bytes = 4.0 * gl.numel()
        nbytes = g_bytes + 4.0 * (ref.numel() + boxes.numel())
        bound, by = cs.bound_of(cs.roi_ops(boxes, h, w, c), nbytes)
        runs = {}
        for name, fn in libs.items():
            maps = SCRATCH_MAPS if name == "no_atomics" else 1
            out = torch.zeros((maps, h, w, c), device=dev)
            runs[name] = launcher(fn, gl, boxes, out)
            if name in CHECKED:
                runs[name]()
                err = float((out[0].cpu() - ref[0]).abs().max())
                if not err <= tol:
                    raise SystemExit(f"roi_backward_variants: {name} disagrees with the plain "
                                     f"version at {role} (max err {err}, tolerance {tol})")
        times = {k: [] for k in ORDER}
        for name in ORDER + ORDER[::-1]:
            times[name].append(cs.timed(runs[name], 20))
        row = {"shape": list(gl.shape), "rois": int(boxes.shape[1]),
               "footprint_cells_mean": float(cells.float().mean()),
               "atomic_bytes": float(cells.sum()) * c * 4.0, "g_bytes": g_bytes,
               "bound_ms": bound, "bound_by": by, "times_ms": times,
               "mean_ms": {k: sum(v) / len(v) for k, v in times.items()}}
        if read_stamps is not None:
            row["timeline_cycles"] = timeline_cycles(runs["timeline"], read_stamps)
            print(f"{role:14s} median cycles an item: {row['timeline_cycles']}", flush=True)
        report["layouts"][role] = row
        print(f"{role:14s} {row['shape']} footprint {row['footprint_cells_mean']:.1f} cells a "
              f"RoI, atomics {row['atomic_bytes'] / 1e6:.1f} MB beside g {g_bytes / 1e6:.1f} MB; "
              f"bound {bound:.4f} ms ({by}) | "
              + " | ".join(f"{k} {v:.4f}" for k, v in row["mean_ms"].items())
              + f" ms on {card}", flush=True)
        del runs, ref
        torch.cuda.empty_cache()

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "roi_backward_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
