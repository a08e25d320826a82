#!/usr/bin/env python3
"""Where kernel B1 (``online_detection_tpu_torch/csrc/gaussian_mmv.cu``)
spends its time, and how accurate it is, on the card, beside the kernel it
replaced (``tools/gaussian_mmv_replaced.cu``: the same 3xTF32 products, all
of d summed into one tensor-core accumulator, 256-center tiles).

Run from the root of a checkout on a machine with one NVIDIA GPU (~4 min):

    python3 tools/b1_variants.py [--seed 0] [--draws 6] [--no-training]

1. Builds the kernel as it is and variants made by editing its source:
   ``rows_64`` (64 rows a block, one consumer warpgroup), ``stages_2`` and
   ``stages_3`` (a ring of 2 or 3 stages), ``flush_2`` (the tensor cores
   sum two stages before each FADD), ``one_acc`` (one accumulator over all
   of d, at this kernel's tile: the replaced kernel's sums), and four that
   each drop one piece of work (their outputs are wrong; only their times
   mean something): ``no_lo_load`` (the c_lo tile is not loaded; c_hi
   stands in for it), ``no_x_load``, ``no_exp`` (the epilogue sums the
   accumulators without the Gaussian), ``one_pass`` (one wgmma per k-step,
   x_hi c_hi). Beside them the replaced kernel and its variants, levers
   against fault C5 (``ROADMAP.md`` section C): ``replaced_kahan`` (its
   in-kernel ``|x|^2`` summed with Kahan's compensation),
   ``replaced_fourth`` (a fourth product, x_lo c_lo), ``shift`` (x and c
   shifted by the center set's mean in torch before it; its time includes
   the shift), and two that write parts of its arithmetic out instead of
   the mmv (``replaced_norms``: its ``|x|^2``; ``replaced_cross``: its
   cross term x.c, [G, N, 256 * tiles]). Every build is first run in a
   child process at a small and a main-path shape (a fault there cannot
   take this process's CUDA context with it); a variant whose child fails
   is reported and left out.
2. Times each through the wrappers at the six main-path call shapes, on
   synthetic data at the scale of z-scored features (norm 20), beside the
   call's 3xTF32 bound.
3. The mining passes of ``chip_smoke.py``'s training (its harvest of 64
   teaching images, then ``train_online_modules_device`` from the
   harvest's generator, and again from generators seeded 1 .. ``--draws``:
   the draws of ``tools/map_by_training_draw.py``), each pass scored by the
   IEEE fp32 plain version (the training it gives) with every candidate run
   beside it on the same inputs: each one's largest distance from the
   float64 scores, in units of the sum of the terms' magnitudes, by draw.
   The norms of the passes' rows and centers (median, 99th percentile,
   maximum) and their cosines to the set's mean center, by head. On the
   pass where the replaced kernel errs most, its error split into parts,
   each carried to the output to first order: the split (the float64 sum
   of the tf32 halves' products without lo.lo, against x.c), its in-kernel
   ``|x|^2`` and its split kernel's ``|c|^2`` (against float64), and the
   rest of its cross term's error, which is the tensor cores' accumulation.
4. ``chip_smoke.mining_rows_error`` (the smoke's seed-built check of B1 on
   rows with the mining rows' norms) for every candidate, at the smoke's
   cosine to a common direction and at 0.8, 0.9 and 1.0.

Prints one line per shape, draw and check, and writes
``chiprun_out/b1_variants.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
REPLACED_SOURCE = ROOT / "tools" / "gaussian_mmv_replaced.cu"
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

_FOURTH = ("          wgmma_tf32(acc, al[ks], dhi + 2 * ks);\n",
           "          wgmma_tf32(acc, al[ks], dlo + 2 * ks);\n"
           "          wgmma_tf32(acc, al[ks], dhi + 2 * ks);\n")
_FIRST = "          wgmma_tf32(acc, al[ks], dhi + 2 * ks, ks);\n"
_SUM = "#pragma unroll\n        for (int i = 0; i < 64; ++i) sum[i] += acc[i];\n"

# variant -> (text in the kernel source, its replacement), applied in turn
VARIANTS = {
    "kernel": [],
    "rows_64": [
        ("constexpr int NWG = 2;", "constexpr int NWG = 1;"),
        ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n', ""),
        ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n', ""),
    ],
    "stages_2": [("constexpr int STAGES = 4;", "constexpr int STAGES = 2;")],
    "stages_3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    # the tensor cores sum two stages (64 columns) before each FADD
    "flush_2": [
        (_FIRST, _FIRST.replace(", ks);", ", (kb & 1) | ks);")),
        (_SUM, "        if ((kb & 1) || kb == kblocks - 1) {\n  " + _SUM.replace("\n", "\n  ", 1)
         + "        }\n"),
    ],
    # one accumulator over all of d, as the replaced kernel, at this tile
    "one_acc": [
        (_FIRST, _FIRST.replace(", ks);", ", (kb != 0) | ks);")),
        (_SUM, "        if (kb == kblocks - 1) {\n  " + _SUM.replace("\n", "\n  ", 1)
         + "        }\n"),
    ],
    "no_lo_load": [
        ("          bulk::tma_load_2d(base + X_BYTES + C_BYTES, &tm_lo, &full[stage], kb * BK,\n"
         "                            crow + t * BM);\n", ""),
        ("bulk::mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "bulk::mbar_expect_tx(&full[stage], STAGE_BYTES - C_BYTES);"),
        ("wgmma_tf32(acc, ah[ks], dlo + 2 * ks, 1);", "wgmma_tf32(acc, ah[ks], dhi + 2 * ks, 1);"),
    ],
    "no_x_load": [
        ("          bulk::tma_load_2d(base, &tm_x, &full[stage], kb * BK, xrow);\n", ""),
        ("bulk::mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "bulk::mbar_expect_tx(&full[stage], STAGE_BYTES - X_BYTES);"),
    ],
    "no_exp": [("return exp2f(fmaxf(fmaf(-2.f, acc, norms), 0.f) * neg_scale);", "return acc;")],
    "one_pass": [
        (_FIRST + "          wgmma_tf32(acc, ah[ks], dlo + 2 * ks, 1);\n"
         "          wgmma_tf32(acc, ah[ks], dhi + 2 * ks, 1);\n",
         "          wgmma_tf32(acc, ah[ks], dhi + 2 * ks, ks);\n"),
    ],
}

_REPLACED_WRITE = ("      if (r0 < n) out[(long long)g * n + r0] = p0;\n"
                   "      if (r1 < n) out[(long long)g * n + r1] = p1;\n")
_REPLACED_EPILOGUE = (
    "        p0 = fmaf(gauss(xs0 + cc.x, acc[4 * j + 0], neg_scale), vv.x, p0);\n"
    "        p0 = fmaf(gauss(xs0 + cc.y, acc[4 * j + 1], neg_scale), vv.y, p0);\n"
    "        p1 = fmaf(gauss(xs1 + cc.x, acc[4 * j + 2], neg_scale), vv.x, p1);\n"
    "        p1 = fmaf(gauss(xs1 + cc.y, acc[4 * j + 3], neg_scale), vv.y, p1);\n")
_QUAD_NORMS = "      xs1 += __shfl_xor_sync(0xffffffffu, xs1, 2);\n"

# variants of the replaced kernel's source
REPLACED_VARIANTS = {
    "replaced": [],
    "replaced_kahan": [
        ("__device__ __forceinline__ float gauss(",
         "__device__ __forceinline__ void kahan_sq(float& s, float& e, float a) {\n"
         "  const float y = fmaf(a, a, -e);\n"
         "  const float t = s + y;\n"
         "  e = (t - s) - y;\n"
         "  s = t;\n"
         "}\n\n"
         "__device__ __forceinline__ float gauss("),
        ("float xs0 = 0.f, xs1 = 0.f;", "float xs0 = 0.f, xs1 = 0.f, e0 = 0.f, e1 = 0.f;"),
        ("          xs0 = fmaf(a2, a2, fmaf(a0, a0, xs0));\n"
         "          xs1 = fmaf(a3, a3, fmaf(a1, a1, xs1));\n",
         "          kahan_sq(xs0, e0, a0);\n"
         "          kahan_sq(xs0, e0, a2);\n"
         "          kahan_sq(xs1, e1, a1);\n"
         "          kahan_sq(xs1, e1, a3);\n"),
        ("      xs0 += __shfl_xor_sync(0xffffffffu, xs0, 1);\n",
         "      xs0 -= e0;\n"
         "      xs1 -= e1;\n"
         "      xs0 += __shfl_xor_sync(0xffffffffu, xs0, 1);\n"),
    ],
    "replaced_fourth": [_FOURTH],
    "replaced_norms": [
        (_QUAD_NORMS, _QUAD_NORMS
         + "      if (q == 0 && t == 0) {\n"
           "        if (r0 < n) out[(long long)g * n + r0] = xs0;\n"
           "        if (r1 < n) out[(long long)g * n + r1] = xs1;\n"
           "      }\n"),
        (_REPLACED_WRITE, ""),
    ],
    "replaced_cross": [
        (_REPLACED_EPILOGUE,
         "        const long long at = (long long)tiles * BM, col = t * BM + 8 * j + 2 * q;\n"
         "        if (r0 < n) {\n"
         "          out[((long long)g * n + r0) * at + col] = acc[4 * j + 0];\n"
         "          out[((long long)g * n + r0) * at + col + 1] = acc[4 * j + 1];\n"
         "        }\n"
         "        if (r1 < n) {\n"
         "          out[((long long)g * n + r1) * at + col] = acc[4 * j + 2];\n"
         "          out[((long long)g * n + r1) * at + col + 1] = acc[4 * j + 3];\n"
         "        }\n"),
        (_REPLACED_WRITE, ""),
    ],
}
# variants whose output is not the mmv
DIAGNOSTIC = ("replaced_norms", "replaced_cross")
# variants whose output is the mmv but whose work is cut: timed, not held
CUT = ("no_lo_load", "no_x_load", "no_exp", "one_pass")
# variants with the kernel's arithmetic in another layout: timed only
TIMED = ("rows_64", "stages_2", "stages_3")


def variant_sources(_build):
    """name -> (source text, the replaced kernel's interface?)"""
    out = {}
    for base, variants, replaced in ((_build.CSRC / "gaussian_mmv.cu", VARIANTS, False),
                                     (REPLACED_SOURCE, REPLACED_VARIANTS, True)):
        src = base.read_text()
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"b1_variants: {name}: the kernel source has changed")
                text = text.replace(old, new)
            out[name] = (text, replaced)
    return out


def build_variants(_build):
    """One library per variant (nvcc in parallel) under the build directory:
    name -> (path, the replaced kernel's interface?, nvcc log)."""
    out_dir = _build.BUILD_DIR / "b1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, replaced) in variant_sources(_build).items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                                         str(_build.CSRC), "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so, replaced)
    built = {}
    for name, (proc, so, replaced) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"b1_variants: nvcc failed for {name}:\n{log}", flush=True)
            continue
        built[name] = (so, replaced, log)
    return built


def replaced_mmv(lib, x, centers, v, sigma, set_idx=None, out=None):
    """The replaced kernel through its own interface (the split, then the
    mmv into ``out``, [G, N] unless a diagnostic variant writes more)."""
    import torch

    from online_detection_tpu_torch.ops.gaussian_mmv import _groups

    set_idx, g = _groups(x, centers, set_idx)
    s, m, d = centers.shape
    n = x.shape[-2]
    x, centers = x.contiguous(), centers.contiguous()
    v, set_idx = v.contiguous(), set_idx.to(torch.int32).contiguous()
    hi, lo = torch.empty_like(centers), torch.empty_like(centers)
    sq = torch.empty((s, m), device=x.device)
    dev = torch.cuda.current_stream(x.device).cuda_stream
    split = lib.odt_split_tf32
    split.restype = ctypes.c_int
    split.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    if split(centers.data_ptr(), hi.data_ptr(), lo.data_ptr(), sq.data_ptr(), s * m, d, dev):
        raise RuntimeError("the replaced split kernel failed")
    if out is None:
        out = torch.empty((g, n), device=x.device)
    fn = lib.odt_mmv_grouped
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [
                       ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    shared = x.dim() == 2
    if fn(x.data_ptr(), n if shared else g * n, 0 if shared else n, hi.data_ptr(),
          lo.data_ptr(), s * m, sq.data_ptr(), v.data_ptr(), set_idx.data_ptr(), out.data_ptr(),
          g, n, m, d, float(sigma), dev):
        raise RuntimeError("the replaced mmv kernel failed")
    return out, sq


@contextlib.contextmanager
def library(_build, lib):
    """``mmv_grouped`` launches from ``lib`` inside the block."""
    saved = _build._LIBS.get("gaussian_mmv")
    _build._LIBS["gaussian_mmv"] = lib
    try:
        yield
    finally:
        _build._LIBS["gaussian_mmv"] = saved


def candidate_fn(_build, name, lib, replaced):
    """(x, centers, v, sigma, set_idx) -> [G, N] through variant ``name``."""
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_grouped

    if replaced:
        return lambda x, c, v, sigma, set_idx=None: replaced_mmv(lib, x, c, v, sigma,
                                                                 set_idx)[0]

    def run(x, c, v, sigma, set_idx=None):
        with library(_build, lib):
            return mmv_grouped(x, c, v, sigma, set_idx)
    return run


def shifted(fn):
    """``fn`` on x and the centers shifted by each center set's mean (exact
    in real arithmetic): group g's rows by its set's mean."""
    def run(x, c, v, sigma, set_idx=None):
        from online_detection_tpu_torch.ops.gaussian_mmv import _groups

        set_idx, g = _groups(x, c, set_idx)
        mu = c.mean(1)  # [S, d]
        xs = (x if x.dim() == 3 else x.expand(g, *x.shape)) - mu[set_idx.long()][:, None]
        return fn(xs.contiguous(), (c - mu[:, None]).contiguous(), v, sigma, set_idx)
    return run


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


def float64_scores(x, c, v, sigma, set_idx=None):
    """(the float64 plain version's output, its sum |terms|)."""
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference

    x64, c64, v64 = x.double(), c.double(), v.double()
    return (mmv_reference(x64, c64, v64, sigma, set_idx),
            mmv_reference(x64, c64, v64.abs(), sigma, set_idx))


def rel_to_terms(got, ref, terms):
    """max over outputs of |got - ref| / terms; outputs whose float64 value
    is not finite are left out."""
    import torch

    finite = torch.isfinite(ref)
    terms = torch.where(finite, terms, 1.0).clamp(min=1e-30)
    return float((torch.where(finite, (got.double() - ref).abs(), 0.0) / terms).max())


def probe(name: str) -> int:
    """Child process: variant ``name`` against float64 at a small shape and
    at the detector's mining shape; exit 0 if it runs and agrees within
    1e-4 of sum |terms| (a cut variant: if it runs). A first look for gross
    faults: the accuracy is measured in the parent."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from online_detection_tpu_torch.ops import _build

    so = _build.BUILD_DIR / "b1_variants" / f"lib{name}.so"
    replaced = name.startswith("replaced")
    fn = candidate_fn(_build, name, ctypes.CDLL(str(so)), replaced)
    rng = np.random.default_rng(0)
    worst = 0.0
    for g, n, m, d, sigma, per_group, sets in ((3, 37, 50, 24, 4.0, True, None),
                                               (8, 20000, 1000, 2048, 15.0, True, None)):
        x, c, v, set_idx = inputs(rng, g, n, m, d, sigma, per_group, sets, near=True)
        if name == "replaced_cross":
            mt = -(-m // 256) * 256
            out = torch.empty((g, n, mt), device="cuda")
            replaced_mmv(ctypes.CDLL(str(so)), x, c, v, sigma, out=out)
            got = out[..., :m]
            want = torch.einsum("gnd,gmd->gnm", x.double(), c.double())
            worst = max(worst, float(((got - want).abs() / want.abs().max()).max()))
        elif name == "replaced_norms":
            got = fn(x, c, v, sigma)
            want = (x.double() ** 2).sum(-1)
            worst = max(worst, float(((got - want).abs() / want).max()))
        else:
            got = fn(x, c, v, sigma)
            torch.cuda.synchronize()
            if name not in CUT:
                worst = max(worst, rel_to_terms(got, *float64_scores(x, c, v, sigma)))
        torch.cuda.synchronize()
    print(json.dumps({"name": name, "worst": worst}), flush=True)
    return 0 if worst <= 1e-4 else 1


def probe_all(built, parallel=4) -> dict:
    """Each variant's ``probe`` in a child process (``parallel`` at a time):
    name -> its record, or None if the child failed (then the variant is
    left out)."""
    ok, names = {}, list(built)
    for i in range(0, len(names), parallel):
        procs = {name: subprocess.Popen([sys.executable, __file__, "--probe", name],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)
                 for name in names[i:i + parallel]}
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                print(f"b1_variants: {name}: the probe did not end in 300 s", flush=True)
                ok[name] = None
                continue
            if proc.returncode:
                print(f"b1_variants: {name}: the probe failed:\n{out[-2000:]}{err[-3000:]}",
                      flush=True)
                ok[name] = None
                continue
            ok[name] = json.loads(out.strip().splitlines()[-1])
            print(f"  probe {name}: max error {ok[name]['worst']:.3g}", flush=True)
    return ok


def norm_stats(rows) -> dict:
    """median, 99th percentile and maximum of the norms of the nonzero rows."""
    import torch

    norms = torch.cat([r.flatten() for r in rows])
    norms = norms[norms > 0].double()
    if norms.numel() == 0:
        return {}
    return {"rows": int(norms.numel()), "median": float(norms.median()),
            "p99": float(torch.quantile(norms[torch.randperm(norms.numel())[:1 << 24]],
                                        0.99)),
            "max": float(norms.max())}


def quantiles(values) -> dict:
    """median, 1st and 99th percentiles of a list of 1-D tensors."""
    import torch

    if not values:
        return {}
    v = torch.cat(values).double()
    v = v[torch.randperm(v.numel())[:1 << 24]]
    return {k: float(torch.quantile(v, q)) for k, q in (("p1", 0.01), ("median", 0.5),
                                                         ("p99", 0.99))}


def decompose(lib, x, c, v, sigma) -> dict:
    """The replaced kernel's error on one mining pass (x [G, N, d], one set
    a group), split into parts and each carried to the output to first
    order, max over outputs in units of sum |terms|. A part's error dq in
    the squared distance of (n, m) moves the output by -sum_m v K dq /
    (2 sigma^2)."""
    import torch

    from online_detection_tpu_torch.ops.gaussian_mmv import _round_tf32

    g, n, d = x.shape
    m = c.shape[1]
    mt = -(-m // 256) * 256
    cross = torch.empty((g, n, mt), device=x.device)
    replaced_mmv(lib["replaced_cross"], x, c, v, sigma, out=cross)
    xn_k, cn_k = replaced_mmv(lib["replaced_norms"], x, c, v, sigma)
    out_k, _ = replaced_mmv(lib["replaced"], x, c, v, sigma)
    parts = {k: 0.0 for k in ("total", "linear_sum", "split", "x_norms", "c_norms",
                              "accumulation")}
    dq_max = {k: 0.0 for k in ("split", "x_norms", "c_norms", "accumulation")}
    two_s2 = 2.0 * sigma * sigma
    for i in range(g):
        x64, c64, v64 = x[i].double(), c[i].double(), v[i].double()
        xc = x64 @ c64.T
        xh, ch = _round_tf32(x[i]), _round_tf32(c[i])
        xl, cl = _round_tf32(x[i] - xh), _round_tf32(c[i] - ch)
        xh, xl, ch, cl = xh.double(), xl.double(), ch.double(), cl.double()
        xc_split = xh @ ch.T + xh @ cl.T + xl @ ch.T
        xn, cn = (x64 * x64).sum(1), (c64 * c64).sum(1)
        sq = (xn[:, None] + cn[None] - 2 * xc).clamp(min=0)
        k = torch.exp(-sq / two_s2)
        terms = (k @ v64.abs()).clamp(min=1e-300)
        exact = k @ v64
        near = k > 1e-3  # pairs whose Gaussian reaches the output
        dqs = {"split": -2 * (xc_split - xc),
               "accumulation": -2 * (cross[i, :, :m].double() - xc_split),
               "x_norms": (xn_k[i].double() - xn)[:, None].expand(n, m),
               "c_norms": (cn_k[i].double() - cn)[None].expand(n, m)}
        lin = torch.zeros(n, dtype=torch.float64, device=x.device)
        for name, dq in dqs.items():
            eff = -((k * dq) @ v64) / two_s2
            lin += eff
            parts[name] = max(parts[name], float((eff.abs() / terms).max()))
            dq_max[name] = max(dq_max[name], float(dq[near].abs().max()) if near.any() else 0.0)
        parts["linear_sum"] = max(parts["linear_sum"], float((lin.abs() / terms).max()))
        parts["total"] = max(parts["total"],
                             float(((out_k[i].double() - exact).abs() / terms).max()))
        del xc, xc_split, sq, k, dqs
    return {"rel_to_terms": parts, "max_abs_dq_where_K_over_1e-3": dq_max}


def capture_training(cands, seed, draws, report):
    """chip_smoke.py's harvest, then its training from the harvest's
    generator and from generators seeded 1 .. draws, each mining pass scored
    by the IEEE fp32 plain version with every candidate beside it."""
    import torch

    import chip_smoke as cs
    from online_detection_tpu_torch.models.detector import DetectorConfig, init_detector_params
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference
    from online_detection_tpu_torch.pipelines.device_pipeline import (
        harvest_dataset_device, train_online_modules_device)
    from online_detection_tpu_torch.pipelines.online_pipeline import OnlineTrainConfig
    from online_detection_tpu_torch.solvers import minibootstrap
    from online_detection_tpu_torch.utils.device import ieee_fp32

    params = init_detector_params(seed, cs.N_ANCHORS, cs.N_CLASSES + 1).cuda()
    cfg, dcfg = OnlineTrainConfig(), DetectorConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, _ = harvest_dataset_device(gen, params, cs.teaching_set(cs.TRAIN_IMAGES, seed), cfg,
                                      cs.CANVAS, dcfg=dcfg, batch_size=cs.BATCH_SIZE)
    first = gen.get_state()
    del params
    passes, norms = [], {}
    worst = {"err": -1.0}
    draw = {"i": 0}

    def shadowed(x, centers, v, sigma, set_idx=None):
        with ieee_fp32():
            plain = mmv_reference(x, centers, v, sigma, set_idx)
        exact = float64_scores(x, centers, v, sigma, set_idx)
        errs = {"fp32_plain": rel_to_terms(plain, *exact)}
        for name, fn in cands.items():
            errs[name] = rel_to_terms(fn(x, centers, v, sigma, set_idx), *exact)
        d = x.shape[-1]
        rec = norms.setdefault(d, {"x": [], "c": [], "cos_x": [], "cos_c": []})
        xn, cn = x.norm(dim=-1), centers.norm(dim=-1)
        rec["x"].append(xn.flatten().cpu())
        rec["c"].append(cn.flatten().cpu())
        if x.dim() == 3:  # the cosines of rows and centers to their set's mean center
            mu = centers.mean(1)
            mu = mu / mu.norm(dim=-1, keepdim=True).clamp(min=1e-30)
            rec["cos_x"].append(((x * mu[:, None]).sum(-1) / xn.clamp(min=1e-30))
                                [xn > 0].flatten().cpu())
            rec["cos_c"].append(((centers * mu[:, None]).sum(-1) / cn.clamp(min=1e-30))
                                [cn > 0].flatten().cpu())
        passes.append({"draw": draw["i"], "shape": list(x.shape), "m": centers.shape[1],
                       "errors": errs})
        if "replaced" in errs and errs["replaced"] > worst["err"] and x.dim() == 3:
            worst.update(err=errs["replaced"], x=x.clone(), c=centers.clone(), v=v.clone(),
                         sigma=sigma, draw=draw["i"], shape=list(x.shape))
        return plain

    kernel = minibootstrap.mmv_grouped
    minibootstrap.mmv_grouped = shadowed
    try:
        for i in range(draws + 1):
            draw["i"] = i
            g = torch.Generator(device="cuda")
            if i == 0:
                g.set_state(first)
            else:
                g.manual_seed(i)
            t0 = time.time()
            train_online_modules_device(g, [cs.clone_reservoirs(state)], cfg)
            torch.cuda.synchronize()
            mine = [p for p in passes if p["draw"] == i]
            print(f"  training draw {i} ({time.time() - t0:.1f} s, {len(mine)} mining passes): "
                  f"largest error / sum |terms| against float64 "
                  + ", ".join(f"{k} {max(p['errors'][k] for p in mine):.3g}"
                              for k in mine[0]["errors"]), flush=True)
    finally:
        minibootstrap.mmv_grouped = kernel
    heads = {1024: "rpn", 2048: "detector", 256: "mask"}
    report["norms"] = {heads.get(d, str(d)): {
        "rows": norm_stats(r["x"]), "centers": norm_stats(r["c"]),
        "rows_cosine_to_mean_center": quantiles(r["cos_x"]),
        "centers_cosine_to_mean_center": quantiles(r["cos_c"])}
        for d, r in norms.items()}
    for head, rec in report["norms"].items():
        print(f"  {head} mining rows' norms {rec['rows']}, centers' {rec['centers']}; "
              f"cosines to the set's mean center: rows "
              f"{rec['rows_cosine_to_mean_center']}, centers "
              f"{rec['centers_cosine_to_mean_center']}", flush=True)
    names = list(passes[0]["errors"])
    report["passes"] = passes
    report["summary"] = {
        k: {"max": max(p["errors"][k] for p in passes),
            "passes_over_1e-5": sum(p["errors"][k] > 1e-5 for p in passes),
            "by_draw": [max(p["errors"][k] for p in passes if p["draw"] == i)
                        for i in range(draws + 1)]}
        for k in names}
    for k, rec in report["summary"].items():
        print(f"  {k}: largest {rec['max']:.3g} over {len(passes)} passes, over 1e-5 in "
              f"{rec['passes_over_1e-5']}; by draw "
              f"{[float(f'{e:.3g}') for e in rec['by_draw']]}", flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=6)
    ap.add_argument("--no-training", action="store_true")
    ap.add_argument("--probe", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        return probe(args.probe)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("b1_variants: this probe needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from online_detection_tpu_torch.ops import _build

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.time()
    started = {n: _build._start_build(n) for n in ("stem_pool", "roi_align_fused2")}
    built = build_variants(_build)
    for n, s in started.items():
        if s is not None:
            _build._finish_build(n, s)
    report = {"card": card, "build_logs": {k: v[2] for k, v in built.items()}}
    for name, (_, _, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    print(f"built {len(built)} variants in {time.time() - t0:.1f} s", flush=True)
    report["probes"] = probe_all(built)
    good = {k for k, v in report["probes"].items() if v is not None}
    libs = {k: ctypes.CDLL(str(built[k][0])) for k in good}
    fns = {k: candidate_fn(_build, k, libs[k], built[k][1]) for k in good
           if k not in DIAGNOSTIC}
    if "replaced" in fns:
        fns["shift"] = shifted(fns["replaced"])  # lever (c) on the replaced kernel

    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    report["times_ms"] = {}
    for role, g, n, m, d, sigma, per_group, sets in SHAPES:
        x, c, v, set_idx = inputs(rng, g, n, m, d, sigma, per_group, sets, near=False)
        row = {name: timed(lambda: fn(x, c, v, sigma, set_idx)) for name, fn in fns.items()}
        row["bound"] = 2.0 * g * n * m * (d + 1) / PEAK_3XTF32_FLOPS * 1e3
        report["times_ms"][role] = row
        print(f"{role:16s} " + " | ".join(f"{k} {t:.3f}" for k, t in row.items()), flush=True)
        del x, c, v, set_idx
        torch.cuda.empty_cache()
    sums = {k: sum(r[k] for r in report["times_ms"].values()) for k in row}
    report["times_ms"]["six calls"] = sums
    print("six calls        " + " | ".join(f"{k} {t:.3f}" for k, t in sums.items()), flush=True)

    cands = {k: fns[k] for k in fns if k not in CUT + TIMED}
    if not args.no_training:
        print("the training's mining passes:", flush=True)
        worst = capture_training(cands, args.seed, args.draws, report)
        if all(k in libs for k in ("replaced", "replaced_norms", "replaced_cross")) and \
                "x" in worst:
            parts = decompose(libs, worst["x"], worst["c"], worst["v"], worst["sigma"])
            report["decomposition"] = dict(parts, draw=worst["draw"], shape=worst["shape"],
                                           replaced_error=worst["err"])
            print(f"  the replaced kernel's worst pass (draw {worst['draw']}, x "
                  f"{worst['shape']}, {worst['err']:.3g}): parts to first order, max over "
                  f"outputs / sum |terms| {json.dumps(parts['rel_to_terms'])}; largest error "
                  f"in the squared distance where K > 1e-3 "
                  f"{json.dumps(parts['max_abs_dq_where_K_over_1e-3'])}", flush=True)
        del worst
    torch.cuda.empty_cache()

    # chip_smoke.py's check, and beside it the same rows at other cosines to
    # the common direction
    from online_detection_tpu_torch.ops.gaussian_mmv import mmv_reference
    from online_detection_tpu_torch.utils.device import ieee_fp32

    def plain(*a):
        with ieee_fp32():
            return mmv_reference(*a)

    cands["fp32_plain"] = plain
    report["mining_rows_check"] = {}
    for cosine in sorted({cs.MINING_COSINE, 0.8, 0.9, 1.0}):
        row = {name: cs.mining_rows_error(cands[name], args.seed, cosine=cosine)
               for name in cands}
        report["mining_rows_check"][str(cosine)] = row
        print(f"  mining rows {cs.MINING_ROWS} at cosine {cosine}"
              f"{' (chip_smoke.py)' if cosine == cs.MINING_COSINE else ''}: error / sum "
              f"|terms| against float64 "
              + ", ".join(f"{k} {e:.3g} ({'passes' if e <= 1e-5 else 'FAILS'})"
                          for k, e in row.items()), flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "b1_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
