"""``utils/flops.py`` and ``utils/telemetry.py::annotate`` of the port beside
the JAX package's: every ``*_flops`` function gives the JAX count on a grid
of shapes (exactly: both sum the same float64 terms in the same order),
``mfu`` divides by the H100's bf16 peak, and ``annotate`` puts a named range
in a CPU ``torch.profiler`` trace and lets an exception raised inside it
through."""

import inspect
import itertools

import pytest
import torch

from online_detection_tpu.utils import flops as jf
from online_detection_tpu_torch.utils import flops as pf
from online_detection_tpu_torch.utils.telemetry import annotate

torch.set_num_threads(2)

CANVASES = ((128, 192), (608, 800), (800, 1344))
ROIS = (1, 40, 300)

# the arguments of each function on the grid
GRID = {
    "conv_flops": [(cin, cout, k, h, w) for cin, cout, k in ((3, 64, 7), (1024, 1024, 3),
                                                              (256, 64, 1))
                   for h, w in ((1, 1), (38, 50))],
    "backbone_c4_flops": list(CANVASES),
    "rpn_conv_flops": [(h // 16, w // 16, a) for (h, w), a in itertools.product(CANVASES,
                                                                               (3, 15))],
    "rpn_online_head_flops": [(h // 16, w // 16, a, m, d) for (h, w), a, m, d in
                              itertools.product(CANVASES, (15,), (24, 1000), (64, 1024))],
    "roi_align_flops": [(h // 16, w // 16, r, c, p) for (h, w), r, c, p in
                        itertools.product(CANVASES, ROIS, (64, 1024), (7, 14))],
    "res5_flops": [(r,) for r in ROIS],
    "mask_deconv_flops": [(r,) for r in ROIS],
    "falkon_det_head_flops": [(r, c, m, d) for r, c, m, d in
                              itertools.product(ROIS, (3, 21), (16, 1000), (64, 2048))],
    "falkon_mask_head_flops": [(r, c, m, d) for r, c, m, d in
                               itertools.product(ROIS, (1, 21), (16, 500), (256,))],
    "harvest_image_flops": [(h, w, p, g, a) for (h, w), p, g, a in
                            itertools.product(CANVASES, (40, 300), (1, 8, 20), (15,))],
    "inference_image_flops": [(h, w, p, d, c, 15, rpn, masks) for (h, w), (p, d), c, rpn, masks
                              in itertools.product(CANVASES, ((40, 10), (300, 100)), (3, 21),
                                                   (True, False), (True, False))],
}


def _flops_functions(mod):
    return sorted(n for n, f in vars(mod).items()
                  if n.endswith("_flops") and not n.startswith("_") and inspect.isfunction(f))


def test_same_functions_and_defaults():
    assert _flops_functions(pf) == _flops_functions(jf) == sorted(GRID)
    for name in GRID:
        assert inspect.signature(getattr(pf, name)) == inspect.signature(getattr(jf, name)), name


@pytest.mark.parametrize("name", sorted(GRID))
def test_flops_equal_jax(name):
    port, ref = getattr(pf, name), getattr(jf, name)
    for args in GRID[name]:
        assert port(*args) == ref(*args), (name, args)
    # and at the defaults, with only the required arguments
    required = [p for p in inspect.signature(ref).parameters.values()
                if p.default is inspect.Parameter.empty]
    args = GRID[name][-1][:len(required)]
    assert port(*args) == ref(*args), (name, args)


def test_mfu_uses_the_h100_peaks():
    assert (pf.H100_PEAK_BF16_TFLOPS, pf.H100_PEAK_TF32_TFLOPS,
            pf.H100_PEAK_F32_TFLOPS) == (989.0, 495.0, 67.0)
    assert pf.mfu(989e12) == 1.0
    assert pf.mfu(49.45e12) == pytest.approx(0.05)
    assert pf.mfu(67e12, pf.H100_PEAK_F32_TFLOPS) == 1.0
    assert not any(n.startswith("V5E") for n in vars(pf))
    assert "v5e" not in pf.__doc__.lower()
    # the same FLOPs at the same rate read against the card's peak, not the v5e's
    rate = 100e12
    assert pf.mfu(rate) == pytest.approx(jf.mfu(rate) * jf.V5E_PEAK_BF16_TFLOPS / 989.0)


def test_annotate_names_a_range_in_a_cpu_trace():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("odtpu::probe_range"):
            (x @ x).sum()
    names = [e.name for e in prof.events()]
    assert "odtpu::probe_range" in names
    rng = next(e for e in prof.events() if e.name == "odtpu::probe_range")
    assert any(e.name == "aten::mm" and rng.time_range.start <= e.time_range.start
               and e.time_range.end <= rng.time_range.end for e in prof.events())


def test_annotate_lets_an_exception_through():
    ran = []
    with pytest.raises(KeyError, match="inside"):
        with annotate("odtpu::raises"):
            ran.append(1)
            raise KeyError("inside")
    assert ran == [1]
    # and the range closes: a later range in a trace is whole
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("odtpu::after"):
            torch.ones(3).sum()
    assert "odtpu::after" in [e.name for e in prof.events()]
