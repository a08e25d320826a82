"""The plain reference at a tiny size, on the CPU: it computes what the
program computes (the program's plain kernel versions and bf16 trunk here),
and its control departs from it."""

import numpy as np
import pytest
import torch

from benchmark import judge
from benchmark.drivers import derive
from benchmark.harness import cell_spec, kind_of
from benchmark.reference import forward as ref
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import tiny

teach = kind_of("teach")


def _setup(spec, workload, seed=11):
    _, cfg, mix = cell_spec(spec, workload)
    for k, v in tiny(spec, workload).items():
        (cfg if k in cfg else mix)[k] = v
    return teach.Setup(cfg, mix, seed, "cpu")


def test_training_matches_the_program(spec):
    s = _setup(spec, "ycbv.teach")
    state, online, _ = s.round(0, keep_state=True)
    pools = ref_train.pools_of(state)
    refm = judge.reference_models(pools, s.cfg["train"], derive(s.seed, "train", 0), "cpu")
    gaps = judge.models_gap(ref.models_of(online), refm,
                            judge.probes(pools, s.cfg["train"], np.random.default_rng(0), 8))
    assert gaps["head_gap_max"] < 1e-4 and gaps["rls_gap"] < 1e-3


def test_negative_pools_where_the_reference_puts_them(spec):
    """Every class's pool holds the number of rows the reference works out
    from the boxes, and each row lies at rounding from the reference's
    feature of a row its class may take from its image."""
    s = _setup(spec, "ycbv.teach")
    with teach.HarvestCapture() as cap:
        state, _, _ = s.round(0, keep_state=True)
    layout = judge.neg_layout(cap.batches, len(s.teach), s.cfg["train"])
    assert judge.neg_count_off(layout, state.det_neg.counts) == 0
    assert int(layout["count"].sum()) > 0
    answers = judge.pool_answers(layout, list(range(len(cap.batches))), state.det_neg.rows)
    gap = judge.neg_gap(s.w, s.teach, layout, cap.batches, answers, s.mix, "cpu")
    assert answers and gap < 5e-3


def test_control_departs_from_the_reference(spec):
    s = _setup(spec, "ycbv.teach")
    imgs = torch.from_numpy(np.stack([s.teach.load_image(i) for i in range(2)]))
    gb = torch.zeros(2, 20, 4)
    for i in range(2):
        gb[i, 0] = torch.from_numpy(s.teach.get_annotation(i).boxes[0])
    want = ref.gt_features(s.w, imgs, gb)[:, 0]
    low = ref.gt_features(s.w, imgs, gb, ref.CONTROL)[:, 0]
    rel = float(((low - want).norm(dim=-1) / want.norm(dim=-1)).max())
    assert rel > 1e-2


@pytest.mark.parametrize("kind", ["fp8", "tf32"])
def test_precision_knobs(kind):
    prec = ref.Precision("fp8" if kind == "fp8" else "bf16", "tf32" if kind == "tf32" else "ieee")
    with ref.fp32_mode(prec):
        assert torch.backends.cuda.matmul.allow_tf32 is (kind == "tf32")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    x = torch.linspace(-3, 3, 101)
    y = ref._fp8(x).float()
    assert float((y - x).abs().max()) > 1e-3 and float((y - x).abs().max()) < 0.2
