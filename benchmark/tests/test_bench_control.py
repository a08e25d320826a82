"""The control, run on the card at each cell's own size: the plain
reference one precision step below the configured one, in the program's
place, fails at least one of the cell's numbers on three seeds."""

import math

import pytest
import torch

from benchmark.harness import limits_of

SEEDS = (3100000401, 3100000402, 3100000403)


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["ycbv.teach", "icwt30.teach"])
def test_control_fails_the_limits(spec, workload):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    from benchmark.control import readings

    limits = limits_of(workload)
    for seed in SEEDS:
        r = readings(spec, workload, seed, "control", "cuda")
        assert any(not math.isfinite(r[k]) or r[k] > limits[k] for k in limits), (seed, r)
