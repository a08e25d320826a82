"""full_train.mfu (SGD step): a step's least time at the chip's IEEE fp32
peak (``benchmark/flops_train.py``: forward, input and weight gradient of
every trainable convolution and product, no input gradient for the stem),
over the mean wall time of a step in the rounds outside the traced one, in
percent."""

from benchmark import flops, flops_train


def read(run):
    recs = run["records"][run["traced_units"]:]
    steps = sum(r["steps"] for r in recs)
    if not steps:
        return None
    h, w = run["mix"]["canvas_hw"]
    cfg = run["cfg"]
    least = flops_train.step_flops(h, w, cfg["sgd"]["roi_batch"], cfg["num_classes"]) \
        / flops.PEAK_FP32
    return 100.0 * least / (sum(r["round_s"] for r in recs) / steps)
