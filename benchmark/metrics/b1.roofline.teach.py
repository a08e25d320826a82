"""b1.roofline.teach (kernel B1, the minibootstrap's mining passes): the
least time of a round's B1 calls (``flops.b1_least_s``: the mmv at the
3xTF32 rate or by its bytes, and its operand split) over the device time of
the kernels named ``mmv_tf32x3`` and ``split_tf32`` in the traced round, in
percent."""

from benchmark import flops, tracing


def read(run):
    t = run["trace"]
    if not t:
        return None
    sec, launches = tracing.kernel_s(t, "mmv_tf32x3", "split_tf32")
    if sec <= 0:
        return None
    mix = run["mix"]
    calls, _ = flops.training_work(run["cfg"]["train"], mix["teach_images"], mix["batch"],
                                   run["pools"]["coxy"], run["pools"]["rpn_pos"])
    return 100.0 * flops.b1_least_s(calls) * run["traced_units"] / sec
