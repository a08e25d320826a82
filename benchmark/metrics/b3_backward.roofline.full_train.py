"""b3_backward.roofline.full_train (kernel B3', the RoIAlign backward): the
bytes of each call (``flops_train.b3_backward_bytes``: the [R, 14, 14,
1024] fp32 gradient and the boxes read, the C4 map's gradient written) at
the chip's bandwidth, over the device time of the kernels named
``roi_align_backward`` in the traced round, in percent."""

from benchmark import flops, flops_train, tracing


def read(run):
    t = run["trace"]
    if not t:
        return None
    sec, launches = tracing.kernel_s(t, "roi_align_backward")
    if sec <= 0:
        return None
    h, w = run["mix"]["canvas_hw"]
    per = flops_train.b3_backward_bytes(run["cfg"]["sgd"]["roi_batch"], h // 16, w // 16)
    return 100.0 * launches * per / flops.PEAK_BYTES / sec
