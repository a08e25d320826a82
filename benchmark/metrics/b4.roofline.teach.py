"""b4.roofline.teach (kernel B4, the harvest's RoIAlign): the bytes of a
round's calls (``flops.roi_bytes``: each canvas batch's C4 map read once,
its GT ++ proposal rows written once, in bf16) at the chip's bandwidth,
over the device time of the kernels named ``roi_align_fused2`` in the
traced round, in percent."""

from benchmark import flops, tracing


def read(run):
    t = run["trace"]
    if not t:
        return None
    sec, _ = tracing.kernel_s(t, "roi_align_fused2")
    if sec <= 0:
        return None
    mix = run["mix"]
    h, w = mix["canvas_hw"]
    n, b = mix["teach_images"], mix["batch"]
    rows = 20 + run["cfg"]["detector"]["post_nms_top_n"]
    least = -(-n // b) * flops.roi_bytes(b, h // 16, w // 16, rows) / flops.PEAK_BYTES
    return 100.0 * least * run["traced_units"] / sec
