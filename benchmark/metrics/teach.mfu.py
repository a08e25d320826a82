"""teach.mfu (whole round): the least time of a teaching round at the
chip's published peaks, each part at the precision the configuration
states (``benchmark/flops.py``: the harvest's convolutions bf16, B1's
mining passes 3xTF32, the FALKON and RLS solves fp32), over the mean wall
time of the rounds outside the traced one, in percent."""

from benchmark import flops


def read(run):
    recs = run["records"][run["traced_units"]:]
    if not recs:
        return None
    cfg, mix = run["cfg"]["train"], run["mix"]
    h, w = mix["canvas_hw"]
    n, b = mix["teach_images"], mix["batch"]
    calls, fp32 = flops.training_work(cfg, n, b, run["pools"]["coxy"], run["pools"]["rpn_pos"])
    bf16 = n * flops.harvest_image_bf16(h, w, run["cfg"]["detector"]["post_nms_top_n"],
                                        with_mask=cfg["with_segmentation"])
    least = flops.least_time(bf16, calls, fp32)
    wall = sum(r["round_s"] for r in recs) / len(recs)
    return 100.0 * least / wall
