"""Random full-width R-50-C4 weights, made on the device from the seed.

One ``torch.randn`` call on a generator of the run's device draws every
weight at once; each tensor is a view of it scaled to He's standard
deviation. The frozen BN affines are identity except each ``branch2c``
scale, 0.1, and the stem weight is divided by 64 (inputs are 0-255 with no
std division), so that activations stay near unit scale without trained
statistics. The same tensors feed the program (``to_program``) and the
reference (the plain dict).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

R50_STAGES = (3, 4, 6, 3)
STAGE_CHANNELS = ((64, 256), (128, 512), (256, 1024), (512, 2048))


def _layout(num_anchors: int, num_classes: int, stages, channels) -> List[Tuple[str, tuple, float]]:
    """(key, shape, std) of every drawn tensor, in drawing order."""
    out = [("stem", (64, 3, 7, 7), (2.0 / (49 * 3)) ** 0.5 / 64.0)]
    cin = 64
    for si, (n, (mid, cout)) in enumerate(zip(stages, channels)):
        for bi in range(n):
            key = f"res{si + 2}.{bi}"
            out.append((key + ".a", (mid, cin, 1, 1), (2.0 / cin) ** 0.5))
            out.append((key + ".b", (mid, mid, 3, 3), (2.0 / (9 * mid)) ** 0.5))
            out.append((key + ".c", (cout, mid, 1, 1), (2.0 / mid) ** 0.5))
            if bi == 0:
                out.append((key + ".branch1", (cout, cin, 1, 1), (2.0 / cin) ** 0.5))
            cin = cout
    c4, c5 = channels[2][1], channels[3][1]
    out += [("rpn.conv_w", (c4, c4, 3, 3), 0.01), ("rpn.cls_w", (c4, num_anchors), 0.01),
            ("rpn.bbox_w", (c4, 4 * num_anchors), 0.01),
            ("mask.w", (c5, 256, 2, 2), (2.0 / (4 * c5)) ** 0.5),
            ("mask.logits_w", (256, num_classes + 1), 0.01)]
    return out


def make_weights(seed: int, device, num_anchors: int = 15, num_classes: int = 21,
                 stages=R50_STAGES, channels=STAGE_CHANNELS) -> Dict:
    """The plain weight dict (``reference/forward.py``'s layout) from the seed."""
    layout = _layout(num_anchors, num_classes, stages, channels)
    total = sum(torch.Size(s).numel() for _, s, _ in layout)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    drawn, lo = {}, 0
    for key, shape, std in layout:
        n = torch.Size(shape).numel()
        drawn[key] = flat[lo:lo + n].view(shape).mul_(std)
        lo += n

    def bn(key, cout, scale=1.0):
        return {"w": drawn[key], "scale": torch.full((cout,), scale, device=device),
                "bias": torch.zeros(cout, device=device)}

    w = {"stem": bn("stem", 64)}
    for si, (n, (mid, cout)) in enumerate(zip(stages, channels)):
        blocks = []
        for bi in range(n):
            key = f"res{si + 2}.{bi}"
            blocks.append({"a": bn(key + ".a", mid), "b": bn(key + ".b", mid),
                           "c": bn(key + ".c", cout, 0.1),
                           "branch1": bn(key + ".branch1", cout) if bi == 0 else None,
                           "stride": 2 if (bi == 0 and si > 0) else 1})
        w[f"res{si + 2}"] = blocks
    c4 = channels[2][1]
    w["rpn"] = {"conv_w": drawn["rpn.conv_w"], "conv_b": torch.zeros(c4, device=device),
                "cls_w": drawn["rpn.cls_w"], "cls_b": torch.zeros(num_anchors, device=device),
                "bbox_w": drawn["rpn.bbox_w"],
                "bbox_b": torch.zeros(4 * num_anchors, device=device)}
    w["mask"] = {"w": drawn["mask.w"], "b": torch.zeros(256, device=device),
                 "logits_w": drawn["mask.logits_w"],
                 "logits_b": torch.zeros(num_classes + 1, device=device)}
    return w


def to_program(w: Dict):
    """The same tensors as the program's ``DetectorParams``."""
    from online_detection_tpu_torch.models import resnet
    from online_detection_tpu_torch.models.detector import DetectorParams
    from online_detection_tpu_torch.models.heads import MaskHead
    from online_detection_tpu_torch.models.rpn import RPNHead

    def cbn(p):
        return resnet.ConvBN(p["w"], p["scale"], p["bias"])

    def stage(blocks):
        return [resnet.Bottleneck(cbn(b["a"]), cbn(b["b"]), cbn(b["c"]),
                                  None if b["branch1"] is None else cbn(b["branch1"]),
                                  stride=b["stride"]) for b in blocks]

    backbone = resnet.ResNetC4(cbn(w["stem"]), stage(w["res2"]), stage(w["res3"]),
                               stage(w["res4"]), stage(w["res5"]))
    r = w["rpn"]
    rpn = RPNHead(r["conv_w"], r["conv_b"], r["cls_w"], r["cls_b"], r["bbox_w"], r["bbox_b"])
    m = w["mask"]
    return DetectorParams(backbone, rpn, MaskHead(m["w"], m["b"], m["logits_w"], m["logits_b"]))
