"""Canvas loading for the harvest and inference loops (counterpart of
``data/loader.py``).

The synchronous path only: each ``get`` decodes, resizes and pads one image
on the calling thread. The JAX package's native threaded prefetcher
(``utils/native_io.py``) has no binding in the port yet, so ``native`` is
always False.
"""

from __future__ import annotations

from typing import Tuple

from online_detection_tpu_torch.data import transforms


class CanvasLoader:
    """``get(i) -> (uint8 canvas [ch, cw, 3], scale, (sw, sh))`` over a dataset
    that has ``load_image(i)`` (uint8 RGB)."""

    def __init__(self, dataset, canvas_hw: Tuple[int, int], min_size: int = 600,
                 max_size: int = 1333):
        self.dataset = dataset
        self.canvas_hw = canvas_hw
        self.min_size = min_size
        self.max_size = max_size

    @property
    def native(self) -> bool:
        return False

    def get(self, index: int):
        return transforms.preprocess_image_u8(self.dataset.load_image(index), self.canvas_hw,
                                              self.min_size, self.max_size)

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
