"""Canvas loading for the harvest and inference loops (counterpart of
``data/loader.py``).

``CanvasLoader.get(i)`` decodes, resizes and pads image i. Three modes, each
asked for by name; none falls back to another:

- ``prefetch=None``: on the calling thread;
- ``"threads"``: a pool of ``workers`` threads runs the same PIL path
  (``dataset.load_image`` + ``transforms.preprocess_image_u8``) for up to
  ``window`` items ahead of the furthest ``get``, so decoding overlaps the
  device's work (PIL releases the GIL in decode and resize). Its canvases
  are byte for byte the synchronous path's. It pays only where the host's
  cores are free: with OpenBLAS's default thread pool, which the harvest's
  mask projection wakes each image, its threads are starved and the
  JPEG-fed harvest runs slower than without them (``tools/prefetch_probe.py``);
  the CLIs ask for one OpenBLAS thread;
- ``"native"``: the native library's prefetcher (``utils/native_io.py``)
  over ``dataset.image_path(i)``. Its resize is not PIL's (up to 40 levels
  apart), and a file it cannot read raises.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

from online_detection_tpu_torch.data import transforms

PREFETCH_MODES = (None, "threads", "native")


class CanvasLoader:
    """``get(i) -> (uint8 canvas [ch, cw, 3], scale, (sw, sh))`` over a dataset
    that has ``load_image(i)`` (uint8 RGB), and ``image_path(i)`` for
    ``prefetch="native"``."""

    def __init__(self, dataset, canvas_hw: Tuple[int, int], min_size: int = 600,
                 max_size: int = 1333, prefetch: Optional[str] = None, workers: int = 4,
                 window: int = 16):
        if prefetch not in PREFETCH_MODES:
            raise ValueError(f"prefetch={prefetch!r}: use one of {PREFETCH_MODES}")
        self.dataset = dataset
        self.canvas_hw = canvas_hw
        self.min_size = min_size
        self.max_size = max_size
        self.prefetch = prefetch
        self.window = max(1, window)
        self._pool = None
        self._pending = {}  # item -> its future, for the threads mode
        self._next = 0  # the first item not yet submitted
        self._prefetcher = None
        if prefetch == "threads":
            self._pool = ThreadPoolExecutor(max(1, workers), thread_name_prefix="canvas")
        elif prefetch == "native":
            from online_detection_tpu_torch.utils import native_io

            paths = [dataset.image_path(i) for i in range(len(dataset))]
            self._prefetcher = native_io.Prefetcher(paths, canvas_hw, min_size, max_size,
                                                    n_threads=workers, window=self.window)

    @property
    def native(self) -> bool:
        """Whether the native prefetcher was asked for."""
        return self.prefetch == "native"

    def _load(self, index: int):
        return transforms.preprocess_image_u8(self.dataset.load_image(index), self.canvas_hw,
                                              self.min_size, self.max_size)

    def get(self, index: int):
        if self._prefetcher is not None:
            return self._prefetcher.get(index)
        if self._pool is None:
            return self._load(index)
        if not 0 <= index < len(self.dataset):
            raise IndexError(f"item {index} of {len(self.dataset)}")
        # keep ``window`` items submitted ahead of the furthest item asked for
        end = min(index + 1 + self.window, len(self.dataset))
        for i in range(max(self._next, index), end):
            self._pending[i] = self._pool.submit(self._load, i)
        self._next = max(self._next, end)
        future = self._pending.pop(index, None)
        if future is None:  # skipped by a jump ahead, or asked for again
            return self._load(index)
        return future.result()

    def close(self):
        if self._pool is not None:
            for f in self._pending.values():
                f.cancel()
            self._pool.shutdown(wait=True)
            self._pool = None
            self._pending = {}
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
