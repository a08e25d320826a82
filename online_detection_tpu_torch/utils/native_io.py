"""ctypes binding of the native IO library ``native/libodtpu_io.so``
(counterpart of ``utils/native_io.py``).

The library (``native/odtpu_io.cc``) decodes JPEG and PNG, resizes by the
min/max side, pads to a canvas, parses VOC XML, and runs a thread pool that
prepares canvases ahead of the consumer. The binding loads the committed
library and never builds it; where the loader cannot load it (the library or
one of its dependencies, ``libjpeg.so.62`` and ``libpng16.so.16``, missing),
every function raises ``OSError`` with the loader's message. A file the
library cannot read raises too: nothing here falls back to PIL, whose
resize differs from the library's by up to 40 levels a pixel.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                        "libodtpu_io.so"))
_lib = None
_error = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_intp = ctypes.POINTER(ctypes.c_int)
_floatp = ctypes.POINTER(ctypes.c_float)


def _load():
    """The loaded library; ``OSError`` with the loader's message when it
    cannot be loaded (tried once a process)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is None:
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as e:
            _error = f"native IO library {LIB_PATH} cannot be loaded: {e}"
        else:
            lib.odtpu_decode_image.argtypes = [ctypes.c_char_p, ctypes.POINTER(_u8p), _intp,
                                               _intp]
            lib.odtpu_prepare_canvas.argtypes = [
                ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _floatp, _intp, _intp]
            lib.odtpu_parse_voc_xml.argtypes = [
                ctypes.c_char_p, _intp, _intp, ctypes.POINTER(_floatp),
                ctypes.POINTER(_intp), ctypes.POINTER(ctypes.c_void_p), _intp]
            lib.odtpu_free.argtypes = [ctypes.c_void_p]
            lib.odtpu_prefetcher_create.restype = ctypes.c_void_p
            lib.odtpu_prefetcher_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.odtpu_prefetcher_get.argtypes = [ctypes.c_void_p, ctypes.c_int, _u8p, _floatp,
                                                 _intp, _intp]
            lib.odtpu_prefetcher_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
            return lib
    raise OSError(_error)


def available() -> bool:
    """Whether the library loads in this process."""
    try:
        _load()
    except OSError:
        return False
    return True


def _check(rc: int, what: str):
    if rc != 0:
        raise OSError(f"native IO: {what} failed (rc={rc})")


def decode_image(path: str) -> np.ndarray:
    """JPEG or PNG -> uint8 RGB [H, W, 3]."""
    lib = _load()
    data, w, h = _u8p(), ctypes.c_int(), ctypes.c_int()
    _check(lib.odtpu_decode_image(path.encode(), ctypes.byref(data), ctypes.byref(w),
                                  ctypes.byref(h)), f"decoding {path}")
    try:
        return np.ctypeslib.as_array(data, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.odtpu_free(ctypes.cast(data, ctypes.c_void_p))


def prepare_canvas(path: str, canvas_hw: Tuple[int, int], min_size: int = 600,
                   max_size: int = 1333):
    """Decode, resize by the min/max side and pad -> (uint8 canvas [ch, cw, 3],
    scale, (scaled_w, scaled_h))."""
    lib = _load()
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.uint8)
    scale, sw, sh = ctypes.c_float(), ctypes.c_int(), ctypes.c_int()
    _check(lib.odtpu_prepare_canvas(path.encode(), canvas.ctypes.data_as(_u8p), ch, cw,
                                    min_size, max_size, ctypes.byref(scale), ctypes.byref(sw),
                                    ctypes.byref(sh)), f"preparing {path}")
    return canvas, scale.value, (sw.value, sh.value)


def parse_voc_xml(path: str):
    """VOC XML -> (width, height, boxes [N, 4] f32, names, difficult [N] bool)."""
    lib = _load()
    w, h, n = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    boxes, diff, names = _floatp(), _intp(), ctypes.c_void_p()
    _check(lib.odtpu_parse_voc_xml(path.encode(), ctypes.byref(w), ctypes.byref(h),
                                   ctypes.byref(boxes), ctypes.byref(diff),
                                   ctypes.byref(names), ctypes.byref(n)), f"parsing {path}")
    try:
        nb = n.value
        bx = np.ctypeslib.as_array(boxes, shape=(nb, 4)).copy() if nb else \
            np.zeros((0, 4), np.float32)
        df = np.ctypeslib.as_array(diff, shape=(nb,)).astype(bool) if nb else \
            np.zeros(0, bool)
        name_list, offset = [], 0
        for _ in range(nb):  # NUL-separated
            s = ctypes.string_at(names.value + offset)
            name_list.append(s.decode())
            offset += len(s) + 1
    finally:
        for p in (ctypes.cast(boxes, ctypes.c_void_p), ctypes.cast(diff, ctypes.c_void_p),
                  names):
            lib.odtpu_free(p)
    return w.value, h.value, bx, name_list, df


class Prefetcher:
    """The library's thread pool: ``n_threads`` workers prepare the canvases
    of ``paths`` (``prepare_canvas``) up to ``window`` items ahead of the
    furthest ``get``. Each item can be read once."""

    def __init__(self, paths: List[str], canvas_hw: Tuple[int, int], min_size: int = 600,
                 max_size: int = 1333, n_threads: int = 4, window: int = 8):
        self._lib = _load()
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self.canvas_hw = canvas_hw
        self._read = set()
        self._handle = self._lib.odtpu_prefetcher_create(
            arr, len(self._paths), canvas_hw[0], canvas_hw[1], min_size, max_size, n_threads,
            window)

    def get(self, index: int):
        """Blocks until item ``index`` is ready -> (canvas, scale, (sw, sh))."""
        if self._handle is None:
            raise ValueError("the prefetcher is closed")
        if not 0 <= index < len(self._paths):
            raise IndexError(f"item {index} of {len(self._paths)}")
        if index in self._read:  # the library frees an item once it is read
            raise ValueError(f"prefetched item {index} was read already")
        ch, cw = self.canvas_hw
        canvas = np.zeros((ch, cw, 3), np.uint8)
        scale, sw, sh = ctypes.c_float(), ctypes.c_int(), ctypes.c_int()
        _check(self._lib.odtpu_prefetcher_get(self._handle, index, canvas.ctypes.data_as(_u8p),
                                              ctypes.byref(scale), ctypes.byref(sw),
                                              ctypes.byref(sh)),
               f"prefetching item {index} ({self._paths[index].decode()})")
        self._read.add(index)
        return canvas, scale.value, (sw.value, sh.value)

    def close(self):
        """Stops and joins the workers."""
        if self._handle is not None:
            self._lib.odtpu_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self.close()
