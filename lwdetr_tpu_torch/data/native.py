"""ctypes binding of the port's host preprocessing library (`csrc/preproc.cpp`).

Counterpart of `lwdetr_tpu/data/native.py`. The eval loader's fused path
decodes a JPEG with Pillow's libjpeg into RGB8 pixels, then one C call
resizes them to a square (PIL's antialiased bilinear filter, float32 taps)
and normalizes them to float32. The JAX package decodes with the system's
libjpeg inside its library instead; both are libjpeg's integer IDCT and give
the same pixels, and a card's machine need not have libjpeg's headers.

The library is built with g++ at first use into `build/lwdetr_tpu_torch/`
at the root of the checkout, under a name that carries a hash of the source
and the flags (the conventions of `ops/_build.py`). A build that fails
raises: nothing switches to PIL's resize but the caller's `use_native=False`.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
from PIL import Image

from lwdetr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from lwdetr_tpu_torch.ops._build import BUILD_DIR, CSRC, build_host, host_library_path

SOURCE = "preproc.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
# the JPEG color spaces libjpeg converts to RGB (PIL modes "L" and "RGB");
# CMYK / YCCK are refused, as the JAX package's decoder refuses them
_DECODED_MODES = ("L", "RGB")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return host_library_path(SOURCE, CXX_FLAGS, CSRC, BUILD_DIR)


def build() -> Path:
    """Compile the library if it is missing; raises if g++ fails."""
    return build_host(SOURCE, CXX_FLAGS, CSRC, BUILD_DIR)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.resize_normalize.restype = None
            lib.resize_normalize.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float)]
            _lib = lib
        return _lib


def available() -> bool:
    """Builds and loads the library: True, or a failed build raises."""
    _load()
    return True


def decode_jpeg(path: str) -> Optional[np.ndarray]:
    """A JPEG file -> (H, W, 3) uint8 RGB, or None for a JPEG whose color
    space libjpeg does not convert to RGB (CMYK, YCCK)."""
    with Image.open(path) as im:
        if im.format != "JPEG" or im.mode not in _DECODED_MODES:
            return None
        return np.asarray(im.convert("RGB"))


def resize_normalize(rgb: np.ndarray, size: int, mean: np.ndarray = IMAGENET_MEAN,
                     std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) float32, resized and normalized."""
    lib = _load()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    out = np.empty((size, size, 3), np.float32)
    m = np.ascontiguousarray(mean, np.float32)
    s = np.ascontiguousarray(std, np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_normalize(rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rgb.shape[0],
                         rgb.shape[1], size, out.ctypes.data_as(f32p), m.ctypes.data_as(f32p),
                         s.ctypes.data_as(f32p))
    return out


def load_image_fast(path: str, size: int) -> Optional[Tuple[np.ndarray, int, int]]:
    """The fused path of square-resize eval preprocessing: (normalized float32
    (size, size, 3), original h, original w), or None for a file that is not
    a JPEG libjpeg decodes to RGB (the caller takes PIL's path for it)."""
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    rgb = decode_jpeg(path)
    if rgb is None:
        return None
    return resize_normalize(rgb, size), rgb.shape[0], rgb.shape[1]
