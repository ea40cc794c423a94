"""ctypes binding of the port's zstd decoder and CRC-32C (`csrc/zstd_decode.cpp`).

The orbax reader (`train/orbax_read.py`) decodes with it: the OCDBT manifests
and b-tree nodes (zstd bodies, CRC-32C trailers) and the zarr chunks (zstd
frames). The library is built with g++ at first use into
`build/lwdetr_tpu_torch/`, under a name that carries a hash of the source and
the flags (`ops/_build.py::build_host`). A failed build raises; a malformed
frame raises `ZstdError` with the decoder's reason.

Inputs are any buffer (bytes, memoryview, a numpy view of a mapped file): the
decoder reads them in place.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from lwdetr_tpu_torch.ops._build import build_host

SOURCE = "zstd_decode.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_u8p = ctypes.POINTER(ctypes.c_uint8)


class ZstdError(ValueError):
    """A zstd input the decoder refuses."""


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_host(SOURCE, CXX_FLAGS)))
            lib.zstd_decode_into.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                             ctypes.c_size_t]
            lib.zstd_decode_into.restype = ctypes.c_int64
            lib.zstd_decode_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
                                              ctypes.POINTER(_u8p)]
            lib.zstd_decode_alloc.restype = ctypes.c_int64
            lib.zstd_free.argtypes = [_u8p]
            lib.zstd_free.restype = None
            lib.zstd_error_name.argtypes = [ctypes.c_int64]
            lib.zstd_error_name.restype = ctypes.c_char_p
            lib.crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
            lib.crc32c.restype = ctypes.c_uint32
            lib.xxh64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
            lib.xxh64.restype = ctypes.c_uint64
            _lib = lib
        return _lib


def _view(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def _check(lib, code: int, what: str) -> int:
    if code < 0:
        raise ZstdError(f"{what}: {lib.zstd_error_name(code).decode()}")
    return code


def decompress_into(data, out: np.ndarray, what: str = "zstd input") -> np.ndarray:
    """Decodes the frames of `data` into the C-contiguous array `out`, which
    they must fill exactly; returns `out`."""
    lib = _load()
    src = _view(data)
    if not out.flags.c_contiguous:
        raise ValueError("decompress_into needs a C-contiguous output")
    n = _check(lib, lib.zstd_decode_into(src.ctypes.data, src.size, out.ctypes.data, out.nbytes),
               what)
    if n != out.nbytes:
        raise ZstdError(f"{what}: decodes to {n} bytes, expected {out.nbytes}")
    return out


def decompress(data, limit: int, what: str = "zstd input") -> bytes:
    """The frames of `data` decoded, their size unknown beforehand but at most
    `limit` bytes."""
    lib = _load()
    src = _view(data)
    buf = _u8p()
    n = lib.zstd_decode_alloc(src.ctypes.data, src.size, limit, ctypes.byref(buf))
    try:
        _check(lib, n, what)
        return ctypes.string_at(buf, n)
    finally:
        lib.zstd_free(buf)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a buffer."""
    src = _view(data)
    return int(_load().crc32c(src.ctypes.data, src.size))


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of a buffer (the hash of the frames' content checksum)."""
    src = _view(data)
    return int(_load().xxh64(src.ctypes.data, src.size, seed))
