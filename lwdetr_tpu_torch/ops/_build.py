"""Build the port's CUDA kernels from `lwdetr_tpu_torch/csrc/` and bind them.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library with
a plain C interface for `sm_90a` (Hopper), at first use, into
`build/lwdetr_tpu_torch/` at the root of the checkout. The file name carries
a hash of the sources and flags, so an edited kernel is never served from a
stale build. Missing libraries are compiled in parallel (one `nvcc` per
source). Nothing here runs at import time.

A `CudaKernel` is one C entry point. Calling it launches the kernel on the
current stream, raises if the launch was refused (the C function returns
`cudaGetLastError()`), and counts the launch in `launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lwdetr_tpu_torch"
SOURCES = ("window_attention.cu", "flash_attention.cu", "deform_attn.cu",
           "deform_attn_sep.cu", "deform_attn_sep_bwd.cu", "flash_attention_bwd.cu",
           "window_attention_bwd.cu", "deform_attn_bwd.cu", "matcher.cu")
HEADERS = ("attention_bwd.cuh", "attention_wide.cuh", "common.cuh", "deform_cm.cuh",
           "deform_layout.cuh", "mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the host libraries, each built with g++ by its own binding
# (`data/native.py`, `utils/zstd.py`) through `build_host`
HOST_SOURCES = ("preproc.cpp", "zstd_decode.cpp")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(source: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / source)]


def build(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, all at once.

    Returns {source: compiler log} for the sources compiled by this call
    (the `-Xptxas -v` register / shared-memory report is in the log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def host_library_path(source: str, flags: Sequence[str], csrc: Path = CSRC,
                      build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update((csrc / source).read_bytes())
    return build_dir / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_host(source: str, flags: Sequence[str], csrc: Path = CSRC,
               build_dir: Path = BUILD_DIR) -> Path:
    """Compile a host C++ library with g++ if it is missing; raises if g++ fails."""
    out = host_library_path(source, flags, csrc, build_dir)
    if not out.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(csrc / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def load(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build([source])
        lib = ctypes.CDLL(str(path))
        lib.lw_error_string.argtypes = [ctypes.c_int]
        lib.lw_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib


class CudaKernel:
    """One kernel's C entry point: `int symbol(args..., cudaStream_t)`."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            msg = load(self.source).lw_error_string(err).decode()
            raise RuntimeError(f"{self.name} ({self.symbol}) launch failed: CUDA error {err}: {msg}")
        self.launches += 1
