"""What the f32 attention backwards' 3xTF32 products cost against one TF32
product, and what one product would do to their result, on one CUDA card.

    python -m lwdetr_tpu_torch.bench_tf32

K6 and K7 run their f32 products as 3xTF32 (`csrc/attention_bwd.cuh`:
a_lo b_hi + a_hi b_lo + a_hi b_hi). This tool builds a variant of their two
sources whose `mma_3xtf32` keeps only a_hi b_hi, one TF32 product, into the
build directory, and at the f32 backward shapes of the train steps times both
(device ms of one launch, calls replayed from a CUDA graph) and holds each
against the plain backward in f64 with the f32 tolerance of `chip_smoke.py`,
2e-5 x max(1, max |plain|). The variant is a yardstick: the port never loads
it. Prints one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess

import torch

from lwdetr_tpu_torch.ops import _build
from lwdetr_tpu_torch.ops import flash_attention as fa
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_graph_ms

THREE = """  mma_tf32(c, a.lo, b.hi0, b.hi1);
  mma_tf32(c, a.hi, b.lo0, b.lo1);
  mma_tf32(c, a.hi, b.hi0, b.hi1);"""
ONE = "  mma_tf32(c, a.hi, b.hi0, b.hi1);"
F32_ATOL = 2e-5
# (name, kernel, B, C, N, heads, scale, bias): small's, medium's and tiny's
# train shapes at batch 4, and K6 at head_dim 64
SHAPES = (("K6 small ViT", "K6", 4, 192, 1600, 12, 1.0, False),
          ("K6 decoder", "K6", 52, 256, 300, 8, 32 ** -0.5, False),
          ("K6 medium ViT", "K6", 4, 384, 1600, 12, 1.0, False),
          ("K6 xlarge ViT", "K6", 8, 768, 1600, 12, 1.0, False),
          ("K7 small", "K7", 64, 192, 100, 12, 1.0, True),
          ("K7 medium", "K7", 64, 384, 100, 12, 1.0, True),
          ("K7nb tiny decoder", "K7nb", 52, 256, 100, 8, 32 ** -0.5, False))


def build_one_product() -> dict:
    """The two backward sources with one TF32 product a 3xTF32 one, built and
    loaded: {kernel name: C function}."""
    src_dir = _build.BUILD_DIR / "tf32x1"
    if src_dir.exists():
        shutil.rmtree(src_dir)
    src_dir.mkdir(parents=True)
    for name in _build.HEADERS + ("flash_attention_bwd.cu", "window_attention_bwd.cu"):
        shutil.copy(_build.CSRC / name, src_dir / name)
    header = src_dir / "attention_bwd.cuh"
    text = header.read_text()
    if text.count(THREE) != 1:
        raise RuntimeError("mma_3xtf32 no longer has the three products this tool replaces")
    header.write_text(text.replace(THREE, ONE))
    libs = {}
    procs = {src: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(src_dir), "-o",
         str(src_dir / (src + ".so")), str(src_dir / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in ("flash_attention_bwd.cu",
                                                         "window_attention_bwd.cu")}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the one-product {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(src_dir / (src + ".so")))
    fns = {}
    for kernel in (fa.flash_attention_cm_bwd_kernel, fa.window_attention_bias_bwd_kernel,
                   fa.window_attention_bwd_kernel):
        fn = getattr(libs[kernel.source], kernel.symbol)
        fn.argtypes = kernel.argtypes + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[kernel.name] = fn
    return fns


def run() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_tf32 measures the CUDA card and there is none")
    torch.backends.cuda.matmul.allow_tf32 = False
    one = build_one_product()
    rows = []
    for label, name, B, C, N, heads, scale, with_bias in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(N + C)
        qkv = 0.5 * torch.randn((B, 3 * C, N), generator=g, device="cuda")
        dout = torch.randn((B, C, N), generator=g, device="cuda")
        bias = 0.1 * torch.randn((3 * C,), generator=g, device="cuda") if with_bias else None
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        with torch.no_grad():
            if name == "K6":
                _, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
                delta = torch.empty_like(lse)
                three = lambda: fa.flash_attention_cm_bwd(qkv, lse, dout, heads, scale)  # noqa: E731

                def single(out):
                    return one["K6"](qkv.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                                     out.data_ptr(), delta.data_ptr(), B, C, N, heads, scale, 0,
                                     stream())
            else:
                three = lambda: fa.window_attention_bias_bwd(qkv, bias, dout, heads, scale)  # noqa: E731

                def single(out):
                    head = [qkv.data_ptr()] + ([] if bias is None else [bias.data_ptr()])
                    return one[name](*head, dout.data_ptr(), out.data_ptr(), B, C, N, heads,
                                     scale, 0, stream())
            out1 = torch.empty_like(qkv)

            def one_product():
                err = single(out1)
                if err != 0:
                    raise RuntimeError(f"{label}: one-product launch failed: CUDA error {err}")
                return out1

            ref = fa.attention_cm_bwd_plain(qkv.double(), dout.double(), heads, scale,
                                            bias=None if bias is None else bias.double())
            tol = F32_ATOL * max(1.0, ref.abs().max().item())
            errs = {k: (f().double() - ref).abs().max().item()
                    for k, f in (("3xtf32", three), ("1xtf32", one_product))}
            ms = {k: measure_graph_ms(f, iters=20)["ms"]
                  for k, f in (("3xtf32", three), ("1xtf32", one_product))}
        rows.append({"shape": label, "qkv": [B, 3 * C, N], "heads": heads,
                     "device_ms_3xtf32": ms["3xtf32"], "device_ms_1xtf32": ms["1xtf32"],
                     "max_abs_err_3xtf32": errs["3xtf32"], "max_abs_err_1xtf32": errs["1xtf32"],
                     "f32_tolerance": tol})
    return {"card": card_line(), "device": torch.cuda.get_device_name(0), "rows": rows}


if __name__ == "__main__":
    print(json.dumps(run()))
