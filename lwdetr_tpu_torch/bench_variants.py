"""Source variants of the panel / row-major sampler forwards (K4, K10) against
the tree's kernel and another checkout's, in turns, on one CUDA card.

    python -m lwdetr_tpu_torch.bench_variants --other build/parent
    python -m lwdetr_tpu_torch.bench_variants --variants tree one_map_a_cta --no-steps

A variant is `csrc/deform_attn_sep.cu` with the text edits of `VARIANTS`
applied (each must match the source once), built by nvcc with the tree's
headers into `build/variants/<name>/`; "tree" is the source as it is, and
"parent" the source of `--other` with its own headers. Every variant is held
to the plain version (chip_smoke.py's tolerance: 2e-5; in bf16 + 2^-7
|plain| of the plain version on the same bf16 values, which rounds as the
kernel) and timed (device ms of one launch, `measure_graph_ms` over 50
launches) at each shape of `SHAPES` (seeded inputs; "clustered": a query's
points near one reference point, as a decoder's are) and, unless
`--no-steps`, at the K4 / K10 calls of large's bf16 eval step at batch 32
and small's f32 train step at batch 4 (`bench_deform.recorded_calls`), the
variants in the order given, then reversed. Prints one JSON line: per shape
and variant the two times, the error and the route, each build's
`-Xptxas -v` spill lines, and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from lwdetr_tpu_torch.ops import _build
from lwdetr_tpu_torch.ops import deform_attn as da
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_graph_ms

SOURCE = "deform_attn_sep.cu"
OUT = _build.BUILD_DIR.parent / "variants"

_ONE_HEAD = ["  while (r.tile.heads < H &&", "  while (false && r.tile.heads < H &&"]
# name -> text edits of the tree's SOURCE: [old, new], each old found once
VARIANTS = {
    "tree": [],
    # the work order: one (b, h) map a CTA at every shape, or all heads (a power of two) of a few queries
    "one_map_a_cta": [_ONE_HEAD],
    "all_heads_a_cta": [["r.tile.heads * KP * static_cast<int>(sizeof(float)) < 32 &&", "true &&"]],
    # points in flight: 2 in f32 too (bf16 has a kernel of its own)
    "f32_2_points": [["r.group = dtype != lw::kFloat32 ? 1 : KP % 4 == 0 ? 4 : 2;",
                      "r.group = dtype != lw::kFloat32 ? 1 : 2;"]],
    # threads a CTA
    "threads_128": [["constexpr int kThreads = 256;", "constexpr int kThreads = 128;"]],
    "threads_512": [["constexpr int kThreads = 256;", "constexpr int kThreads = 512;"]],
    # registers: a minimum of one CTA an SM lets ptxas take as many as it likes
    "min_one_cta_an_sm": [["__launch_bounds__(kThreads)\ndeform_attn_sep_kernel(",
                           "__launch_bounds__(kThreads, 1)\ndeform_attn_sep_kernel("]],
    # one map a CTA, 4 CTAs a map walking its query tiles, so that the map stays in L1
    "map_in_l1": [
        _ONE_HEAD,
        ["  int query_tiles;  // ceil(Q / queries)\n};",
         "  int query_tiles;  // ceil(Q / queries)\n  int ctas;\n};"],
        ["  const int qt = blk % tile.query_tiles;\n  blk /= tile.query_tiles;",
         "  const int first = blk % tile.ctas;\n  blk /= tile.ctas;"],
        ["  const int q0 = qt * tile.queries;\n  const int xs = Layout::x_stride(H, D);"
         "  // elements between neighbouring positions\n",
         "  const int xs = Layout::x_stride(H, D);\n"
         "  for (int qt = first; qt < tile.query_tiles; qt += tile.ctas) {\n"
         "  const int q0 = qt * tile.queries;\n  __syncthreads();\n"],
        ["  if (s >= S || q >= Q || h >= H) return;", "  if (s >= S || q >= Q || h >= H) continue;"],
        ["  store(out + (static_cast<size_t>(b * Q + q) * H + h) * D + c, acc);\n}",
         "  store(out + (static_cast<size_t>(b * Q + q) * H + h) * D + c, acc);\n  }\n}"],
        ["  r.ctas = static_cast<long long>(B) * r.tile.head_groups * r.tile.query_tiles;",
         "  r.tile.ctas = std::min(4, r.tile.query_tiles);\n"
         "  r.ctas = static_cast<long long>(B) * r.tile.head_groups * r.tile.ctas;"]],
}
# (name, layout, B, heads, head_dim, points, queries, levels, clustered)
SHAPES = (
    ("large eval b8", "panels", 8, 24, 16, 4, 300, [(80, 80), (20, 20)], False),
    ("large eval b8 clustered", "panels", 8, 24, 16, 4, 300, [(80, 80), (20, 20)], True),
    ("large eval b32 clustered", "panels", 32, 24, 16, 4, 300, [(80, 80), (20, 20)], True),
    ("small train", "panels", 4, 16, 16, 2, 3900, [(40, 40)], False),
    ("tiny train", "panels", 4, 16, 16, 2, 1300, [(40, 40)], False),
    ("tiny train", "rowmajor", 4, 16, 16, 2, 1300, [(40, 40)], False),
    ("tiny eval", "rowmajor", 8, 16, 16, 2, 100, [(40, 40)], False),
)
# (preset, train batch, eval batch): the steps whose K4 / K10 calls are timed
STEPS = (("large", 0, 32), ("small", 4, 0))
ATOL = 2e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
_CODE = {torch.float32: 0, torch.bfloat16: 1}


def variant_source(text: str, edits) -> str:
    """SOURCE's text with `edits` applied; raises unless each old text is found once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit does not match the source once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(names, other):
    """{name: loaded library} of each variant (nvcc in parallel), and each build's spill lines."""
    procs = {}
    for name in names:
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        if name == "parent":
            shutil.copytree(Path(other) / "lwdetr_tpu_torch" / "csrc", d)
        else:
            shutil.copytree(_build.CSRC, d)
            (d / SOURCE).write_text(variant_source((d / SOURCE).read_text(), VARIANTS[name]))
        so = d / "lib.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(so), str(d / SOURCE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs, spills = {}, {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        spills[name] = [line.strip() for line in log.splitlines()
                        if "spill" in line and "0 bytes spill" not in line]
        lib = ctypes.CDLL(str(so))
        lib.lw_deform_attn_sep.argtypes = [ctypes.POINTER(P), ctypes.POINTER(I), P, P, P] + [I] * 7 + [P]
        lib.lw_deform_attn_rowmajor.argtypes = [P, ctypes.POINTER(I), P, P, P] + [I] * 8 + [P]
        libs[name] = lib
    return libs, spills


def seeded(dt, B, H, D, P, Q, shapes, clustered, seed=4):
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dt) for h, w in shapes]
    if clustered:
        ref = torch.rand((B, Q, 1, 1, 1, 2), generator=g, device="cuda") * 0.9 + 0.05
        loc = ref + 0.03 * torch.randn((B, Q, H, L, P, 2), generator=g, device="cuda")
    else:
        loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
    return vals, loc, w


def launcher(lib, layout, vals, shapes, loc, w, out):
    """One launch of `lib`'s K4 (panels) or K10 (the same values row-major)."""
    B, H = vals[0].shape[:2]
    D = vals[0].shape[3] // shapes[0][1]
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    hw = (ctypes.c_int * (2 * L))(*[x for s in shapes for x in s])
    code = _CODE[vals[0].dtype]
    if layout == "panels":
        ptrs = (ctypes.c_void_p * L)(*[v.data_ptr() for v in vals])

        def call():
            err = lib.lw_deform_attn_sep(ptrs, hw, loc.data_ptr(), w.data_ptr(), out.data_ptr(),
                                         B, Q, H, D, L, P, code,
                                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"K4 launch failed: CUDA error {err}")
        return call
    rows = torch.cat([v.reshape(B, H, -1, D) for v in vals], dim=2).transpose(1, 2).contiguous()

    def call():
        err = lib.lw_deform_attn_rowmajor(rows.data_ptr(), hw, loc.data_ptr(), w.data_ptr(),
                                          out.data_ptr(), B, rows.shape[1], Q, H, D, L, P, code,
                                          torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K10 launch failed: CUDA error {err}")
    return call


def route(lib, layout, vals, shapes, loc):
    """The variant's route at these sizes (None for a source without the report)."""
    sym = "lw_deform_attn_sep_route" if layout == "panels" else "lw_deform_attn_rowmajor_route"
    if not hasattr(lib, sym):
        return None
    fn = getattr(lib, sym)
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 9)()
    B, Q, H, L, P = loc.shape[:5]
    D = vals[0].shape[3] // shapes[0][1]
    if fn(B, Q, H, D, L, P, _CODE[vals[0].dtype], out):
        raise RuntimeError(f"{sym} failed")
    return dict(zip(da.SEP_ROUTE_KEYS, out))


def compare(libs, name, layout, vals, shapes, loc, w) -> dict:
    """Every variant at one call: error against the plain version, route, and two
    device times, taken in the order of `libs` and then reversed."""
    B, Q, H = loc.shape[:3]
    dt = vals[0].dtype
    rtol = RTOL[dt]
    if dt == torch.bfloat16:  # the plain version rounding where the kernel does: one ulp
        rtol = 2.0 ** -7
        if layout == "panels":
            ref = da.ms_deform_attn_sep_panels_plain(vals, shapes, loc, w).float()
        else:
            D = vals[0].shape[3] // shapes[0][1]
            rows = torch.cat([v.reshape(B, H, -1, D) for v in vals], dim=2).transpose(1, 2)
            ref = da.ms_deform_attn_plain(rows.contiguous(), shapes, loc, w).float()
    else:
        ref = da.ms_deform_attn_sep_panels_plain([v.float() for v in vals], shapes, loc, w)
    row, calls = {"shape": name, "layout": layout, "dtype": str(dt).replace("torch.", "")}, {}
    for vname, lib in libs.items():
        out = torch.empty((B, Q, ref.shape[-1]), device="cuda", dtype=dt)
        calls[vname] = launcher(lib, layout, vals, shapes, loc, w, out)
        calls[vname]()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        if not torch.isfinite(out).all() or (diff > ATOL + rtol * ref.abs()).any():
            raise AssertionError(f"{vname} at {name} {layout} {dt}: max abs err {diff.max().item()}")
        row[vname] = {"max_abs_err": diff.max().item(),
                      "route": route(lib, layout, vals, shapes, loc), "device_ms": []}
    for vname in list(calls) + list(calls)[::-1]:
        row[vname]["device_ms"].append(measure_graph_ms(calls[vname], iters=50)["ms"])
    return row


def step_calls():
    """(name, layout, panels, shapes, loc, weights) of every K4 / K10 call of STEPS."""
    from lwdetr_tpu_torch import bench_deform

    for preset, batch, eval_batch in STEPS:
        for (step, kernel, _), (_, _, args) in bench_deform.recorded_calls(
                preset, batch, eval_batch).items():
            if kernel not in ("K4", "K10"):
                continue
            value, shapes, loc, w = args
            if kernel == "K4":
                vals = value
            else:  # row-major (B, Len_in, H, D) as per-level panels
                B, _, H, D = value.shape
                vals, start = [], 0
                for h, wd in shapes:
                    vals.append(value[:, start:start + h * wd].transpose(1, 2)
                                .reshape(B, H, h, wd * D).contiguous())
                    start += h * wd
            yield (f"{preset} {step}", "panels" if kernel == "K4" else "rowmajor", vals, shapes,
                   loc.float().contiguous(), w.float().contiguous())


def run(names, other, steps=True) -> dict:
    libs, spills = build(names, other)
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        for name, layout, B, H, D, P, Q, shapes, clustered in SHAPES:
            vals, loc, w = seeded(dt, B, H, D, P, Q, shapes, clustered)
            rows.append(compare(libs, name, layout, vals, shapes, loc, w))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    if steps:
        for call in step_calls():
            rows.append(compare(libs, *call))
            print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return {"variants": list(libs), "spills": spills, "rows": rows,
            "device": torch.cuda.get_device_name(), "card": card_line()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="a checkout whose source is the variant 'parent'")
    ap.add_argument("--variants", nargs="+", choices=tuple(VARIANTS),
                    default=list(VARIANTS), help="default: all")
    ap.add_argument("--no-steps", dest="steps", action="store_false",
                    help="the seeded shapes only, not the steps' own calls")
    return ap


def main() -> None:
    args = parser().parse_args()
    names = (["parent"] if args.other else []) + list(args.variants)
    print(json.dumps(run(names, args.other, args.steps)))


if __name__ == "__main__":
    main()
