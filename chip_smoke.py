"""Smoke run of the PyTorch/CUDA port (`lwdetr_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

1. Builds the seven kernels of the eval and train paths (K1-K7,
   `lwdetr_tpu_torch/csrc/`) with nvcc, one process per source, all at once,
   and prints the `-Xptxas -v` register, shared-memory and spill report of
   every template case.
2. Holds each kernel against its plain PyTorch version, in f32 and bf16, at
   the shapes the 640x640 forwards give it with batch 8: K1, K2 and K3 at
   LW-DETR-small's, K1 and K2 also at large's and xlarge's (head_dim 32 and
   64), K4 at large's and xlarge's (two levels of head-major panels, 24 heads,
   4 points). It times the kernel, the plain version and, for K1/K2, one
   `F.scaled_dot_product_attention` call on the same inputs (a yardstick the
   port never calls). The backward kernels K5, K6 and K7 are held against
   their plain versions at the shapes of one LW-DETR-small train step at batch
   4 (3900 queries), K6 also at head_dim 64 and K5 also at large's two-level,
   4-point shape, with SDPA's backward as the yardstick of K6 and K7; K4 also
   at the train step's shape.
3. Drives three eval forwards + `post_process` at 640x640 from
   `init_state_dict(seed=0)`, batch 8, f32: small, then xlarge, then large.
   Every launch counter is set to 0 just before a forward and read just after:
   small must launch K1 6 times, K2 7, K3 3 and K4 0; xlarge and large K1 6,
   K2 7, K3 0 and K4 3. The same model forced onto the plain versions, and
   given the same two-stage proposal picks (near-tied scores may swap under
   rounding; the picks are compared on their own), gives the reference
   outputs. The bf16 model must give finite outputs. Then the bf16 throughput
   of each preset at batch 32 (`lwdetr_tpu_torch.bench`).
4. Drives the train step of LW-DETR-small at 640x640, f32, batch 4, on one
   synthetic batch with 7 boxes an image: one step's gradients through the
   kernels against the same forward with the plain backward versions, per
   parameter tensor, and against the whole step on the plain versions
   (proposal picks and matching replayed); the launch counts of that step
   (K1 6, K2 7, K3 0, K4 3, K5 3, K6 7, K7 6); 12 steps with the release
   optimizer settings (finite losses that fall, an EMA that moves); then the
   step time, img/s, the matcher's host time per step and peak device memory.

Any failure exits non-zero. Without a CUDA card, or outside a checkout, it
exits non-zero and prints no result. The line before the last holds one JSON
object with every kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import sys
from unittest import mock

# peak rates of one H100 SXM (NVIDIA data sheet, dense): the least time the
# card could take for a kernel's work is the largest of its bytes over the
# memory rate and its operations over the rate for their type
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 tensor cores
# exp2 on the special-function units: 16 per clock per SM (CUDA C++ Programming
# Guide, throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz boost
EXP_PER_S = 16 * 132 * 1.98e9

# kernel vs plain version on the same inputs, element by element:
# |kernel - plain| <= ATOL + RTOL * |plain|. The plain version runs in f32 on
# the inputs upcast to f32 (for bf16 inputs, the exact values the kernel
# loads). f32: the same f32 arithmetic summed in another order (ATOL). bf16:
# the kernel computes in f32 and rounds its result to bf16 once, to nearest
# even, so it lies within half a bf16 ulp of the f32 result, which is at most
# 2^-8 of the value. A dropped or mis-scaled key tile, or a truncating
# conversion, breaks that bound.
ATOL = 2e-5
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# whole 640x640 forward, kernels vs plain versions, f32: ~20 layers of
# f32 sums in another order. On an H100 the three presets read 1.6e-5 to
# 3.1e-5 on the logits and 1.5e-6 to 4.7e-6 on the boxes (the largest on
# large); the bounds leave two orders of magnitude for other cards and
# library versions, and a dropped key tile or a wrong corner moves the
# logits by 1e-1 or more
FWD_ATOL_LOGITS = 2e-3
FWD_ATOL_BOXES = 5e-4
MIN_TOPK_OVERLAP = 0.98  # of the 300 picks / (query, label) pairs per image

BATCH = 8
# launches per forward: 6 window blocks; 4 global blocks + 3 decoder
# self-attentions; 3 decoder cross-attentions, from channel-major values below
# 4096 memory positions (small: 1600) and from panels above (P3 + P5: 6800)
# (no eval forward launches a backward kernel)
_NO_BWD = {"K5": 0, "K6": 0, "K7": 0}
EXPECTED_LAUNCHES = {"small": {"K1": 6, "K2": 7, "K3": 3, "K4": 0, **_NO_BWD},
                     "xlarge": {"K1": 6, "K2": 7, "K3": 0, "K4": 3, **_NO_BWD},
                     "large": {"K1": 6, "K2": 7, "K3": 0, "K4": 3, **_NO_BWD}}
# one train step of small: the forward's launches (the decoder samples from
# panels in train mode: K4, not K3) and one backward launch for each
TRAIN_LAUNCHES = {"K1": 6, "K2": 7, "K3": 0, "K4": 3, "K5": 3, "K6": 7, "K7": 6}
TRAIN_BATCH = 4
TRAIN_STEPS = 12
# how the backward kernels' absolute bound scales (see `grad_scale`)
BWD_TOL = {"K5": " x max(1, max |plain|), x 4 on d(panel) for the order of its atomic adds",
           "K6": " x max(1, max |plain|)", "K7": " x max(1, max |plain|)"}
# one train step, f32: backward kernels vs plain backwards on the same forward,
# per parameter tensor, max |difference| over that tensor's max |gradient|
# (floored at GRAD_FLOOR x the largest gradient of all); and kernels vs the
# whole step on the plain versions, relative L2 error over all gradients
TRAIN_GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-5
TRAIN_GRAD_L2 = 5e-2
REPLACES = {
    "K1": "lwdetr_tpu/ops/flash_attention.py:95 _attn_cm_allheads_bias_kernel",
    "K2": "lwdetr_tpu/ops/flash_attention.py:43 _attn_cm_kernel",
    "K3": "lwdetr_tpu/ops/deform_attn.py:444 _deform_cm_kernel",
    "K4": "lwdetr_tpu/ops/deform_attn.py:853 _sep_kernel",
    "K5": "lwdetr_tpu/ops/deform_attn.py:1105 _sep_bwd_kernel",
    "K6": "lwdetr_tpu/ops/flash_attention.py:287 _attn_cm_bwd_kernel",
    "K7": "lwdetr_tpu/ops/flash_attention.py:347 _attn_cm_bwd_allheads_kernel",
}
SOURCES = {"K1": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K2": "lwdetr_tpu_torch/csrc/flash_attention.cu",
           "K3": "lwdetr_tpu_torch/csrc/deform_attn.cu",
           "K4": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu",
           "K5": "lwdetr_tpu_torch/csrc/deform_attn_sep_bwd.cu",
           "K6": "lwdetr_tpu_torch/csrc/flash_attention_bwd.cu",
           "K7": "lwdetr_tpu_torch/csrc/window_attention_bwd.cu"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bound_ms(nbytes: float, flops: float, exps: float, dtype: str):
    t = {"bytes": nbytes / HBM_BYTES_PER_S, "flops": flops / FLOPS_PER_S[dtype],
         "exps": exps / EXP_PER_S}
    by = max(t, key=t.get)
    return t[by] * 1e3, ("bytes" if by == "bytes" else "operations"), t


def build_kernels():
    from lwdetr_tpu_torch.ops import _build

    for src in _build.SOURCES:  # build from this checkout's sources, now
        _build.library_path(src).unlink(missing_ok=True)
    logs = _build.build(_build.SOURCES)
    for src, text in logs.items():
        for line in text.splitlines():
            if line.startswith("ptxas info") and ("Compiling" in line or "Used" in line):
                print(f"[{src}] {line.strip()}")
            elif "spill" in line and not line.strip().startswith("0 bytes"):
                print(f"[{src}] {line.strip()}")


def check_close(torch, name, dtype, out, ref, atol_scale=1.0):
    """max |out - ref|; raises unless every element is within ATOL x atol_scale + RTOL|ref|."""
    diff = (out.float() - ref).abs()
    atol = ATOL * atol_scale
    excess = (diff - (atol + RTOL[dtype] * ref.abs())).max().item()
    err = diff.max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name} {dtype}: max abs err {err}, over ATOL {atol} + RTOL "
                             f"{RTOL[dtype]} x |plain| by {excess}")
    return err


def grad_scale(ref):
    """A gradient sums many terms of either sign, so its f32 bound scales with
    its magnitude: ATOL x max(1, max |plain|)."""
    return max(1.0, ref.abs().max().item())


def attention_inputs(torch, B, C, N, heads, dtype, bias, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = (0.5 * torch.randn((B, 3 * C, N), generator=g, device="cuda")).to(dtype)
    b = 0.1 * torch.randn((3 * C,), generator=g, device="cuda") if bias else None
    return qkv, b


def compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype):
    """Kernel vs plain (and SDPA) on one attention shape; returns the numbers."""
    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C)
    D = C // heads
    if bias:
        kernel = lambda: fa.window_attention_bias(qkv, b, heads, scale)  # noqa: E731
        # the kernel adds the f32 bias to the loaded panel: the reference gets
        # the same f32 sum; the timed plain version is `attention_cm`'s own
        qkv_lib = qkv.float() + b[:, None]
        plain = lambda: fa.attention_cm_plain(qkv + b.to(dt)[:, None], heads, scale)  # noqa: E731
    else:
        kernel = lambda: fa.flash_attention_cm(qkv, heads, scale)  # noqa: E731
        qkv_lib = qkv.float()
        plain = lambda: fa.attention_cm_plain(qkv, heads, scale)  # noqa: E731
    q, k, v = (qkv_lib.to(dt).reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               for i in range(3))
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        ref = fa.attention_cm_plain(qkv_lib, heads, scale)  # f32: the reference
        lib = library().transpose(-1, -2).reshape(B, C, N)
        torch.cuda.synchronize()
        err = check_close(torch, f"{name} {tuple(qkv.shape)}", dtype, out, ref)
        lib_err = (lib.float() - ref).abs().max().item()
        ms = measure_ms(kernel)["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
        library_ms = measure_ms(library)["ms"]
    isz = qkv.element_size()
    nbytes = B * 4 * C * N * isz + (3 * C * 4 if bias else 0)
    flops = 4 * B * heads * N * N * D
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype)
    log(f"{name} {dtype} qkv {tuple(qkv.shape)}: err {err:.3g} (sdpa vs plain {lib_err:.3g}) "
        f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {library_ms:.4f} bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items()) + ")")
    return {"shape": list(qkv.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}


def compare_deform(torch, da, measure_ms, dtype):
    dt = getattr(torch, dtype)
    B, C, H, L, P, Q = BATCH, 256, 16, 1, 2, 300
    shapes = [(40, 40)]
    g = torch.Generator(device="cuda").manual_seed(3)
    value_t = torch.randn((B, C, 1600), generator=g, device="cuda").to(dt)
    # a tenth of the points fall outside the map: their corners drop out
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.2 - 0.1
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
    kernel = lambda: da.ms_deform_attn_cm(value_t, shapes, loc, w, H)  # noqa: E731
    plain = lambda: da.ms_deform_attn_cm_plain(value_t, shapes, loc, w, H)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        ref = da.ms_deform_attn_cm_plain(value_t.float(), shapes, loc, w, H)
        torch.cuda.synchronize()
        err = check_close(torch, "K3", dtype, out, ref)
        ms = measure_ms(kernel)["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
    nbytes = (value_t.numel() + B * C * Q) * value_t.element_size() + (loc.numel() + w.numel()) * 4
    flops = 2 * 4 * B * Q * C * L * P  # 4 corners x (multiply + add) per output channel
    bms, by, parts = bound_ms(nbytes, flops, 0, dtype)
    log(f"K3 {dtype} value {tuple(value_t.shape)} Q {Q}: err {err:.3g} ms {ms:.4f} "
        f"plain {plain_ms:.4f} bound {bms:.4f} ({by})")
    return {"shape": list(value_t.shape) + [Q], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None}


def touched_positions(torch, loc_l, hw):
    """Distinct (b, h, y, x) map positions that the bilinear corners of one
    level's points loc_l (B, Q, H, P, 2) fall on; corners outside the map read
    nothing."""
    Hl, Wl = hw
    B, _, H = loc_l.shape[:3]
    x0 = torch.floor(loc_l[..., 0].double() * Wl - 0.5)
    y0 = torch.floor(loc_l[..., 1].double() * Hl - 0.5)
    plane = (torch.arange(B, device=loc_l.device)[:, None, None, None] * H
             + torch.arange(H, device=loc_l.device)[None, None, :, None])  # (B, 1, H, 1)
    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            inside = (x >= 0) & (x < Wl) & (y >= 0) & (y < Hl)
            key = (plane * Hl + y.clamp(0, Hl - 1).long()) * Wl + x.clamp(0, Wl - 1).long()
            keys.append(key[inside])
    return torch.unique(torch.cat(keys)).numel()


# K4 / K5 shapes: (B, heads, head_dim, points, queries, levels)
SEP_LARGE = (BATCH, 24, 16, 4, 300, [(80, 80), (20, 20)])       # large / xlarge eval
SEP_SMALL_TRAIN = (4, 16, 16, 2, 3900, [(40, 40)])              # small's train step, batch 4
SEP_LARGE_TRAIN = (BATCH, 24, 16, 4, 3900, [(80, 80), (20, 20)])  # large with 13 query groups


def sep_inputs(torch, dt, shape, seed=4):
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dt) for h, w in shapes]
    # about a sixth of the points fall outside [0, 1] in x or y, so some or all
    # of their corners drop out; query 0 sits on the borders, query 1 far outside
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    loc[:, 0, :, :, 0::2] = 0.0
    loc[:, 0, :, :, 1::2] = 1.0
    loc[:, 1] = loc[:, 1] * 1e6 - 3e5
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
    dout = torch.randn((B, Q, H * D), generator=g, device="cuda").to(dt)
    return vals, loc, w, dout, outside


def sep_panel_bytes(torch, vals, loc, shapes, D):
    """Bytes of each panel that the run's points name: the distinct in-map
    corners (each D channels wide), once each, never more than the panel."""
    touched = [touched_positions(torch, loc[:, :, :, lvl], hw) for lvl, hw in enumerate(shapes)]
    return [min(v.numel(), n * D) * v.element_size() for v, n in zip(vals, touched)]


def compare_deform_sep(torch, da, measure_ms, dtype, shape=SEP_LARGE):
    """K4 at the shapes of the large and xlarge 640x640 forwards, or at `shape`."""
    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, _, outside = sep_inputs(torch, dt, shape)
    kernel = lambda: da.ms_deform_attn_sep_panels(vals, shapes, loc, w)  # noqa: E731
    plain = lambda: da.ms_deform_attn_sep_panels_plain(vals, shapes, loc, w)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        ref = da.ms_deform_attn_sep_panels_plain([v.float() for v in vals], shapes, loc, w)
        torch.cuda.synchronize()
        if out.shape != (B, Q, H * D) or out.dtype != dt:
            raise AssertionError(f"K4 output {tuple(out.shape)} {out.dtype}")
        err = check_close(torch, "K4", dtype, out, ref)
        # ~0.05 ms a call: 200 calls a sample, so that launch jitter averages out
        timed = measure_ms(kernel, iters=200, repeats=7)
        ms = timed["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    # bytes the function must move for these locations: of each panel only the
    # distinct in-map corners the points name (each D channels wide), once
    # each, and never more than the panel; loc and weights in, (B, Q, C) out
    isz = vals[0].element_size()
    nbytes = sum(panel_bytes) + out.numel() * isz + (loc.numel() + w.numel()) * 4
    flops = 2 * 4 * B * Q * H * D * L * P  # 4 corners x (multiply + add) per output channel
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    log(f"K4 {dtype} panels {[tuple(v.shape) for v in vals]} Q {Q}: {outside:.3f} of the points "
        f"outside [0, 1]; err {err:.3g} ms {ms:.4f} (samples {timed['ms_min']:.4f}-"
        f"{timed['ms_max']:.4f}) plain {plain_ms:.4f} bound {bms:.4f} ({by}, {nbytes / 1e6:.1f} MB: "
        f"panels {[round(b / 1e6, 1) for b in panel_bytes]} of "
        f"{[round(v.numel() * isz / 1e6, 1) for v in vals]} MB)")
    return {"shape": [list(v.shape) for v in vals] + [Q], "max_abs_err": err, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"],
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": None,
            "bound_bytes": nbytes, "panel_bytes_needed": panel_bytes,
            "panel_bytes": [v.numel() * isz for v in vals], "points_outside_share": outside}


def compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape):
    """K5 against its plain version: d(panels), d(loc), d(weights) from d(out)."""
    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, dout, outside = sep_inputs(torch, dt, shape)
    kernel = lambda: da.ms_deform_attn_sep_panels_bwd(vals, shapes, loc, w, dout)  # noqa: E731
    plain = lambda: da.ms_deform_attn_sep_panels_bwd_plain(vals, shapes, loc, w, dout)  # noqa: E731
    with torch.no_grad():
        dvals, dloc, dw = kernel()
        rvals, rloc, rw = da.ms_deform_attn_sep_panels_bwd_plain(
            [v.float() for v in vals], shapes, loc, w, dout.float())
        torch.cuda.synchronize()
        # d(panel): up to hundreds of f32 atomic adds per position, in an order
        # that changes from run to run: 4 x the f32 bound of the other outputs
        err = max(check_close(torch, f"K5 d(panel {i})", dtype, dv, rv, 4.0 * grad_scale(rv))
                  for i, (dv, rv) in enumerate(zip(dvals, rvals)))
        err_loc = check_close(torch, "K5 d(loc)", "float32", dloc, rloc, grad_scale(rloc))
        err_w = check_close(torch, "K5 d(weights)", "float32", dw, rw, grad_scale(rw))
        untouched = sum(int(((rv == 0) & (dv.float() != 0)).sum()) for dv, rv in zip(dvals, rvals))
        if untouched:
            raise AssertionError(f"K5: {untouched} positions no point touches got a gradient")
        timed = measure_ms(kernel, iters=200, repeats=5)
        ms = timed["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    # bytes: the corners the points name and d(out), loc, weights in; every
    # d(panel) position (touched or zero), d(loc) and d(weights) out
    isz = vals[0].element_size()
    nbytes = (sum(panel_bytes) + dout.numel() * isz + (loc.numel() + w.numel()) * 4
              + sum(v.numel() for v in vals) * isz + (loc.numel() + w.numel()) * 4)
    flops = 2 * 2 * 4 * B * Q * H * D * L * P  # per corner and channel: a dot term and an add
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    adds = B * Q * H * L * P * 4 * D
    log(f"K5 {dtype} panels {[tuple(v.shape) for v in vals]} Q {Q} P {P}: {outside:.3f} of the "
        f"points outside [0, 1]; err d(panel) {err:.3g} (max |plain| "
        f"{max(rv.abs().max().item() for rv in rvals):.3g}) d(loc) {err_loc:.3g} d(w) {err_w:.3g} "
        f"ms {ms:.4f} (samples {timed['ms_min']:.4f}-{timed['ms_max']:.4f}) plain {plain_ms:.4f} "
        f"bound {bms:.4f} ({by}, {nbytes / 1e6:.1f} MB; at most {adds / 1e6:.1f} M atomic adds)")
    return {"shape": [list(v.shape) for v in vals] + [Q], "max_abs_err": err,
            "max_abs_err_dloc": err_loc, "max_abs_err_dweights": err_w, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"], "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None, "bound_bytes": nbytes,
            "atomic_adds_at_most": adds, "points_outside_share": outside}


def compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype,
                          iters):
    """K6 or K7 (with `bias`) vs the plain backward, and SDPA's backward, on one shape."""
    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C + 1)
    g = torch.Generator(device="cuda").manual_seed(N)
    dout = torch.randn((B, C, N), generator=g, device="cuda").to(dt)
    D = C // heads
    with torch.no_grad():
        if bias:
            kernel = lambda: fa.window_attention_bias_bwd(qkv, b, dout, heads, scale)  # noqa: E731
            plain = lambda: fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=b)  # noqa: E731
            ref = fa.attention_cm_bwd_plain(qkv.float(), dout.float(), heads, scale, bias=b)
            qkv_lib = qkv.float() + b[:, None]
        else:
            # K6 reads what K2 saved: its output and the rows' log-sum-exp; the
            # plain version takes its row term from the same output
            out, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
            kernel = lambda: fa.flash_attention_cm_bwd(qkv, out, lse, dout, heads, scale)  # noqa: E731
            plain = lambda: fa.attention_cm_bwd_plain(qkv, dout, heads, scale, out=out)  # noqa: E731
            ref = fa.attention_cm_bwd_plain(qkv.float(), dout.float(), heads, scale,
                                            out=out.float())
            qkv_lib = qkv.float()
        dqkv = kernel()
        torch.cuda.synchronize()
        err = check_close(torch, f"{name} {tuple(qkv.shape)}", dtype, dqkv, ref, grad_scale(ref))
        ms = measure_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
    # the library's backward of the same attention: the forward (and its
    # graph) is made here, outside the timing
    q, k, v = (qkv_lib.to(dt).reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               .requires_grad_() for i in range(3))
    do_lib = dout.reshape(B, heads, D, N).transpose(-1, -2).contiguous()
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    library = lambda: torch.autograd.grad(o, (q, k, v), do_lib, retain_graph=True)  # noqa: E731
    lib = torch.stack([t.transpose(-1, -2) for t in library()], dim=1).reshape(B, 3 * C, N)
    lib_err = (lib.float() - ref).abs().max().item()
    library_ms = measure_ms(library, iters=iters)["ms"]
    isz = qkv.element_size()
    # qkv, d(out) and (K6) out and the log-sum-exp in; d(qkv) out
    nbytes = B * (7 * C) * N * isz + (3 * C * 4 if bias else B * C * N * isz + B * heads * N * 4)
    flops = 10 * B * heads * N * N * D  # five (N, N, D) products: s, dp, dq, dk, dv
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype)
    log(f"{name} {dtype} qkv {tuple(qkv.shape)}: err {err:.3g} of max |plain| "
        f"{ref.abs().max().item():.3g} (sdpa bwd vs plain {lib_err:.3g}) ms {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa bwd {library_ms:.4f} bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items()) + ")")
    return {"shape": list(qkv.shape), "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}


# the attention shapes of the three forwards at batch 8: (key, kernel, B, C, N,
# heads, scale, bias). The ViT folds its scale into q (scale 1); 16 windows an image.
ATTENTION_SHAPES = (
    ("K1", "K1", BATCH * 16, 192, 100, 12, 1.0, True),            # small: head_dim 16
    ("K2", "K2", BATCH, 192, 1600, 12, 1.0, False),
    ("K2dec", "K2", BATCH, 256, 300, 8, 32 ** -0.5, False),       # small's decoder
    ("K1@large", "K1", BATCH * 16, 384, 100, 12, 1.0, True),      # ViT-small: head_dim 32
    ("K2@large", "K2", BATCH, 384, 1600, 12, 1.0, False),
    ("K1@xlarge", "K1", BATCH * 16, 768, 100, 12, 1.0, True),     # ViT-base: head_dim 64
    ("K2@xlarge", "K2", BATCH, 768, 1600, 12, 1.0, False),
    ("K2dec@large", "K2", BATCH, 384, 300, 12, 32 ** -0.5, False),  # large and xlarge decoder
)


# the backward shapes of one small train step at batch 4 (3900 queries in 13
# groups of 300, folded into the batch for the decoder's self-attention), and
# K6 at head_dim 64: (key, kernel, B, C, N, heads, scale, bias, calls a sample).
# K7 takes 200 calls a sample, so that host enqueue time is not in it; a K6
# launch takes milliseconds, where 20 (5 at head_dim 64) do.
ATTENTION_BWD_SHAPES = (
    ("K7", "K7", TRAIN_BATCH * 16, 192, 100, 12, 1.0, True, 200),
    ("K6", "K6", TRAIN_BATCH, 192, 1600, 12, 1.0, False, 20),
    ("K6dec", "K6", TRAIN_BATCH * 13, 256, 300, 8, 32 ** -0.5, False, 20),
    ("K6@xlarge", "K6", BATCH, 768, 1600, 12, 1.0, False, 5),
)


def kernel_phase(torch, F, fa, da, measure_ms):
    """Every kernel against its plain version at the eval and train paths' shapes."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype)
        res[("K3", dtype)] = compare_deform(torch, da, measure_ms, dtype)
        res[("K4", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype)
        res[("K4@train", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype,
                                                      SEP_SMALL_TRAIN)
        for key, name, B, C, N, heads, scale, bias, iters in ATTENTION_BWD_SHAPES:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters)
        res[("K5", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, SEP_SMALL_TRAIN)
        res[("K5@large", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                          SEP_LARGE_TRAIN)
    return res


def plain_attention(fa):
    """`attention_cm` on the plain version (autograd through it gives the reference gradients)."""

    def attention(qkv_t, num_heads, scale=None, bias=None):
        if bias is not None:
            qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
        return fa.attention_cm_plain(qkv_t, num_heads, scale)

    return attention


def forward_phase(torch, fa, da, kernels, preset):
    """`preset`'s eval path once through the kernels (counted), once through the plain versions."""
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.models.lwdetr import build_model, post_process
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = get_config(preset)
    model = build_model(cfg, device="cuda", dtype=torch.float32,
                        state_dict=init_state_dict(cfg, seed=0))
    g = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((BATCH, 640, 640, 3), generator=g, device="cuda")
    sizes = torch.full((BATCH, 2), 640.0, device="cuda")

    def run():
        with torch.no_grad():
            out = model(images)
            dets = post_process(out["pred_logits"], out["pred_boxes"], sizes, cfg.num_select)
        torch.cuda.synchronize()
        return out, dets

    # the two-stage head picks 300 of the 1600 (P4) or 6800 (P3 + P5) proposals by score; near-tied
    # scores can swap under f32 rounding, and a swap reseeds whole queries.
    # The plain run below reuses the kernel run's picks (compared on their own)
    # so that the outputs compare query for query. The patches below replace
    # module attributes, so the model must keep calling `tr.select_proposals`,
    # `fa.attention_cm`, `da.ms_deform_attn_cm` and `da.ms_deform_attn_sep_panels`
    # through their modules: the
    # launch counts and the replay counts check that it does.
    picks, own_picks, pool = [], [], []

    def record(scores, k):
        idx = select(scores, k)
        picks.append(idx)
        pool.append(scores.shape[1])
        return idx

    def replay(scores, k):
        own_picks.append(select(scores, k))
        return picks[len(own_picks) - 1]

    select = tr.select_proposals
    for k in kernels:
        k.launches = 0
    with mock.patch.object(tr, "select_proposals", record):
        out, dets = run()
    launches = {k.name: k.launches for k in kernels}
    log(f"{preset}@640 launches: {launches}")
    if launches != EXPECTED_LAUNCHES[preset]:
        raise AssertionError(f"{preset}: launches {launches} != {EXPECTED_LAUNCHES[preset]}")

    with mock.patch.object(fa, "attention_cm", plain_attention(fa)), \
            mock.patch.object(da, "ms_deform_attn_cm", da.ms_deform_attn_cm_plain), \
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              da.ms_deform_attn_sep_panels_plain), \
            mock.patch.object(tr, "select_proposals", replay):
        ref, ref_dets = run()
    if [k.launches for k in kernels] != list(launches.values()):
        raise AssertionError(f"{preset}: the plain forward launched a kernel")
    if len(picks) != 1 or len(own_picks) != len(picks):
        raise AssertionError(f"proposal picks: {len(picks)} recorded, {len(own_picks)} replayed")
    same_pos = (picks[0] == own_picks[0]).float().mean().item()
    same_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(picks[0], own_picks[0]))
    log(f"{preset}@640 two-stage picks ({picks[0].shape[1]} of {pool[0]}), kernels vs plain: "
        f"same position {same_pos:.4f}, same set min {same_set:.4f}")
    if same_set < MIN_TOPK_OVERLAP:
        raise AssertionError(f"two-stage picks differ: set overlap {same_set}")

    logits, boxes = out["pred_logits"], out["pred_boxes"]
    if logits.shape != (BATCH, 300, 91) or boxes.shape != (BATCH, 300, 4):
        raise AssertionError(f"shapes {tuple(logits.shape)} {tuple(boxes.shape)}")
    if not (torch.isfinite(logits).all() and torch.isfinite(boxes).all()):
        raise AssertionError("non-finite outputs")
    err_l = (logits - ref["pred_logits"]).abs().max().item()
    err_b = (boxes - ref["pred_boxes"]).abs().max().item()
    K = logits.shape[-1]
    overlap = []
    for b in range(BATCH):
        sel = lambda lg: set(torch.topk(lg[b].reshape(-1), cfg.num_select).indices.tolist())  # noqa: E731
        overlap.append(len(sel(logits) & sel(ref["pred_logits"])) / cfg.num_select)
    log(f"{preset}@640 f32 forward, kernels vs plain: logits err {err_l:.3g}, boxes err {err_b:.3g}, "
        f"top-{cfg.num_select} (query, label) overlap min {min(overlap):.4f} (K={K})")
    if err_l > FWD_ATOL_LOGITS or err_b > FWD_ATOL_BOXES or min(overlap) < MIN_TOPK_OVERLAP:
        raise AssertionError(f"{preset}: forward disagrees with the plain versions: logits {err_l}, "
                             f"boxes {err_b}, overlap {min(overlap)}")
    scores = dets[0]
    if not torch.isfinite(scores).all() or scores.shape != (BATCH, cfg.num_select):
        raise AssertionError("post_process scores are not finite or of the wrong shape")

    # the same weights in bf16 (the deployed precision), with the f32 run's
    # proposal picks (bf16 scores tie often): finite, and how far from f32
    # (reported, not bounded: bf16 rounds at every layer)
    model16 = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                          state_dict=init_state_dict(cfg, seed=0))
    own_picks.clear()
    with torch.no_grad(), mock.patch.object(tr, "select_proposals", replay):
        out16 = model16(images.to(torch.bfloat16))
    if len(own_picks) != len(picks):
        raise AssertionError(f"bf16 forward replayed {len(own_picks)} of {len(picks)} picks")
    if not (torch.isfinite(out16["pred_logits"]).all() and torch.isfinite(out16["pred_boxes"]).all()):
        raise AssertionError("non-finite bf16 outputs")
    bf16_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(picks[0], own_picks[0]))
    bf16_l = (out16["pred_logits"].float() - logits).abs().max().item()
    bf16_b = (out16["pred_boxes"].float() - boxes).abs().max().item()
    log(f"{preset}@640 bf16 forward vs f32 (f32 picks): logits max diff {bf16_l:.3g}, "
        f"boxes {bf16_b:.3g}; bf16's own picks share {bf16_set:.4f} of the f32 set")
    return launches, {"logits_max_abs_err": err_l, "boxes_max_abs_err": err_b,
                      "bf16_vs_f32_logits_max_diff": bf16_l, "bf16_vs_f32_boxes_max_diff": bf16_b,
                      "bf16_own_picks_same_set_min": bf16_set,
                      "topk_overlap_min": min(overlap), "proposal_picks_same_position": same_pos,
                      "proposal_picks_same_set_min": same_set}


def train_phase(torch, fa, da, kernels, measure_ms, card):
    """The small@640 f32 train step at batch 4: gradients through the kernels vs
    the plain versions, launch counts, 12 optimizer steps, step time."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr

    state, step = bench_train.make_train_step("small", TRAIN_BATCH, seed=0)
    model = state.model
    mcfg = model.cfg
    criterion = cm.SetCriterion(mcfg, bench_train.get_train_config("small"))
    data = bench_train.synthetic_batch(mcfg.num_classes, TRAIN_BATCH, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])

    # (a) one forward + backward through the kernels, then (a1) the same forward
    # with each backward kernel swapped for its plain version, and (a2) the whole
    # step on the plain versions with torch.autograd. Near-tied proposal scores
    # and matching costs can flip under f32 rounding and would reseed whole
    # queries, so the other runs replay the kernel run's picks (13 groups) and
    # its matching. The step has more kinks than those: a plain forward differs
    # from the kernels' by ~1e-6, which flips ReLU units of the decoder's FFN and
    # moves sampling points across grid lines, and each flip moves a gradient
    # tensor by up to 1e-2 of its maximum. So the per-tensor bound holds (a1),
    # where both runs share one forward bit for bit, and (a2) is held to the
    # loss and to the relative L2 error over all gradients.
    select, match = tr.select_proposals, cm.hungarian_match
    picks, matchings, replayed = [], [], []

    def record_pick(scores, k):
        picks.append(select(scores, k))
        return picks[-1]

    def replay_pick(scores, k):
        replayed.append(select(scores, k))
        return picks[(len(replayed) - 1) % len(picks)]

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def grads():
        model.zero_grad(set_to_none=True)
        out = model(data["images"])
        total, losses = criterion(out, targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    def compare(grads_ref, label):
        """Per tensor: max |difference| over max |reference|, with a floor of
        GRAD_FLOOR x the largest gradient of all, since some gradients are zero
        in exact arithmetic (a bias in front of a train-mode BatchNorm)."""
        top = max(g.abs().max().item() for g in grads_ref.values())
        rel = {n: ((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
               for n, g in grads_ref.items()}
        worst = max(rel, key=rel.get)
        num = sum((grads_k[n] - g).double().square().sum() for n, g in grads_ref.items())
        l2 = (num / sum(g.double().square().sum() for g in grads_ref.values())).sqrt().item()
        log(f"small@640 train step, kernels vs {label}, f32, batch {TRAIN_BATCH}: gradient max "
            f"rel err over {len(rel)} parameter tensors {rel[worst]:.3g} ({worst}), median "
            f"{sorted(rel.values())[len(rel) // 2]:.3g}; relative L2 error of all gradients {l2:.3g}")
        return rel[worst], worst, l2

    for k in kernels:
        k.launches = 0
    with mock.patch.object(tr, "select_proposals", record_pick), \
            mock.patch.object(cm, "hungarian_match", record_match):
        loss_k, grads_k = grads()
    launches = {k.name: k.launches for k in kernels}
    log(f"small@640 train step launches: {launches}")
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"train step: launches {launches} != {TRAIN_LAUNCHES}")
    if not all(torch.isfinite(g).all() for g in grads_k.values()):
        raise AssertionError("non-finite gradients")
    replay = (mock.patch.object(tr, "select_proposals", replay_pick),
              mock.patch.object(cm, "hungarian_match", lambda *a, **kw: matchings[0]))

    with replay[0], replay[1], \
            mock.patch.object(fa, "window_attention_bias_bwd",
                              lambda qkv, bias, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias)), \
            mock.patch.object(fa, "flash_attention_cm_bwd",
                              lambda qkv, out, lse, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale, out=out)), \
            mock.patch.object(da, "ms_deform_attn_sep_panels_bwd",
                              da.ms_deform_attn_sep_panels_bwd_plain):
        loss_b, grads_b = grads()
    if [k.launches for k in kernels[4:]] != [launches[k.name] for k in kernels[4:]]:
        raise AssertionError("the step on the plain backwards launched a backward kernel")
    bwd_err, bwd_worst, bwd_l2 = compare(grads_b, "the plain backwards on the same forward")
    if abs(loss_b - loss_k) > 1e-6 * abs(loss_k) or bwd_err > TRAIN_GRAD_RTOL:
        raise AssertionError(f"backward kernels disagree with their plain versions: {bwd_worst} "
                             f"{bwd_err}, loss {loss_k} vs {loss_b}")
    del grads_b

    before = [k.launches for k in kernels]
    with replay[0], replay[1], mock.patch.object(fa, "attention_cm", plain_attention(fa)), \
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              da.ms_deform_attn_sep_panels_plain):
        loss_p, grads_p = grads()
    if [k.launches for k in kernels] != before:
        raise AssertionError("the plain train step launched a kernel")
    if len(picks) != mcfg.group_detr or len(replayed) != 2 * len(picks) or len(matchings) != 1:
        raise AssertionError(f"{len(picks)} picks recorded, {len(replayed)} replayed, "
                             f"{len(matchings)} matchings")
    same_pick = min((a == b).float().mean().item() for a, b in zip(picks, replayed[len(picks):]))
    log(f"small@640 train step loss, kernels {loss_k:.7f} vs all plain {loss_p:.7f}; the plain "
        f"forward's own picks at the same position {same_pick:.4f}")
    all_err, all_worst, all_l2 = compare(grads_p, "the whole step on the plain versions")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or all_l2 > TRAIN_GRAD_L2:
        raise AssertionError(f"train step disagrees with the plain versions: loss {loss_k} vs "
                             f"{loss_p}, relative L2 error of the gradients {all_l2}")
    del grads_k, grads_p
    model.zero_grad(set_to_none=True)

    # (c) 12 steps on that batch with the release optimizer settings
    torch.cuda.reset_peak_memory_stats()
    losses = [step()["loss"] for _ in range(TRAIN_STEPS)]
    losses = [float(x) for x in losses]
    log(f"small@640 {TRAIN_STEPS} train steps, loss: " + " ".join(f"{x:.4f}" for x in losses))
    moved = max((state.ema[k] - v.detach()).abs().max().item()
                for k, v in model.named_parameters())
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if losses[-1] >= losses[0] or state.step != TRAIN_STEPS or moved <= 0:
        raise AssertionError(f"training made no progress: loss {losses[0]} -> {losses[-1]}, "
                             f"step {state.step}, max |ema - parameters| {moved}")

    # (d) step time after those warm-up steps, and the matcher's host time
    timer = bench_train.HostTimer(cm.hungarian_match)
    with mock.patch.object(cm, "hungarian_match", timer):
        t = measure_ms(step, iters=5, warmup=0, repeats=3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    res = {"batch": TRAIN_BATCH, "launches": launches, "loss_kernels": loss_k,
           "loss_plain": loss_p, "grad_max_rel_err_plain_backwards": bwd_err,
           "grad_worst_tensor_plain_backwards": bwd_worst, "grad_rel_l2_plain_backwards": bwd_l2,
           "grad_max_rel_err_all_plain": all_err, "grad_worst_tensor_all_plain": all_worst,
           "grad_rel_l2_all_plain": all_l2,
           "picks_same_position_min": same_pick, "losses": losses,
           "ema_max_abs_distance": moved, "step_ms": t["ms"], "step_ms_samples": t["samples"],
           "img_per_s": TRAIN_BATCH / (t["ms"] / 1e3),
           "matcher_host_ms_per_step": timer.seconds * 1e3 / timer.calls,
           "peak_memory_mb": peak, "card": card}
    print(f"small@640 f32 train step, batch {TRAIN_BATCH}: {t['ms']:.3f} ms "
          f"({card}), samples {[round(x, 3) for x in t['samples']]}")
    print(f"lwdetr_small_640_f32_train_throughput: {res['img_per_s']:.3f} img/s ({card})")
    print(f"matcher host time: {res['matcher_host_ms_per_step']:.3f} ms per step ({card})")
    print(f"peak device memory over the train steps: {peak:.1f} MiB ({card})")
    return launches, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 1
    import torch.nn.functional as F

    from lwdetr_tpu_torch import bench
    from lwdetr_tpu_torch.ops import deform_attn as da
    from lwdetr_tpu_torch.ops import flash_attention as fa
    from lwdetr_tpu_torch.utils.device import card_line
    from lwdetr_tpu_torch.utils.timing import measure_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32, so that the
    torch.backends.cudnn.allow_tf32 = False  # projector convs hide no kernel error
    kernels = {"K1": fa.window_attention_bias_kernel, "K2": fa.flash_attention_cm_kernel,
               "K3": da.deform_attn_cm_kernel, "K4": da.deform_attn_sep_kernel,
               "K5": da.deform_attn_sep_bwd_kernel, "K6": fa.flash_attention_cm_bwd_kernel,
               "K7": fa.window_attention_bias_bwd_kernel}

    build_kernels()
    res = kernel_phase(torch, F, fa, da, measure_ms)
    launches, fwd, thr = {}, {}, {}
    for preset in EXPECTED_LAUNCHES:
        launches[preset], fwd[preset] = forward_phase(torch, fa, da, list(kernels.values()), preset)
    launches["small_train"], train = train_phase(torch, fa, da, list(kernels.values()),
                                                 measure_ms, card_line())
    for preset in EXPECTED_LAUNCHES:
        thr[preset] = bench.run(preset, batch=32)
        log(f"{preset}@640 bf16 throughput: {thr[preset]['value']} img/s at batch 32 "
            f"({thr[preset]['ms_per_batch']} ms)")

    def both(key):
        return {"bfloat16": res[(key, "bfloat16")], "float32": res[(key, "float32")]}

    # each kernel's headline numbers are bf16 at the first path that runs it
    # (small's eval for K1-K3, large's for K4, small's train step for K5-K7);
    # its other shapes and f32 stand beside them
    entries = []
    for name in kernels:
        path = {"K4": "large", "K5": "small_train", "K6": "small_train",
                "K7": "small_train"}.get(name, "small")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[path][name], "path": path,
                 "launches_by_path": {p: launches[p][name] for p in launches},
                 "dtype": "bfloat16", **res[(name, "bfloat16")], "f32": res[(name, "float32")],
                 "tolerance": f"|kernel - plain f32| <= {ATOL}{BWD_TOL.get(name, '')} + "
                              f"{RTOL['bfloat16']} x |plain| (f32: {ATOL}{BWD_TOL.get(name, '')})"}
        if name in ("K2", "K6"):
            entry["decoder_shape"] = both(name + "dec")
        others = {key.split("@")[1] + ("_decoder" if "dec" in key else ""): both(key)
                  for key, kname, *_ in ATTENTION_SHAPES + ATTENTION_BWD_SHAPES
                  if kname == name and "@" in key}
        if name == "K4":
            others["small_train"] = both("K4@train")
        if name == "K5":
            others["large_train"] = both("K5@large")
        if others:
            entry["other_shapes"] = others
        entries.append(entry)
    print(json.dumps({"forward_f32": fwd, "throughput": thr, "train_f32": train}))
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
