"""Smoke run of the PyTorch/CUDA port (`lwdetr_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

1. Builds the four kernels of the eval paths (K1-K4, `lwdetr_tpu_torch/csrc/`)
   with nvcc, one process per source, all at once, and prints the
   `-Xptxas -v` register, shared-memory and spill report of every template
   case.
2. Holds each kernel against its plain PyTorch version, in f32 and bf16, at
   the shapes the 640x640 forwards give it with batch 8: K1, K2 and K3 at
   LW-DETR-small's, K1 and K2 also at large's and xlarge's (head_dim 32 and
   64), K4 at large's and xlarge's (two levels of head-major panels, 24 heads,
   4 points). It times the kernel, the plain version and, for K1/K2, one
   `F.scaled_dot_product_attention` call on the same inputs (a yardstick the
   port never calls).
3. Drives three eval forwards + `post_process` at 640x640 from
   `init_state_dict(seed=0)`, batch 8, f32: small, then xlarge, then large.
   Every launch counter is set to 0 just before a forward and read just after:
   small must launch K1 6 times, K2 7, K3 3 and K4 0; xlarge and large K1 6,
   K2 7, K3 0 and K4 3. The same model forced onto the plain versions, and
   given the same two-stage proposal picks (near-tied scores may swap under
   rounding; the picks are compared on their own), gives the reference
   outputs. The bf16 model must give finite outputs. Then the bf16 throughput
   of each preset at batch 32 (`lwdetr_tpu_torch.bench`).

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
EXPECTED_LAUNCHES = {"small": {"K1": 6, "K2": 7, "K3": 3, "K4": 0},
                     "xlarge": {"K1": 6, "K2": 7, "K3": 0, "K4": 3},
                     "large": {"K1": 6, "K2": 7, "K3": 0, "K4": 3}}
REPLACES = {
    "K1": "lwdetr_tpu/ops/flash_attention.py:95 _attn_cm_allheads_bias_kernel",
    "K2": "lwdetr_tpu/ops/flash_attention.py:43 _attn_cm_kernel",
    "K3": "lwdetr_tpu/ops/deform_attn.py:444 _deform_cm_kernel",
    "K4": "lwdetr_tpu/ops/deform_attn.py:853 _sep_kernel",
}
SOURCES = {"K1": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K2": "lwdetr_tpu_torch/csrc/flash_attention.cu",
           "K3": "lwdetr_tpu_torch/csrc/deform_attn.cu",
           "K4": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu"}


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


def check_close(torch, name, dtype, out, ref):
    """max |out - ref|; raises unless every element is within ATOL + RTOL|ref|."""
    diff = (out.float() - ref).abs()
    excess = (diff - (ATOL + RTOL[dtype] * ref.abs())).max().item()
    err = diff.max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name} {dtype}: max abs err {err}, over ATOL {ATOL} + RTOL "
                             f"{RTOL[dtype]} x |plain| by {excess}")
    return err


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


def compare_deform_sep(torch, da, measure_ms, dtype):
    """K4 at the shapes of the large and xlarge 640x640 forwards."""
    dt = getattr(torch, dtype)
    B, H, D, P, Q = BATCH, 24, 16, 4, 300
    shapes = [(80, 80), (20, 20)]
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(4)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dt) for h, w in shapes]
    # about a sixth of the points fall outside [0, 1] in x or y, so some or all
    # of their corners drop out; query 0 sits on the borders, query 1 far outside
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    loc[:, 0, :, :, 0::2] = 0.0
    loc[:, 0, :, :, 1::2] = 1.0
    loc[:, 1] = loc[:, 1] * 1e6 - 3e5
    outside = ((loc < 0) | (loc > 1)).any(-1).float().mean().item()
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
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
        touched = [touched_positions(torch, loc[:, :, :, lvl], hw) for lvl, hw in enumerate(shapes)]
    # bytes the function must move for these locations: of each panel only the
    # distinct in-map corners the points name (each D channels wide), once
    # each, and never more than the panel; loc and weights in, (B, Q, C) out
    isz = vals[0].element_size()
    panel_bytes = [min(v.numel(), n * D) * isz for v, n in zip(vals, touched)]
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


def kernel_phase(torch, F, fa, da, measure_ms):
    """Every kernel against its plain version at the eval paths' shapes."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype)
        res[("K3", dtype)] = compare_deform(torch, da, measure_ms, dtype)
        res[("K4", dtype)] = compare_deform_sep(torch, da, measure_ms, dtype)
    return res


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

    def plain_attention(qkv_t, num_heads, scale=None, bias=None):
        if bias is not None:
            qkv_t = qkv_t + bias.to(qkv_t.dtype)[:, None]
        return fa.attention_cm_plain(qkv_t, num_heads, scale)

    with mock.patch.object(fa, "attention_cm", plain_attention), \
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
               "K3": da.deform_attn_cm_kernel, "K4": da.deform_attn_sep_kernel}

    build_kernels()
    res = kernel_phase(torch, F, fa, da, measure_ms)
    launches, fwd, thr = {}, {}, {}
    for preset in EXPECTED_LAUNCHES:
        launches[preset], fwd[preset] = forward_phase(torch, fa, da, list(kernels.values()), preset)
    for preset in EXPECTED_LAUNCHES:
        thr[preset] = bench.run(preset, batch=32)
        log(f"{preset}@640 bf16 throughput: {thr[preset]['value']} img/s at batch 32 "
            f"({thr[preset]['ms_per_batch']} ms)")

    def both(key):
        return {"bfloat16": res[(key, "bfloat16")], "float32": res[(key, "float32")]}

    # each kernel's headline numbers are bf16 at the first path that runs it
    # (small for K1-K3, large for K4); its other shapes and f32 stand beside them
    entries = []
    for name in kernels:
        path = "large" if name == "K4" else "small"
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[path][name], "path": path,
                 "launches_by_path": {p: launches[p][name] for p in launches},
                 "dtype": "bfloat16", **res[(name, "bfloat16")], "f32": res[(name, "float32")],
                 "tolerance": f"|kernel - plain f32| <= {ATOL} + {RTOL['bfloat16']} x |plain| "
                              f"(f32: {ATOL})"}
        if name == "K2":
            entry["decoder_shape"] = both("K2dec")
        others = {key.split("@")[1] + ("_decoder" if "dec" in key else ""): both(key)
                  for key, kname, *_ in ATTENTION_SHAPES if kname == name and "@" in key}
        if others:
            entry["other_shapes"] = others
        entries.append(entry)
    print(json.dumps({"forward_f32": fwd, "throughput": thr}))
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
