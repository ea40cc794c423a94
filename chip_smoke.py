"""Smoke run of the PyTorch/CUDA port (`lwdetr_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout, with one card:

    python3 chip_smoke.py

1. Builds the kernels of the eval and train paths (K1-K10, twelve entry
   symbols in eight sources of `lwdetr_tpu_torch/csrc/`) with nvcc, one
   process per source, all at once, and prints the `-Xptxas -v` register,
   shared-memory and spill report of every template case.
2. Holds each kernel against its plain PyTorch version, in f32 and bf16, at
   every shape a 640x640 path gives it (eval batch 8, train batch 4): K1 and
   K2 at small's, large's and xlarge's (head_dim 16, 32, 64; medium's are
   large's and small's), with one `F.scaled_dot_product_attention` call timed
   on the same inputs (a yardstick the port never calls; `sdpa_ratio`), the
   registers and spilled bytes of the case that ran, and K2's log-sum-exp
   against the plain one; the samplers on one set of inputs (border and
   far-outside queries included) in their three layouts: K3 (channel-major) at
   small's and tiny's eval forward, tiny's "cm" train step and large's two
   levels, K4 (panels) at large's two levels and at small's and tiny's train
   step, K5 at small's, tiny's and large's train shape, K8 at tiny's 1300 and
   small's 3900 train queries and at large's two levels, K3 and K8 also on
   every route of `csrc/deform_cm.cuh` (1001 queries, Q = 1, a map of no
   multiple of 16 bytes, head_dim 32), each with the route its source chose
   (shared bytes, CTAs a map, registers, local bytes), K10 (row-major)
   forward and backward at
   tiny's eval and train shapes, K4 and K10 also at Q = 1001, Q = 1, head_dim
   32 and 64 and four levels, with points on grid lines, far outside and NaN,
   each with its route (work order, tile, threads, shared bytes, registers;
   any local byte fails), each with its call and CUDA-graph device times
   and the reference's F.grid_sample formulation timed on the same values (its
   backward for K5, K8, K10b; a yardstick the port never calls); K6 and K7 at
   small's and medium's train step
   (K6 also at head_dim 64), in bf16 against `bf16_bwd_error_bound`, with
   SDPA's backward, the CUDA-graph device times and the registers and spills
   of every pass beside them; K9 (the short attention
   without a bias) at tiny's decoder, batch 8 and 13 groups x 4, with K2 and
   SDPA on the same inputs, and its backward with SDPA's beside it.
3. Drives five eval forwards + `post_process` at 640x640 from
   `init_state_dict(seed=0)`, batch 8, f32: small, then xlarge, large, tiny
   (100 queries) and medium (ViT-small on P4).
   Every launch counter is set to 0 just before a forward and read just after:
   small and medium must launch K1 6 times, K2 7, K3 3 and K4 0; xlarge and
   large K1 6, K2 7, K3 0 and K4 3; tiny K1 3, K2 3, K9 3 and K3 3; no other
   kernel. The same model forced onto the plain versions, and given the same
   two-stage proposal picks (near-tied scores may swap under rounding; the
   picks are compared on their own), gives the reference outputs. The same
   weights in bf16 (float32 parameters, bf16 compute) launch the same
   kernels and, with the same picks, agree with their forward on the plain
   versions over all queries within the bf16 drift ceiling, with float32
   boxes. Then the bf16 throughput of each preset at batch 32
   (`lwdetr_tpu_torch.bench`).
4. Drives the train step of LW-DETR-small at 640x640, f32, batch 4, on one
   synthetic batch with 7 boxes an image: one step's gradients through the
   kernels against the same forward with the plain backward versions, per
   parameter tensor, and against the whole step on the plain versions
   (proposal picks and matching replayed); the launch counts of that step
   (K1 6, K2 7, K3 0, K4 3, K5 3, K6 7, K7 6); 8 steps with the release
   optimizer settings (finite losses that fall, an EMA that moves); then the
   step time, img/s, the matcher's host time per step and peak device memory.
5. Drives the train step of LW-DETR-tiny the same way in each branch of the
   decoder's cross-attention: the default (panels: K1 3, K2 3, K9 3, K4 3,
   K5 3, K6 3, K7 3 with a bias and 3 without), `force_branch="cm"` (K3 3,
   K8 3 in place of K4, K5) and `"gather"` (K10 3 forward, 3 backward). The
   three losses must agree within 1e-4; the default branch takes the
   optimizer steps, and every branch's step is timed. Each branch logs the
   error of every `sampling_offsets.weight` gradient (the first that the
   samplers' d(loc) feeds) against the plain backwards on the same forward.
6. Drives the train step of LW-DETR-medium (ViT-small, head_dim 32) as
   small's: the same launch counts, 4 optimizer steps.

Any failure exits non-zero. Without a CUDA card, or outside a checkout, it
exits non-zero and prints no result. The line before the last holds one JSON
object with every kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import sys
from types import SimpleNamespace
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
# The bf16 attention kernels (K1, K2, K9) also round the softmax weights p to
# bf16 before PV, as the JAX kernels do: they are held to
# `flash_attention.bf16_error_bound`, ATOL + 2^-8 |plain| + 2^-8
# plain(q, k, |v|), against the plain version that rounds alike (and, beside
# it, against the f32 plain version on the same bf16 values).
ATOL = 2e-5
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -8}
# The bf16 samplers K3, K4, K10 and the backwards K5 and K8 (its d(value))
# round where the JAX kernels round (`ops/deform_attn.py`, "bf16"), as their plain versions on the same
# bf16 values do: held to those within ATOL + one bf16 ulp (2^-7 |plain|), as a
# sum in another f32 order may tip a rounding; K5's bf16 d(loc) and d(weights)
# within `sep_panels_bwd_bf16_bound` (one ulp of each bf16 weight gradient).
SAMPLER_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
ROUNDED_AS_JAX = ("K3", "K4", "K10")
SAMPLER_BF16_TOL = (f"bf16: |kernel - plain bf16| <= {ATOL} (x max(1, max |plain|), x 4 on "
                    "d(value)) + 2^-7 x |plain|, the plain version on the same bf16 values "
                    "rounding where the JAX kernel does; K5's d(loc), d(weights) + "
                    "sep_panels_bwd_bf16_bound; f32: as the other samplers")
ATTENTION_BF16_TOL = ("|kernel - plain| <= 2e-5 + 2^-8 |plain| + 2^-8 plain(q, k, |v|), plain "
                      "rounding p to bf16 before PV (and f32 plain on the same values); f32: 2e-5")
# the bf16 attention backwards (K6, K7, K7nb) round ds and p to bf16 before
# their products, as the JAX kernels do: `flash_attention.bf16_bwd_error_bound`
ATTENTION_BWD_BF16_TOL = ("|kernel - plain| <= 2e-5 max(1, max |plain|) + ulp(plain) + 2^-8 "
                          "[sum |ds| |k|, sum |ds| |q|, sum p |d(out)|], plain rounding ds and p "
                          "to bf16 before the products (and f32 plain on the same values); "
                          "f32: 2e-5 x max(1, max |plain|)")
# K2's row log-sum-exp (log2 units) against the plain one from the f32 scores
LSE_ATOL, LSE_RTOL = 2e-5, 2.0 ** -8
# bf16 eval forward, kernels vs plain versions with the same picks, over all
# queries: the JAX package's own bf16-vs-f32 drift ceiling
# (tests/test_micro_map_golden.py::test_bf16_forward_drift_vs_f32)
BF16_DRIFT = {"prob_mean": 0.01, "prob_max": 0.2, "box_mean": 0.03}
# whole 640x640 forward, kernels vs plain versions, f32: ~20 layers of
# f32 sums in another order. On an H100 the three presets read 1.6e-5 to
# 3.1e-5 on the logits and 1.5e-6 to 4.7e-6 on the boxes (the largest on
# large); the bounds leave two orders of magnitude for other cards and
# library versions, and a dropped key tile or a wrong corner moves the
# logits by 1e-1 or more
FWD_ATOL_LOGITS = 2e-3
FWD_ATOL_BOXES = 5e-4
MIN_TOPK_OVERLAP = 0.98  # of the 300 (tiny: 100) picks / (query, label) pairs per image

BATCH = 8
KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K7nb", "K8", "K9", "K10", "K10b")
BACKWARD_KERNELS = ("K5", "K6", "K7", "K7nb", "K8", "K10b")
# the keys every entry of the kernels line carries
CONTRACT_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                 "bound_ms", "bound_by", "library_ms")


def launch_counts(**counts):
    """Expected launches of every kernel: those given, 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


# launches per forward: 6 window blocks; 4 global blocks + 3 decoder
# self-attentions; 3 decoder cross-attentions, from channel-major values below
# 4096 memory positions (small: 1600) and from panels above (P3 + P5: 6800).
# tiny has 3 window and 3 global blocks, and its decoder's self-attention over
# 100 queries takes the short kernel without a bias (K9). No eval forward
# launches a backward kernel.
EXPECTED_LAUNCHES = {"small": launch_counts(K1=6, K2=7, K3=3),
                     "xlarge": launch_counts(K1=6, K2=7, K4=3),
                     "large": launch_counts(K1=6, K2=7, K4=3),
                     "tiny": launch_counts(K1=3, K2=3, K9=3, K3=3),
                     "medium": launch_counts(K1=6, K2=7, K3=3)}
# one train step: the forward's launches (the decoder samples from panels in
# train mode: K4, not K3) and one backward launch for each; tiny's decoder
# folds its 13 groups of 100 queries into the batch, so K9 and the short
# backward without a bias (K7nb) take its self-attention; "cm" and "gather"
# are `force_branch` on the decoder's cross-attention
_TINY_TRAIN = dict(K1=3, K2=3, K9=3, K6=3, K7=3, K7nb=3)
TRAIN_LAUNCHES = {
    "small": launch_counts(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6),
    "medium": launch_counts(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6),
    "tiny": launch_counts(K4=3, K5=3, **_TINY_TRAIN),
    "tiny/cm": launch_counts(K3=3, K8=3, **_TINY_TRAIN),
    "tiny/gather": launch_counts(K10=3, K10b=3, **_TINY_TRAIN)}
TRAIN_BRANCHES = {"small": (None,), "tiny": (None, "cm", "gather"), "medium": (None,)}
# the release train steps of large and xlarge at batch 2, 640x640, with the
# release drop_path (0.1) at its schedule's step-0 rate: (path, preset, dtype,
# remat). Remat recomputes each ViT block's forward in the backward: K1 6 + 6,
# K2 4 + 4 + 3.
LARGE_TRAIN_BATCH = 2
LARGE_TRAIN_PATHS = (("large_train_f32", "large", "float32", False),
                     ("large_train_bf16", "large", "bfloat16", False),
                     ("xlarge_train_bf16", "xlarge", "bfloat16", False),
                     ("xlarge_train_f32", "xlarge", "float32", False),
                     ("xlarge_train_f32_remat", "xlarge", "float32", True))
_RELEASE_TRAIN = dict(K1=6, K2=7, K4=3, K5=3, K6=7, K7=6)
TRAIN_LAUNCHES.update({"large": launch_counts(**_RELEASE_TRAIN),
                       "xlarge": launch_counts(**_RELEASE_TRAIN),
                       "xlarge/remat": launch_counts(**dict(_RELEASE_TRAIN, K1=12, K2=11))})
# bf16 step, backward kernels vs the plain bf16 backwards on one bf16 forward,
# per parameter tensor (max |difference| over the tensor's max |gradient|,
# floored as in f32): every backward kernel lies within a bf16 ulp or two of
# its plain version (`bf16_bwd_error_bound`: an ulp of the result plus the
# rounding of p and ds at another f32 sum; the samplers: one ulp, 2^-7, and
# K5's d(loc) from one ulp of its bf16 weight gradients), and each layer behind
# them rounds the difference it is handed to bf16 again. A bias gradient sums
# such differences over every token of the batch, and where its terms cancel
# the difference grows against its value: the worst tensor is held to 2^-3,
# the median one to 2^-6 (two ulps); on an H100 the worst tensor read 0.021 /
# 0.062 (large / xlarge, block 0's v_bias), the median 0.004 / 0.005 (PERF.md),
# and the JAX package's own bf16 step lies 0.79 / 0.18 (worst / median tensor)
# from its f32 step at the reduced size of tests/test_torch_port_drop.py. Trap (a): a
# gradient that is zero in exact arithmetic (the bias of each projector tap's
# last resampling layer, whose per-channel constant the C2f's 1x1 convolution
# and train-mode BatchNorm remove) is rounding noise on both sides; in bf16
# that noise reaches the tensor's own size, so those tensors are held to one
# bf16 ulp of the largest gradient of all instead (f32 keeps GRAD_FLOOR).
BF16_TRAIN_GRAD_RTOL = 2.0 ** -3
BF16_TRAIN_GRAD_MEDIAN = 2.0 ** -6
BF16_ZERO_GRAD_ATOL = 2.0 ** -8


def exact_zero_grads(model):
    """Trap (a)'s tensors: the bias of the last layer of each projector tap's
    resampling (its output goes, concatenated, through the C2f's 1x1
    convolution into a train-mode BatchNorm)."""
    names = set()
    for si, stage in enumerate(model.backbone[0].projector.stages_sampling):
        for ti, seq in enumerate(stage):
            if len(seq) and getattr(seq[-1], "bias", None) is not None:
                names.add(f"backbone.0.projector.stages_sampling.{si}.{ti}.{len(seq) - 1}.bias")
    return names
TRAIN_BATCH = 4
TRAIN_STEPS = {"small": 8, "tiny": 6, "medium": 4}
BRANCH_LOSS_ATOL = 1e-4  # one function from three value layouts
# how the backward kernels' absolute bound scales (see `grad_scale`)
_SCATTER_TOL = " x max(1, max |plain|), x 4 on d(value) for the order of its additions"
BWD_TOL = {"K5": _SCATTER_TOL, "K8": _SCATTER_TOL, "K10b": _SCATTER_TOL,
           "K6": " x max(1, max |plain|)", "K7": " x max(1, max |plain|)",
           "K7nb": " x max(1, max |plain|)"}
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
    "K7nb": "lwdetr_tpu/ops/flash_attention.py:347 _attn_cm_bwd_allheads_kernel",
    "K8": "lwdetr_tpu/ops/deform_attn.py:480 _dvalue_cm_kernel",
    "K9": "lwdetr_tpu/ops/flash_attention.py:88 _attn_cm_allheads_kernel",
    "K10": "lwdetr_tpu/ops/deform_attn.py:149 _deform_kernel",
    "K10b": "lwdetr_tpu/ops/deform_attn.py:213 _dvalue_kernel",
}
ALSO_REPLACES = {"K8": "lwdetr_tpu/ops/deform_attn.py:509 _dweight_cm_kernel",
                 "K10b": "lwdetr_tpu/ops/deform_attn.py:243 _dweight_kernel"}
SOURCES = {"K1": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K2": "lwdetr_tpu_torch/csrc/flash_attention.cu",
           "K3": "lwdetr_tpu_torch/csrc/deform_attn.cu",
           "K4": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu",
           "K5": "lwdetr_tpu_torch/csrc/deform_attn_sep_bwd.cu",
           "K6": "lwdetr_tpu_torch/csrc/flash_attention_bwd.cu",
           "K7": "lwdetr_tpu_torch/csrc/window_attention_bwd.cu",
           "K7nb": "lwdetr_tpu_torch/csrc/window_attention_bwd.cu",
           "K8": "lwdetr_tpu_torch/csrc/deform_attn_bwd.cu",
           "K9": "lwdetr_tpu_torch/csrc/window_attention.cu",
           "K10": "lwdetr_tpu_torch/csrc/deform_attn_sep.cu",
           "K10b": "lwdetr_tpu_torch/csrc/deform_attn_sep_bwd.cu"}


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


def check_close(torch, name, dtype, out, ref, atol_scale=1.0, rtol=None, bound=None):
    """max |out - ref|; raises unless every element is within ATOL x atol_scale +
    rtol |ref| (default RTOL[dtype]) + `bound` (an elementwise tensor, or 0)."""
    diff = (out.float() - ref).abs()
    atol = ATOL * atol_scale
    rtol = RTOL[dtype] if rtol is None else rtol
    excess = (diff - (atol + rtol * ref.abs() + (0.0 if bound is None else bound))).max().item()
    err = diff.max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name} {dtype}: max abs err {err}, over ATOL {atol} + RTOL "
                             f"{rtol} x |plain|{'' if bound is None else ' + bound'} by {excess}")
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


def check_bound(torch, name, out, ref, bound):
    """max |out - ref|; raises unless every element is within `bound`."""
    diff = (out.float() - ref).abs()
    excess = (diff - bound).max().item()
    if not torch.isfinite(out).all() or excess > 0:
        raise AssertionError(f"{name}: max abs err {diff.max().item()}, over its bound by {excess}")
    return diff.max().item()


def compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype):
    """Kernel vs plain (and SDPA) on one attention shape; returns the numbers.
    `ms` is the time of back-to-back calls, host work included; `device_ms`
    the time of the same calls replayed from a CUDA graph, the device's alone
    (the two part where the wrapper's host time exceeds the kernel's)."""
    import math

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C)
    D = C // heads
    kernel_obj = {"K1": fa.window_attention_bias_kernel, "K2": fa.flash_attention_cm_kernel,
                  "K9": fa.window_attention_kernel}[name]
    if bias:
        kernel = lambda: fa.window_attention_bias(qkv, b, heads, scale)  # noqa: E731
        # the panel the kernel attends over: in bf16 one rounding of x + bf16(b)
        # (`attention_cm`'s CPU path and the JAX kernel), in f32 the f32 sum
        panel = qkv + b.to(dt)[:, None]
        # the plain version as `attention_cm`'s CPU path runs it, here on the card
        plain = lambda: fa.attention_cm_plain(qkv + b.to(dt)[:, None], heads, scale)  # noqa: E731
    else:
        wrapper = fa.window_attention if name == "K9" else fa.flash_attention_cm
        kernel = lambda: wrapper(qkv, heads, scale)  # noqa: E731
        panel = qkv
        plain = lambda: fa.attention_cm_plain(qkv, heads, scale)  # noqa: E731
    q, k, v = (panel.reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               for i in range(3))
    library = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        ref32 = fa.attention_cm_plain(panel.float(), heads, scale)  # f32 on the same values
        lib = library().transpose(-1, -2).reshape(B, C, N)
        torch.cuda.synchronize()
        tag = f"{name} {dtype} {tuple(qkv.shape)}"
        if dtype == "bfloat16":
            ref = fa.attention_cm_plain(panel, heads, scale).float()  # p rounded to bf16
            err = check_bound(torch, tag, out, ref, fa.bf16_error_bound(panel, heads, scale, ref))
            err32 = check_bound(torch, tag + " vs f32 plain", out, ref32,
                                fa.bf16_error_bound(panel, heads, scale, ref32))
        else:
            ref = ref32
            err = err32 = check_close(torch, tag, dtype, out, ref)
        lib_err = (lib.float() - ref32).abs().max().item()
        lse_err = None
        if name == "K2":  # the row log-sum-exp K6 reads, log2 units, vs the f32 scores'
            out2, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
            x = panel.float().reshape(B, 3, heads, D, N)
            s = torch.einsum("bhdn,bhdm->bhnm", x[:, 0] * scale, x[:, 1])
            lse_ref = torch.logsumexp(s, dim=-1) / math.log(2.0)
            del s
            lse_err = check_bound(torch, tag + " lse", lse, lse_ref,
                                  LSE_ATOL + LSE_RTOL * lse_ref.abs())
            if not torch.equal(out2, out):
                raise AssertionError(f"{tag}: writing the log-sum-exp changed the output")
        attrs = fa.kernel_attributes(kernel_obj, qkv, heads)
        ms = measure_ms(kernel)["ms"]
        device_ms = measure_graph_ms(kernel)["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
        library_ms = measure_ms(library)["ms"]
        library_device_ms = measure_graph_ms(library)["ms"]
        # the long-sequence kernel on the short kernel's inputs: what the decoder ran before K9
        k2 = lambda: fa.flash_attention_cm(qkv, heads, scale)  # noqa: E731
        k2_ms = measure_ms(k2)["ms"] if name == "K9" else None
        k2_device_ms = measure_graph_ms(k2)["ms"] if name == "K9" else None
    isz = qkv.element_size()
    nbytes = B * 4 * C * N * isz + (3 * C * 4 if bias else 0)
    flops = 4 * B * heads * N * N * D
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype)
    log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}; sdpa vs f32 plain {lib_err:.3g}"
        + (f"; lse {lse_err:.3g}" if lse_err is not None else "") + f") ms {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa {library_ms:.4f} (x{ms / library_ms:.2f}); device (graph) {device_ms:.4f}"
        f" sdpa {library_device_ms:.4f} "
        + (f"K2 {k2_ms:.4f} / {k2_device_ms:.4f} " if k2_ms is not None else "")
        + f"bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items())
        + f"); {attrs['registers']} registers, {attrs['spill_bytes']} spilled bytes")
    res = {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms, "sdpa_ratio": ms / library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms,
           "sdpa_ratio_device": device_ms / library_device_ms,
           "registers": attrs["registers"], "spill_bytes": attrs["spill_bytes"],
           "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}
    if lse_err is not None:
        res["lse_max_abs_err"] = lse_err
    if k2_ms is not None:
        res["k2_ms_same_inputs"] = k2_ms
        res["k2_device_ms_same_inputs"] = k2_device_ms
    return res


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


# sampler shapes: (B, heads, head_dim, points, queries, levels)
SEP_SMALL = (BATCH, 16, 16, 2, 300, [(40, 40)])                 # small's eval forward
SEP_LARGE = (BATCH, 24, 16, 4, 300, [(80, 80), (20, 20)])       # large / xlarge eval
SEP_SMALL_TRAIN = (4, 16, 16, 2, 3900, [(40, 40)])              # small's train step, batch 4
SEP_LARGE_TRAIN = (BATCH, 24, 16, 4, 3900, [(80, 80), (20, 20)])  # large with 13 query groups
SEP_TINY_TRAIN = (4, 16, 16, 2, 1300, [(40, 40)])               # tiny's train step, batch 4
SEP_TINY = (BATCH, 16, 16, 2, 100, [(40, 40)])                  # tiny's eval forward
# large's and xlarge's train step at their release batch of 2
SEP_LARGE_TRAIN_B2 = (LARGE_TRAIN_BATCH, 24, 16, 4, 3900, [(80, 80), (20, 20)])
# head dims 8 (the micro fixture's cross-attention) and 64 of the panel and
# row-major backwards (K5, K10b), and 24, a multiple of 8 but no power of two
SEP_BWD_CHECKS = (("d8", (2, 8, 8, 4, 60, [(16, 16), (4, 4)])),
                  ("d64", (2, 4, 64, 3, 77, [(20, 20), (10, 10)])),
                  ("d24", (2, 4, 24, 2, 33, [(12, 10)])))
# the channel-major pair's other routes (`csrc/deform_cm.cuh`): tiny's train map
# with a Q that no CTA's query slice divides; Q = 1; a map of 840 bytes in bf16,
# no multiple of 16 (copied element by element); D = 32 (f32: 205 KB, device memory)
CM_Q1001 = (4, 16, 16, 2, 1001, [(40, 40)])
CM_Q1 = (2, 2, 16, 1, 1, [(5, 7)])
CM_ODD_MAP = (2, 3, 12, 2, 37, [(5, 7)])
CM_D32 = (4, 8, 32, 2, 300, [(40, 40)])
CM_CHECKS = (("q1001", CM_Q1001), ("q1", CM_Q1), ("odd_map", CM_ODD_MAP), ("d32", CM_D32))
# K4 and K10 beyond the paths' shapes, each in both layouts, with points on
# grid lines (pixel centres), far outside and NaN besides the borders: a Q
# that no query tile divides; Q = 1; head_dim 32 and 64 (3 points a level: 6
# a (q, h), padded to 8); four levels (kMaxLevels, 16 points a (q, h))
SEP_CHECKS = (("q1001", CM_Q1001), ("q1", CM_Q1), ("d32", CM_D32),
              ("d64", (2, 4, 64, 3, 77, [(20, 20), (10, 10)])),
              ("d8", (2, 8, 8, 4, 60, [(16, 16), (4, 4)])),
              ("four_levels", (2, 8, 16, 4, 150, [(40, 40), (20, 20), (10, 10), (5, 5)])))


def sep_inputs(torch, dt, shape, seed=4, special=False):
    """Values, locations, softmax weights and d(out) at `shape`. With
    `special`, some points also lie on grid lines (the pixel centres of the last
    five queries) and one is NaN (query 2): its plain reference takes it as a
    point far outside (`torch.nan_to_num`)."""
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dt) for h, w in shapes]
    # about a sixth of the points fall outside [0, 1] in x or y, so some or all
    # of their corners drop out; query 0 sits on the borders, query 1 far outside
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    if special:
        n = min(Q, 5)
        for lvl, (h, w) in enumerate(shapes):
            for axis, size in ((0, w), (1, h)):
                pick = torch.randint(0, size, (B, n, H, P), generator=g, device="cuda")
                loc[:, Q - n:, :, lvl, :, axis] = (pick.float() + 0.5) / size
        if Q > 2:
            loc[:, 2, 0, 0, 0, 0] = float("nan")
    loc[:, 0, :, :, 0::2] = 0.0
    loc[:, 0, :, :, 1::2] = 1.0
    if Q > 1:
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


def as_layout(torch, da, layout, vals, shapes, dout):
    """The same values in one of the samplers' three layouts, with that
    layout's wrappers: `value` is the list of panels ("panels": K4 / K5), one
    row-major tensor (B, Len_in, H, D) ("rowmajor": K10) or one channel-major
    tensor (B, C, Len_in), whose output and d(out) are (B, C, Q) ("cm": K3 / K8)."""
    B, H = vals[0].shape[:2]
    D = vals[0].shape[3] // shapes[0][1]
    if layout == "panels":
        return SimpleNamespace(
            value=vals, dout=dout,
            fwd=lambda v, l, a: da.ms_deform_attn_sep_panels(v, shapes, l, a),
            fwd_plain=lambda v, l, a: da.ms_deform_attn_sep_panels_plain(v, shapes, l, a),
            bwd=lambda v, l, a, g: da.ms_deform_attn_sep_panels_bwd(v, shapes, l, a, g),
            bwd_plain=lambda v, l, a, g: da.ms_deform_attn_sep_panels_bwd_plain(v, shapes, l, a, g))
    rows = torch.cat([v.reshape(B, H, -1, D) for v in vals], dim=2)  # (B, H, Len_in, D)
    if layout == "rowmajor":
        return SimpleNamespace(
            value=rows.transpose(1, 2).contiguous(), dout=dout,
            fwd=lambda v, l, a: da.ms_deform_attn(v, shapes, l, a),
            fwd_plain=lambda v, l, a: da.ms_deform_attn_plain(v, shapes, l, a),
            bwd=lambda v, l, a, g: da.ms_deform_attn_bwd(v, shapes, l, a, g),
            bwd_plain=lambda v, l, a, g: da.ms_deform_attn_bwd_plain(v, shapes, l, a, g))
    return SimpleNamespace(
        value=rows.transpose(2, 3).reshape(B, H * D, -1).contiguous(),
        dout=dout.transpose(1, 2).contiguous(),
        fwd=lambda v, l, a: da.ms_deform_attn_cm(v, shapes, l, a, H),
        fwd_plain=lambda v, l, a: da.ms_deform_attn_cm_plain(v, shapes, l, a, H),
        bwd=lambda v, l, a, g: da.ms_deform_attn_cm_bwd(v, shapes, l, a, g, H),
        bwd_plain=lambda v, l, a, g: da.ms_deform_attn_cm_bwd_plain(v, shapes, l, a, g, H))


def tensors(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def to_f32(x):
    return [t.float() for t in x] if isinstance(x, (list, tuple)) else x.float()


def grid_sample_sampler(torch, F, maps, loc, w):
    """The reference's own PyTorch formulation of the sampling
    (`ms_deform_attn_core_pytorch`): F.grid_sample(mode='bilinear',
    padding_mode='zeros', align_corners=False) per level, times the weights,
    summed; maps[l] (B H, D, H_l, W_l) -> (B, Q, H D). A yardstick the port
    never calls."""
    B, Q, H, L, P, _ = loc.shape
    grids = (2 * loc - 1).to(maps[0].dtype)
    out = 0
    for lvl, v in enumerate(maps):
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (B H, Q, P, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
        wl = w[:, :, :, lvl].transpose(1, 2).flatten(0, 1)[:, None].to(v.dtype)  # (B H, 1, Q, P)
        out = out + (s * wl).sum(-1)  # (B H, D, Q)
    return out.reshape(B, -1, Q).transpose(1, 2)


def library_sampler(torch, F, measure_ms, vals, shapes, loc, w, dout, backward, iters):
    """Call time of `grid_sample_sampler` on the panels' values (its backward
    through torch.autograd.grad, the forward outside the timing), and its max
    abs difference from the f32 plain forward (`ref`, given by the caller)."""
    B, H = vals[0].shape[:2]
    D = vals[0].shape[3] // shapes[0][1]
    maps = [v.reshape(B, H, h, wd, D).permute(0, 1, 4, 2, 3).reshape(B * H, D, h, wd).contiguous()
            for v, (h, wd) in zip(vals, shapes)]
    if not backward:
        with torch.no_grad():
            return measure_ms(lambda: grid_sample_sampler(torch, F, maps, loc, w),
                              iters=iters)["ms"]
    leaves = [m.detach().requires_grad_() for m in maps] + [loc.detach().requires_grad_(),
                                                           w.detach().requires_grad_()]
    out = grid_sample_sampler(torch, F, leaves[:-2], leaves[-2], leaves[-1])
    g = dout.to(out.dtype)
    return measure_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True),
                      iters=iters)["ms"]


def sampler_route(da, name, layout, value, shape):
    """The route K3 or K8 takes on the channel-major `value`, or K4 or K10 at
    `shape`, as the kernel's source chooses it (None for the backwards of the
    other layouts). K4 and K10 must keep no stack and spill nothing."""
    B, H, D, P, Q, shapes = shape
    if layout == "cm":
        kernel = da.deform_attn_cm_kernel if name == "K3" else da.deform_attn_cm_bwd_kernel
        return da.cm_route(kernel, value, Q, H)
    if name not in ("K4", "K10"):
        return None
    kernel = da.deform_attn_sep_kernel if name == "K4" else da.deform_attn_rowmajor_kernel
    route = da.sep_route(kernel, B, Q, H, D, len(shapes), P, tensors(value)[0].dtype)
    if route["local_bytes"]:
        raise AssertionError(f"{name} at {shape}: {route['local_bytes']} local bytes a thread")
    return route


def route_note(route):
    if not route:
        return ""
    if "work_order" in route:
        return (f"; route: {route['work_order']}, tile {route['queries_a_cta']} queries x "
                f"{route['heads_a_cta']} heads, {route['threads']} threads a CTA, "
                f"{route['ctas']} CTAs, {route['channels_a_thread']} channels a thread, "
                f"{route['points_in_flight']} points in flight, {route['shared_bytes']} shared "
                f"bytes, {route['registers']} registers, {route['local_bytes']} local bytes")
    return (f"; route: {route['route']}, {route['shared_bytes']} shared bytes, no cluster, "
            f"{route['ctas_per_map']} CTAs a map of {route['threads']} threads, "
            f"{route['registers']} registers, {route['local_bytes']} local bytes")


def compare_deform_sep(torch, da, measure_ms, dtype, shape, name="K4",
                       layout="panels", special=False):
    """A sampler's forward against its plain version at `shape`: K4 on panels,
    K10 on the row-major and K3 on the channel-major layout of the same values
    (`special`: points on grid lines and NaN too, see `sep_inputs`); call and
    device (CUDA-graph) times, and the reference's grid_sample formulation on
    the same values beside them."""
    import torch.nn.functional as F

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, dout, outside = sep_inputs(torch, dt, shape, special=special)
    lay = as_layout(torch, da, layout, vals, shapes, dout)
    value = lay.value
    kernel = lambda: lay.fwd(value, loc, w)  # noqa: E731
    plain = lambda: lay.fwd_plain(value, loc, w)  # noqa: E731
    with torch.no_grad():
        out = kernel()
        clean = torch.nan_to_num(loc, nan=-5.0)
        if dtype == "bfloat16" and name in ROUNDED_AS_JAX:  # the plain version rounding alike
            ref = lay.fwd_plain(value, clean, w).float()
        else:
            ref = lay.fwd_plain(to_f32(value), clean, w)
        torch.cuda.synchronize()
        if out.shape != lay.dout.shape or out.dtype != dt:
            raise AssertionError(f"{name} output {tuple(out.shape)} {out.dtype}")
        err = check_close(torch, name, dtype, out, ref,
                          rtol=SAMPLER_RTOL[dtype] if name in ROUNDED_AS_JAX else None)
        # ~0.05 ms a call: 200 calls a sample, so that launch jitter averages out
        timed = measure_ms(kernel, iters=200, repeats=7)
        ms = timed["ms"]
        device_ms = measure_graph_ms(kernel)["ms"]
        plain_ms = measure_ms(plain, iters=5)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    route = sampler_route(da, name, layout, value, shape)
    library_ms = library_sampler(torch, F, measure_ms, vals, shapes, loc, w, dout, False, 20)
    # bytes the function must move for these locations: of each level only the
    # distinct in-map corners the points name (each D channels wide), once
    # each, and never more than the level; loc and weights in, (B, Q, C) out
    isz = vals[0].element_size()
    nbytes = sum(panel_bytes) + out.numel() * isz + (loc.numel() + w.numel()) * 4
    flops = 2 * 4 * B * Q * H * D * L * P  # 4 corners x (multiply + add) per output channel
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q}: {outside:.3f} "
        f"of the points outside [0, 1]; err {err:.3g} ms {ms:.4f} (samples {timed['ms_min']:.4f}-"
        f"{timed['ms_max']:.4f}) device {device_ms:.4f} plain {plain_ms:.4f} grid_sample "
        f"{library_ms:.4f} bound {bms:.4f} ({by}, {nbytes / 1e6:.1f} MB: "
        f"levels {[round(b / 1e6, 1) for b in panel_bytes]} of "
        f"{[round(v.numel() * isz / 1e6, 1) for v in vals]} MB){route_note(route)}")
    return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"], "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_bytes": nbytes, "panel_bytes_needed": panel_bytes,
            "panel_bytes": [v.numel() * isz for v in vals], "points_outside_share": outside,
            **({"kernel_route": route} if route else {})}


def compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape, name="K5", layout="panels"):
    """A sampler's backward against its plain version: d(value), d(loc) and
    d(weights) from d(out). K5 on panels, K10's backward on the row-major and
    K8 on the channel-major layout of the same values; call and device
    (CUDA-graph) times, and the backward of the reference's grid_sample
    formulation on the same values beside them."""
    import torch.nn.functional as F

    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    B, H, D, P, Q, shapes = shape
    L = len(shapes)
    vals, loc, w, dout, outside = sep_inputs(torch, dt, shape)
    lay = as_layout(torch, da, layout, vals, shapes, dout)
    sep_dout = dout
    value, dout = lay.value, lay.dout
    kernel = lambda: lay.bwd(value, loc, w, dout)  # noqa: E731
    plain = lambda: lay.bwd_plain(value, loc, w, dout)  # noqa: E731
    with torch.no_grad():
        dvals, dloc, dw = kernel()
        bloc = bw = None
        rtol = None
        if dtype == "bfloat16" and name in ("K5", "K8"):  # the plain version rounding alike
            rvals, rloc, rw = lay.bwd_plain(value, loc, w, dout)
            rvals = [rv.float() for rv in tensors(rvals)]
            if name == "K5":
                bloc, bw = da.sep_panels_bwd_bf16_bound(value, shapes, loc, w, dout)
            rtol = SAMPLER_RTOL[dtype]
        else:
            rvals, rloc, rw = lay.bwd_plain(to_f32(value), loc, w, dout.float())
        dvals, rvals = tensors(dvals), tensors(rvals)
        torch.cuda.synchronize()
        # d(value): up to hundreds of f32 additions per position, in an order
        # that changes from run to run: 4 x the f32 bound of the other outputs
        err = max(check_close(torch, f"{name} d(value {i})", dtype, dv, rv, 4.0 * grad_scale(rv),
                              rtol=rtol)
                  for i, (dv, rv) in enumerate(zip(dvals, rvals)))
        err_loc = check_close(torch, f"{name} d(loc)", "float32", dloc, rloc, grad_scale(rloc),
                              bound=bloc)
        err_w = check_close(torch, f"{name} d(weights)", "float32", dw, rw, grad_scale(rw),
                            bound=bw)
        untouched = sum(int(((rv == 0) & (dv.float() != 0)).sum()) for dv, rv in zip(dvals, rvals))
        if untouched:
            raise AssertionError(f"{name}: {untouched} positions no point touches got a gradient")
        iters = 200 if Q * L * P * B < 1e5 else 50
        timed = measure_ms(kernel, iters=iters, repeats=5)
        ms = timed["ms"]
        device_ms = measure_graph_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
        panel_bytes = sep_panel_bytes(torch, vals, loc, shapes, D)
    route = sampler_route(da, name, layout, value, shape)
    library_ms = library_sampler(torch, F, measure_ms, vals, shapes, loc, w, sep_dout, True,
                                 min(iters, 20))
    # bytes: the corners the points name and d(out), loc, weights in; every
    # d(value) position (touched or zero), d(loc) and d(weights) out
    isz = vals[0].element_size()
    nbytes = (sum(panel_bytes) + dout.numel() * isz + (loc.numel() + w.numel()) * 4
              + sum(v.numel() for v in vals) * isz + (loc.numel() + w.numel()) * 4)
    flops = 2 * 2 * 4 * B * Q * H * D * L * P  # per corner and channel: a dot term and an add
    bms, by, _ = bound_ms(nbytes, flops, 0, dtype)
    adds = B * Q * H * L * P * 4 * D
    log(f"{name} {dtype} {layout} {[tuple(v.shape) for v in tensors(value)]} Q {Q} P {P}: "
        f"{outside:.3f} of the points outside [0, 1]; err d(value) {err:.3g} (max |plain| "
        f"{max(rv.abs().max().item() for rv in rvals):.3g}) d(loc) {err_loc:.3g} d(w) {err_w:.3g} "
        f"ms {ms:.4f} (samples {timed['ms_min']:.4f}-{timed['ms_max']:.4f}) device {device_ms:.4f} "
        f"plain {plain_ms:.4f} grid_sample bwd {library_ms:.4f} bound {bms:.4f} ({by}, "
        f"{nbytes / 1e6:.1f} MB; at most {adds / 1e6:.1f} M additions into d(value))"
        f"{route_note(route)}")
    return {"shape": [list(v.shape) for v in tensors(value)] + [Q], "max_abs_err": err,
            "max_abs_err_dloc": err_loc, "max_abs_err_dweights": err_w, "ms": ms,
            "ms_min": timed["ms_min"], "ms_max": timed["ms_max"], "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "bound_bytes": nbytes, "dvalue_additions": adds, "points_outside_share": outside,
            **({"kernel_route": route} if route else {})}


def compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N, heads, scale, bias, dtype,
                          iters):
    """K6, K7 (with `bias`) or K7nb (the short backward without one) vs the plain
    backward, and SDPA's backward, on one shape: call and device (CUDA-graph)
    times, registers and spills. bf16 is held to `bf16_bwd_error_bound` against
    the plain version that rounds ds and p as the kernels do, and against the
    f32 plain version on the same values; f32 to ATOL x max(1, max |plain|)."""
    from lwdetr_tpu_torch.utils.timing import measure_graph_ms

    dt = getattr(torch, dtype)
    qkv, b = attention_inputs(torch, B, C, N, heads, dt, bias, seed=N + C + 1)
    g = torch.Generator(device="cuda").manual_seed(N)
    dout = torch.randn((B, C, N), generator=g, device="cuda").to(dt)
    D = C // heads
    kernel_obj = {"K6": fa.flash_attention_cm_bwd_kernel, "K7": fa.window_attention_bias_bwd_kernel,
                  "K7nb": fa.window_attention_bwd_kernel}[name]
    tag = f"{name} {dtype} qkv {tuple(qkv.shape)}"
    with torch.no_grad():
        if name == "K6":
            # K6 reads the row log-sum-exp that K2 saved
            _, lse = fa.flash_attention_cm_fwd(qkv, heads, scale, with_lse=True)
            kernel = lambda: fa.flash_attention_cm_bwd(qkv, lse, dout, heads, scale)  # noqa: E731
        else:
            kernel = lambda: fa.window_attention_bias_bwd(qkv, b, dout, heads, scale)  # noqa: E731
        plain = lambda: fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=b)  # noqa: E731
        # the values the kernel works on: in bf16 the panel with the bias rounded in once
        panel = qkv if b is None else qkv + b.to(dt)[:, None]
        ref32 = fa.attention_cm_bwd_plain(panel.float(), dout.float(), heads, scale)
        dqkv = kernel()
        torch.cuda.synchronize()
        if dtype == "bfloat16":
            ref = plain().float()  # ds and p rounded to bf16 before the products
            err = check_bound(torch, tag, dqkv, ref,
                              fa.bf16_bwd_error_bound(qkv, dout, heads, scale, ref, bias=b))
            err32 = check_bound(torch, tag + " vs f32 plain", dqkv, ref32,
                                fa.bf16_bwd_error_bound(qkv, dout, heads, scale, ref32, bias=b))
        else:
            ref = ref32
            err = err32 = check_close(torch, tag, dtype, dqkv, ref, grad_scale(ref))
        attrs = fa.kernel_attributes(kernel_obj, qkv, heads)
        ms = measure_ms(kernel, iters=iters)["ms"]
        device_ms = measure_graph_ms(kernel, iters=iters)["ms"]
        plain_ms = measure_ms(plain, iters=3, repeats=3)["ms"]
    # the library's backward of the same attention: the forward (and its
    # graph) is made here, outside the timing
    q, k, v = (panel.reshape(B, 3, heads, D, N)[:, i].transpose(-1, -2).contiguous()
               .requires_grad_() for i in range(3))
    do_lib = dout.reshape(B, heads, D, N).transpose(-1, -2).contiguous()
    fwd = {"o": F.scaled_dot_product_attention(q, k, v, scale=scale), "leaves": (q, k, v)}
    library = lambda: torch.autograd.grad(fwd["o"], fwd["leaves"], do_lib,  # noqa: E731
                                          retain_graph=True)
    lib = torch.stack([t.transpose(-1, -2) for t in library()], dim=1).reshape(B, 3 * C, N)
    lib_err = (lib.float() - ref32).abs().max().item()
    library_ms = measure_ms(library, iters=iters)["ms"]

    def forward_on_capture_stream():
        # fresh leaves: a leaf keeps the stream of its first forward for its
        # gradient's accumulation, and the captured backward must not leave
        # the capture stream
        fwd.clear()
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fwd["o"] = F.scaled_dot_product_attention(*leaves, scale=scale)
        fwd["leaves"] = leaves

    library_device_ms = measure_graph_ms(library, iters=iters,
                                         prepare=forward_on_capture_stream)["ms"]
    isz = qkv.element_size()
    # qkv, d(out), (K7) the bias and (K6) the log-sum-exp in; d(qkv) out
    nbytes = B * (7 * C) * N * isz
    if bias:
        nbytes += 3 * C * 4
    elif name == "K6":
        nbytes += B * heads * N * 4
    flops = 10 * B * heads * N * N * D  # five (N, N, D) products: s, dp, dq, dk, dv
    exps = B * heads * N * N
    bms, by, parts = bound_ms(nbytes, flops, exps, dtype)
    log(f"{tag}: err {err:.3g} (vs f32 plain {err32:.3g}) of max |plain| "
        f"{ref.abs().max().item():.3g} (sdpa bwd vs f32 plain {lib_err:.3g}) ms {ms:.4f} plain "
        f"{plain_ms:.4f} sdpa bwd {library_ms:.4f}; device (graph) {device_ms:.4f} sdpa "
        f"{library_device_ms:.4f} (x{device_ms / library_device_ms:.2f}) bound {bms:.4f} ({by}; "
        + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in parts.items())
        + f"); {attrs['registers']} registers, {attrs['spill_bytes']} spilled bytes"
        + (f" (passes {[(p['registers'], p['spill_bytes']) for p in attrs['passes']]})"
           if "passes" in attrs else ""))
    res = {"shape": list(qkv.shape), "max_abs_err": err, "max_abs_err_vs_f32_plain": err32,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms, "device_ms": device_ms,
           "library_device_ms": library_device_ms,
           "sdpa_ratio_device": device_ms / library_device_ms,
           "registers": attrs["registers"], "spill_bytes": attrs["spill_bytes"],
           "bound_parts_ms": {k: v * 1e3 for k, v in parts.items()}}
    if "passes" in attrs:
        res["passes"] = attrs["passes"]
    return res


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
    ("K9", "K9", BATCH, 256, 100, 8, 32 ** -0.5, False),            # tiny's decoder: 100 queries
    ("K9@train", "K9", TRAIN_BATCH * 13, 256, 100, 8, 32 ** -0.5, False),  # 13 groups in the batch
)


# the backward shapes of one small train step at batch 4 (3900 queries in 13
# groups of 300, folded into the batch for the decoder's self-attention),
# medium's (ViT-small: head_dim 32; its decoder is small's), K6 at head_dim
# 64, and large's and xlarge's train step at batch 2 (K6, K7 at head_dim 32 /
# 64; their decoder is large's eval decoder, 13 groups a batch element):
# (key, kernel, B, C, N, heads, scale, bias, calls a sample). K7 takes 200
# calls a sample, so that host enqueue time is not in it.
ATTENTION_BWD_SHAPES = (
    ("K7", "K7", TRAIN_BATCH * 16, 192, 100, 12, 1.0, True, 200),
    ("K6", "K6", TRAIN_BATCH, 192, 1600, 12, 1.0, False, 20),
    ("K6dec", "K6", TRAIN_BATCH * 13, 256, 300, 8, 32 ** -0.5, False, 20),
    ("K6@xlarge", "K6", BATCH, 768, 1600, 12, 1.0, False, 5),
    ("K7nb", "K7nb", TRAIN_BATCH * 13, 256, 100, 8, 32 ** -0.5, False, 200),  # tiny's decoder
    ("K6@medium", "K6", TRAIN_BATCH, 384, 1600, 12, 1.0, False, 20),
    ("K7@medium", "K7", TRAIN_BATCH * 16, 384, 100, 12, 1.0, True, 200),
    ("K6@large_train", "K6", LARGE_TRAIN_BATCH, 384, 1600, 12, 1.0, False, 20),
    ("K6@xlarge_train", "K6", LARGE_TRAIN_BATCH, 768, 1600, 12, 1.0, False, 10),
    ("K7@large_train", "K7", LARGE_TRAIN_BATCH * 16, 384, 100, 12, 1.0, True, 200),
    ("K7@xlarge", "K7", LARGE_TRAIN_BATCH * 16, 768, 100, 12, 1.0, True, 200),
    ("K6dec@large_train", "K6", LARGE_TRAIN_BATCH * 13, 384, 300, 12, 32 ** -0.5, False, 20),
)


def kernel_phase(torch, F, fa, da, measure_ms):
    """Every kernel against its plain version at the eval and train paths' shapes."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        for key, name, B, C, N, heads, scale, bias in ATTENTION_SHAPES:
            res[(key, dtype)] = compare_attention(torch, F, fa, measure_ms, name, B, C, N, heads,
                                                  scale, bias, dtype)
        for key, shape in (("K3", SEP_SMALL), ("K3@tiny", SEP_TINY),
                           ("K3@tiny_train", SEP_TINY_TRAIN), ("K3@large", SEP_LARGE),
                           *((f"K3@{k}", v) for k, v in CM_CHECKS)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape, "K3", "cm")
        for key, shape in (("K4", SEP_LARGE), ("K4@train", SEP_SMALL_TRAIN),
                           ("K4@tiny_train", SEP_TINY_TRAIN), ("K4@large_train", SEP_LARGE_TRAIN_B2)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape)
        for key, name, B, C, N, heads, scale, bias, iters in ATTENTION_BWD_SHAPES:
            res[(key, dtype)] = compare_attention_bwd(torch, F, fa, measure_ms, name, B, C, N,
                                                      heads, scale, bias, dtype, iters)
        for key, shape in (("K5", SEP_SMALL_TRAIN), ("K5@large", SEP_LARGE_TRAIN),
                           ("K5@tiny_train", SEP_TINY_TRAIN), ("K5@large_train", SEP_LARGE_TRAIN_B2),
                           *((f"K5@{k}", v) for k, v in SEP_BWD_CHECKS)):
            res[(key, dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape)
        for key, shape in SEP_BWD_CHECKS:
            res[(f"K10b@{key}", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape,
                                                                 "K10b", "rowmajor")
        for key, shape in (("K8", SEP_TINY_TRAIN), ("K8@small", SEP_SMALL_TRAIN),
                           ("K8@large", SEP_LARGE_TRAIN), *((f"K8@{k}", v) for k, v in CM_CHECKS)):
            res[(key, dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype, shape,
                                                       "K8", "cm")
        for key, shape in (("K10", SEP_TINY_TRAIN), ("K10@eval", SEP_TINY)):
            res[(key, dtype)] = compare_deform_sep(torch, da, measure_ms, dtype, shape,
                                                   "K10", "rowmajor")
        for key, shape in SEP_CHECKS:
            for name, layout in (("K4", "panels"), ("K10", "rowmajor")):
                res[(f"{name}@{key}", dtype)] = compare_deform_sep(
                    torch, da, measure_ms, dtype, shape, name, layout, special=True)
        res[("K10b", dtype)] = compare_deform_sep_bwd(torch, da, measure_ms, dtype,
                                                      SEP_TINY_TRAIN, "K10b", "rowmajor")
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

    # the two-stage head picks 300 (tiny: 100) of the 1600 (P4) or 6800 (P3 + P5) proposals by score; near-tied
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
    if logits.shape != (BATCH, cfg.num_queries, 91) or boxes.shape != (BATCH, cfg.num_queries, 4):
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

    # the same weights in bf16 (the deployed precision: float32 parameters,
    # bf16 compute), with the f32 run's proposal picks (bf16 scores tie often):
    # the same launches; how far from f32 (reported: bf16 rounds at every
    # layer); and, on the same picks, the bf16 forward on the plain versions
    # (which round p as the kernels do) over all queries, within the JAX
    # package's bf16 drift ceiling, with float32 boxes
    model16 = build_model(cfg, device="cuda", dtype=torch.bfloat16,
                          state_dict=init_state_dict(cfg, seed=0))
    images16 = images.to(torch.bfloat16)
    own_picks.clear()
    for k in kernels:
        k.launches = 0
    with torch.no_grad(), mock.patch.object(tr, "select_proposals", replay):
        out16 = model16(images16)
    launches16 = {k.name: k.launches for k in kernels}
    if launches16 != EXPECTED_LAUNCHES[preset]:
        raise AssertionError(f"{preset} bf16: launches {launches16} != {EXPECTED_LAUNCHES[preset]}")
    if len(own_picks) != len(picks):
        raise AssertionError(f"bf16 forward replayed {len(own_picks)} of {len(picks)} picks")
    if not (torch.isfinite(out16["pred_logits"]).all() and torch.isfinite(out16["pred_boxes"]).all()):
        raise AssertionError("non-finite bf16 outputs")
    if out16["pred_boxes"].dtype != torch.float32 or out16["pred_logits"].dtype != torch.bfloat16:
        raise AssertionError(f"bf16 forward: boxes {out16['pred_boxes'].dtype}, logits "
                             f"{out16['pred_logits'].dtype}")
    bf16_set = min(len(set(a.tolist()) & set(b.tolist())) / a.numel()
                   for a, b in zip(picks[0], own_picks[0]))
    bf16_l = (out16["pred_logits"].float() - logits).abs().max().item()
    bf16_b = (out16["pred_boxes"].float() - boxes).abs().max().item()
    log(f"{preset}@640 bf16 forward vs f32 (f32 picks): logits max diff {bf16_l:.3g}, "
        f"boxes {bf16_b:.3g}; bf16's own picks share {bf16_set:.4f} of the f32 set")
    own_picks.clear()
    with torch.no_grad(), mock.patch.object(fa, "attention_cm", plain_attention(fa)), \
            mock.patch.object(da, "ms_deform_attn_cm", da.ms_deform_attn_cm_plain), \
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              da.ms_deform_attn_sep_panels_plain), \
            mock.patch.object(tr, "select_proposals", replay):
        ref16 = model16(images16)
    if [k.launches for k in kernels] != list(launches16.values()):
        raise AssertionError(f"{preset}: the plain bf16 forward launched a kernel")
    dp = (out16["pred_logits"].float().sigmoid() - ref16["pred_logits"].float().sigmoid()).abs()
    db = (out16["pred_boxes"] - ref16["pred_boxes"]).abs()
    drift = {"prob_mean": dp.mean().item(), "prob_max": dp.max().item(),
             "box_mean": db.mean().item()}
    log(f"{preset}@640 bf16 forward, kernels vs plain, all {cfg.num_queries} queries: " +
        ", ".join(f"{k} {v:.3g} (ceiling {BF16_DRIFT[k]})" for k, v in drift.items()) +
        f"; boxes max {db.max().item():.3g}")
    if any(v >= BF16_DRIFT[k] for k, v in drift.items()):
        raise AssertionError(f"{preset}: bf16 forward drifts from its plain versions: {drift}")
    return launches, {"logits_max_abs_err": err_l, "boxes_max_abs_err": err_b,
                      "bf16_vs_f32_logits_max_diff": bf16_l, "bf16_vs_f32_boxes_max_diff": bf16_b,
                      "bf16_own_picks_same_set_min": bf16_set,
                      "bf16_kernels_vs_plain": {**drift, "box_max": db.max().item()},
                      "topk_overlap_min": min(overlap), "proposal_picks_same_position": same_pos,
                      "proposal_picks_same_set_min": same_set}


def train_phase(torch, fa, da, kernels, measure_ms, card, preset):
    """`preset`'s f32 train step at 640x640, batch 4, in each cross-attention
    branch of TRAIN_BRANCHES: launch counts, gradients through the kernels vs the
    plain versions, the branches' losses against one another, a few optimizer
    steps in the default branch, every branch's step time. Returns
    ({path: launches}, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import transformer as tr

    state, step = bench_train.make_train_step(preset, TRAIN_BATCH, seed=0)
    model = state.model
    mcfg = model.cfg
    criterion = cm.SetCriterion(mcfg, bench_train.get_train_config(preset))
    data = bench_train.synthetic_batch(mcfg.num_classes, TRAIN_BATCH, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])
    tag = f"{preset}@640 train step"

    # (a) one forward + backward through the kernels, then (a1) the same forward
    # with each backward kernel swapped for its plain version, in every branch,
    # and (a2) the whole step on the plain versions with torch.autograd. Near-tied
    # proposal scores and matching costs can flip under f32 rounding and would
    # reseed whole queries, so every run after the first replays the first run's
    # picks (13 groups) and its matching. The step has more kinks than those: a
    # plain forward differs from the kernels' by ~1e-6, which flips ReLU units of
    # the decoder's FFN and moves sampling points across grid lines, and each
    # flip moves a gradient tensor by up to 1e-2 of its maximum. So the
    # per-tensor bound holds (a1), where both runs share one forward bit for bit,
    # and (a2) is held to the loss and to the relative L2 error over all gradients.
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

    def compare(grads_k, grads_ref, label):
        """Per tensor: max |difference| over max |reference|, with a floor of
        GRAD_FLOOR x the largest gradient of all, since some gradients are zero
        in exact arithmetic (a bias in front of a train-mode BatchNorm)."""
        top = max(g.abs().max().item() for g in grads_ref.values())
        rel = {n: ((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
               for n, g in grads_ref.items()}
        worst = max(rel, key=rel.get)
        num = sum((grads_k[n] - g).double().square().sum() for n, g in grads_ref.items())
        l2 = (num / sum(g.double().square().sum() for g in grads_ref.values())).sqrt().item()
        log(f"{tag}, kernels vs {label}, f32, batch {TRAIN_BATCH}: gradient max "
            f"rel err over {len(rel)} parameter tensors {rel[worst]:.3g} ({worst}), median "
            f"{sorted(rel.values())[len(rel) // 2]:.3g}; relative L2 error of all gradients {l2:.3g}")
        return rel[worst], worst, l2, rel

    def replay():
        return (mock.patch.object(tr, "select_proposals", replay_pick),
                mock.patch.object(cm, "hungarian_match", lambda *a, **kw: matchings[0]))

    launches, branch_res, default_grads = {}, {}, None
    for branch in TRAIN_BRANCHES[preset]:
        path = preset if branch is None else f"{preset}/{branch}"
        tr.set_force_branch(model, branch)
        first = not picks
        patches = ((mock.patch.object(tr, "select_proposals", record_pick),
                    mock.patch.object(cm, "hungarian_match", record_match)) if first else replay())
        for k in kernels:
            k.launches = 0
        with patches[0], patches[1]:
            loss_k, grads_k = grads()
        launches[path] = {k.name: k.launches for k in kernels}
        log(f"{path}@640 train step launches: {launches[path]}")
        if launches[path] != TRAIN_LAUNCHES[path]:
            raise AssertionError(f"{path} train step: launches {launches[path]} != "
                                 f"{TRAIN_LAUNCHES[path]}")
        if not all(torch.isfinite(g).all() for g in grads_k.values()):
            raise AssertionError(f"{path}: non-finite gradients")

        patches = replay()
        with patches[0], patches[1], \
                mock.patch.object(fa, "window_attention_bias_bwd",
                                  lambda qkv, bias, dout, heads, scale:
                                  fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias)), \
                mock.patch.object(fa, "flash_attention_cm_bwd",
                                  lambda qkv, lse, dout, heads, scale:
                                  fa.attention_cm_bwd_plain(qkv, dout, heads, scale)), \
                mock.patch.object(da, "ms_deform_attn_sep_panels_bwd",
                                  da.ms_deform_attn_sep_panels_bwd_plain), \
                mock.patch.object(da, "ms_deform_attn_cm_bwd", da.ms_deform_attn_cm_bwd_plain), \
                mock.patch.object(da, "ms_deform_attn_bwd", da.ms_deform_attn_bwd_plain):
            loss_b, grads_b = grads()
        if any(k.launches != launches[path][k.name] for k in kernels
               if k.name in BACKWARD_KERNELS):
            raise AssertionError(f"{path}: the step on the plain backwards launched a backward "
                                 "kernel")
        bwd_err, bwd_worst, bwd_l2, rel = compare(
            grads_k, grads_b, f"the plain backwards on the same forward ({path})")
        # the gradients that d(loc) of the samplers feeds first (trap (c))
        offsets = {n: e for n, e in rel.items() if n.endswith("sampling_offsets.weight")}
        log(f"{path}@640 sampling_offsets.weight vs the plain backwards: "
            + ", ".join(f"{n.split('.cross_attn')[0]} {e:.3g}" for n, e in offsets.items()))
        if abs(loss_b - loss_k) > 1e-6 * abs(loss_k) or bwd_err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{path}: backward kernels disagree with their plain versions: "
                                 f"{bwd_worst} {bwd_err}, loss {loss_k} vs {loss_b}")
        branch_res[path] = {"loss_kernels": loss_k, "grad_max_rel_err_plain_backwards": bwd_err,
                            "grad_worst_tensor_plain_backwards": bwd_worst,
                            "grad_rel_l2_plain_backwards": bwd_l2,
                            "sampling_offsets_weight_rel_err": offsets}
        if branch is None:
            default_grads = grads_k
        del grads_b
    tr.set_force_branch(model, None)
    branch_losses = [r["loss_kernels"] for r in branch_res.values()]
    log(f"{tag} loss by branch: " + ", ".join(f"{p} {r['loss_kernels']:.7f}"
                                               for p, r in branch_res.items()))
    if max(branch_losses) - min(branch_losses) > BRANCH_LOSS_ATOL:
        raise AssertionError(f"{preset}: the branches' losses differ: {branch_losses}")
    loss_k, grads_k = branch_res[preset]["loss_kernels"], default_grads

    before = [k.launches for k in kernels]
    n_replayed = len(replayed)
    patches = replay()
    with patches[0], patches[1], mock.patch.object(fa, "attention_cm", plain_attention(fa)), \
            mock.patch.object(da, "ms_deform_attn_sep_panels",
                              da.ms_deform_attn_sep_panels_plain):
        loss_p, grads_p = grads()
    if [k.launches for k in kernels] != before:
        raise AssertionError("the plain train step launched a kernel")
    runs = 2 * len(TRAIN_BRANCHES[preset])  # every run after the first replays
    if (len(picks) != mcfg.group_detr or len(replayed) != runs * len(picks)
            or len(matchings) != 1):
        raise AssertionError(f"{len(picks)} picks recorded, {len(replayed)} replayed, "
                             f"{len(matchings)} matchings")
    same_pick = min((a == b).float().mean().item() for a, b in zip(picks, replayed[n_replayed:]))
    log(f"{tag} loss, kernels {loss_k:.7f} vs all plain {loss_p:.7f}; the plain "
        f"forward's own picks at the same position {same_pick:.4f}")
    all_err, all_worst, all_l2, _ = compare(grads_k, grads_p,
                                            "the whole step on the plain versions")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or all_l2 > TRAIN_GRAD_L2:
        raise AssertionError(f"train step disagrees with the plain versions: loss {loss_k} vs "
                             f"{loss_p}, relative L2 error of the gradients {all_l2}")
    del grads_k, grads_p, default_grads
    model.zero_grad(set_to_none=True)

    # (c) a few steps on that batch with the release optimizer settings
    n_steps = TRAIN_STEPS[preset]
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step()["loss"]) for _ in range(n_steps)]
    log(f"{preset}@640 {n_steps} train steps, loss: " + " ".join(f"{x:.4f}" for x in losses))
    moved = max((state.ema[k] - v.detach()).abs().max().item()
                for k, v in model.named_parameters())
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if losses[-1] >= losses[0] or state.step != n_steps or moved <= 0:
        raise AssertionError(f"training made no progress: loss {losses[0]} -> {losses[-1]}, "
                             f"step {state.step}, max |ema - parameters| {moved}")

    # (d) step time after those warm-up steps, in every branch, and the matcher's host time
    timer = bench_train.HostTimer(cm.hungarian_match)
    step_ms = {}
    with mock.patch.object(cm, "hungarian_match", timer):
        for branch in TRAIN_BRANCHES[preset]:
            tr.set_force_branch(model, branch)
            path = preset if branch is None else f"{preset}/{branch}"
            step_ms[path] = measure_ms(step, iters=5, warmup=0 if branch is None else 1, repeats=3)
    tr.set_force_branch(model, None)
    t = step_ms[preset]
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    res = {"batch": TRAIN_BATCH, "launches": launches[preset], "loss_kernels": loss_k,
           "loss_plain": loss_p, **{k: v for k, v in branch_res[preset].items() if k.startswith("grad")},
           "branches": branch_res,
           "grad_max_rel_err_all_plain": all_err, "grad_worst_tensor_all_plain": all_worst,
           "grad_rel_l2_all_plain": all_l2,
           "picks_same_position_min": same_pick, "losses": losses,
           "ema_max_abs_distance": moved, "step_ms": t["ms"], "step_ms_samples": t["samples"],
           "step_ms_by_branch": {p: v["ms"] for p, v in step_ms.items()},
           "img_per_s": TRAIN_BATCH / (t["ms"] / 1e3),
           "matcher_host_ms_per_step": timer.seconds * 1e3 / timer.calls,
           "peak_memory_mb": peak, "card": card}
    print(f"{preset}@640 f32 train step, batch {TRAIN_BATCH}: {t['ms']:.3f} ms "
          f"({card}), samples {[round(x, 3) for x in t['samples']]}"
          + "".join(f"; {p} {v['ms']:.3f} ms" for p, v in step_ms.items() if p != preset))
    print(f"lwdetr_{preset}_640_f32_train_throughput: {res['img_per_s']:.3f} img/s ({card})")
    print(f"matcher host time: {res['matcher_host_ms_per_step']:.3f} ms per step ({card})")
    print(f"peak device memory over the train steps: {peak:.1f} MiB ({card})")
    return launches, res


def release_train_phase(torch, fa, da, kernels, measure_ms, card, path, preset, dtype, remat):
    """`preset`'s release train step at 640x640, batch LARGE_TRAIN_BATCH, in
    `dtype` (f32 parameters), with remat if asked: stochastic depth at the
    release rate's step-0 value, its masks drawn once and replayed; the launch
    counts; the gradients through the backward kernels against the plain
    backwards on one shared forward (picks, matching and masks replayed), per
    parameter tensor; a few steps' time and the peak device memory of a step.
    Returns (launches, numbers)."""
    from lwdetr_tpu_torch import bench_train
    from lwdetr_tpu_torch.models import criterion as cm
    from lwdetr_tpu_torch.models import drop
    from lwdetr_tpu_torch.models import transformer as tr
    from lwdetr_tpu_torch.train.optim import drop_path_rates_for, drop_scheduler

    dt = getattr(torch, dtype)
    B = LARGE_TRAIN_BATCH
    torch.cuda.empty_cache()
    state, step = bench_train.make_train_step(preset, B, seed=0, dtype=dt, grad_checkpointing=remat)
    model = state.model
    mcfg = model.cfg
    tcfg = bench_train.get_train_config(preset)
    criterion = cm.SetCriterion(mcfg, tcfg)
    data = bench_train.synthetic_batch(mcfg.num_classes, B, 640, 100, 7, "cuda", seed=0)
    targets = cm.Targets(data["labels"], data["boxes"], data["valid"])
    sched = drop_scheduler(mcfg.drop_path, tcfg.epochs, bench_train.NITER_PER_EP,
                           tcfg.cutoff_epoch, tcfg.drop_mode, tcfg.drop_schedule)
    rates = drop_path_rates_for(float(sched[0]), mcfg.vit_encoder_num_layers)
    bern = drop.Bernoulli(drop.step_generator("cuda", 0, 0))
    masks = []

    def record_mask(keep, shape, like):
        masks.append(bern(keep, shape, like))
        return masks[-1]

    select, match = tr.select_proposals, cm.hungarian_match
    picks, matchings = [], []

    def record_pick(scores, k):
        picks.append(select(scores, k))
        return picks[-1]

    def record_match(*args, **kwargs):
        matchings.append(match(*args, **kwargs))
        return matchings[-1]

    def grads(source):
        model.zero_grad(set_to_none=True)
        out = model(data["images"], rates, mcfg.dropout, source)
        total, _ = criterion(out, targets, train=True)
        total.backward()
        torch.cuda.synchronize()
        return total.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                              if p.grad is not None}

    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(tr, "select_proposals", record_pick), \
            mock.patch.object(cm, "hungarian_match", record_match):
        loss_k, grads_k = grads(record_mask)
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {k.name: k.launches for k in kernels}
    expect = TRAIN_LAUNCHES[f"{preset}/remat" if remat else preset]
    log(f"{path} launches: {launches}; {len(masks)} drop-path masks")
    if launches != expect:
        raise AssertionError(f"{path}: launches {launches} != {expect}")
    if len(masks) != 2 * (mcfg.vit_encoder_num_layers - 1):  # block 0's rate is 0
        raise AssertionError(f"{path}: {len(masks)} drop-path masks drawn")
    if not all(torch.isfinite(g).all() for g in grads_k.values()):
        raise AssertionError(f"{path}: non-finite gradients")
    fed = drop.Fed(masks)
    with mock.patch.object(tr, "select_proposals", lambda scores, k: picks.pop(0)), \
            mock.patch.object(cm, "hungarian_match", lambda *a, **kw: matchings[0]), \
            mock.patch.object(fa, "window_attention_bias_bwd",
                              lambda qkv, bias, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale, bias=bias)), \
            mock.patch.object(fa, "flash_attention_cm_bwd",
                              lambda qkv, lse, dout, heads, scale:
                              fa.attention_cm_bwd_plain(qkv, dout, heads, scale)), \
            mock.patch.object(da, "ms_deform_attn_sep_panels_bwd",
                              da.ms_deform_attn_sep_panels_bwd_plain):
        loss_b, grads_b = grads(fed)
    if picks or fed.used != len(masks):
        raise AssertionError(f"{path}: {len(picks)} picks and {len(masks) - fed.used} masks "
                             "not replayed")
    if any(k.launches != launches[k.name] for k in kernels if k.name in BACKWARD_KERNELS):
        raise AssertionError(f"{path}: the step on the plain backwards launched a backward kernel")
    top = max(g.abs().max().item() for g in grads_b.values())
    zero = exact_zero_grads(model) if dtype == "bfloat16" else set()
    rel = {n: ((grads_k[n].float() - g.float()).abs().max()
               / g.abs().max().clamp(min=GRAD_FLOOR * top)).item()
           for n, g in grads_b.items() if n not in zero}
    zero_err = max([(grads_k[n] - grads_b[n]).abs().max().item() / top for n in zero] + [0.0])
    worst = max(rel, key=rel.get)
    median = sorted(rel.values())[len(rel) // 2]
    bound = TRAIN_GRAD_RTOL if dtype == "float32" else BF16_TRAIN_GRAD_RTOL
    log(f"{path}, kernels vs the plain backwards on the same forward: gradient max rel err over "
        f"{len(rel)} tensors {rel[worst]:.3g} ({worst}), median {median:.3g} (bound {bound}); "
        f"{len(zero)} trap (a) tensors within {zero_err:.3g} of the largest gradient "
        f"(bound {BF16_ZERO_GRAD_ATOL}); loss {loss_k:.7f} vs {loss_b:.7f}")
    median_bound = BF16_TRAIN_GRAD_MEDIAN if dtype == "bfloat16" else TRAIN_GRAD_RTOL
    if (abs(loss_b - loss_k) > 1e-6 * abs(loss_k) or rel[worst] > bound
            or median > median_bound or zero_err > BF16_ZERO_GRAD_ATOL):
        raise AssertionError(f"{path}: backward kernels disagree with their plain versions: "
                             f"{worst} {rel[worst]}, trap (a) {zero_err}, loss {loss_k} vs {loss_b}")
    del grads_k, grads_b
    model.zero_grad(set_to_none=True)
    losses = [float(step()["loss"]) for _ in range(2)]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"{path}: non-finite loss {losses}")
    t = measure_ms(step, iters=3, warmup=0, repeats=2)
    res = {"batch": B, "dtype": dtype, "remat": remat, "launches": launches,
           "loss_kernels": loss_k, "grad_max_rel_err_plain_backwards": rel[worst],
           "grad_worst_tensor_plain_backwards": worst, "grad_median_rel_err": median,
           "grad_bound": bound, "grad_trap_a_err": zero_err,
           "drop_path_rate_step0": float(sched[0]),
           "masks": len(masks), "losses": losses, "step_ms": t["ms"],
           "step_ms_samples": t["samples"], "img_per_s": B / (t["ms"] / 1e3),
           "peak_memory_mb_first_step": peak_step, "card": card}
    print(f"{path}: {t['ms']:.3f} ms a step, {res['img_per_s']:.3f} img/s, peak device memory "
          f"{peak_step:.1f} MiB ({card})")
    del state, step, model
    torch.cuda.empty_cache()
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
    kernels = {k.name: k for k in (
        fa.window_attention_bias_kernel, fa.flash_attention_cm_kernel, da.deform_attn_cm_kernel,
        da.deform_attn_sep_kernel, da.deform_attn_sep_bwd_kernel,
        fa.flash_attention_cm_bwd_kernel, fa.window_attention_bias_bwd_kernel,
        fa.window_attention_bwd_kernel, da.deform_attn_cm_bwd_kernel, fa.window_attention_kernel,
        da.deform_attn_rowmajor_kernel, da.deform_attn_rowmajor_bwd_kernel)}
    if tuple(kernels) != KERNEL_NAMES:
        raise AssertionError(f"kernels {tuple(kernels)} != {KERNEL_NAMES}")

    build_kernels()
    res = kernel_phase(torch, F, fa, da, measure_ms)
    launches, fwd, thr, train = {}, {}, {}, {}
    for preset in EXPECTED_LAUNCHES:
        launches[preset], fwd[preset] = forward_phase(torch, fa, da, list(kernels.values()), preset)
    for preset in TRAIN_BRANCHES:
        by_path, train[preset] = train_phase(torch, fa, da, list(kernels.values()), measure_ms,
                                             card_line(), preset)
        launches.update({f"{path}_train": n for path, n in by_path.items()})
    release = {}
    for path, preset, dtype, remat in LARGE_TRAIN_PATHS:
        launches[path], release[path] = release_train_phase(
            torch, fa, da, list(kernels.values()), measure_ms, card_line(), path, preset, dtype,
            remat)
    # remat's peak memory against the same step without it
    peaks = [release[p]["peak_memory_mb_first_step"]
             for p in ("xlarge_train_f32", "xlarge_train_f32_remat")]
    release["xlarge_f32_remat_peak_memory_share"] = peaks[1] / peaks[0]
    print(f"xlarge@640 f32 train step, batch {LARGE_TRAIN_BATCH}, peak device memory: "
          f"{peaks[0]:.1f} MiB, with remat {peaks[1]:.1f} MiB ({card_line()})")
    for preset in EXPECTED_LAUNCHES:
        thr[preset] = bench.run(preset, batch=32)
        log(f"{preset}@640 bf16 throughput: {thr[preset]['value']} img/s at batch 32 "
            f"({thr[preset]['ms_per_batch']} ms)")

    def both(key):
        return {"bfloat16": res[(key, "bfloat16")], "float32": res[(key, "float32")]}

    # each kernel's headline numbers are bf16 at the first path that runs it
    # (small's eval for K1-K3, large's for K4, small's train step for K5-K7,
    # tiny's eval for K9, tiny's train step for K7nb and, in the "cm" and
    # "gather" branches, for K8 and K10 / K10b); its other shapes and f32 stand
    # beside them
    headline_path = {"K4": "large", "K5": "small_train", "K6": "small_train", "K7": "small_train",
                     "K7nb": "tiny_train", "K8": "tiny/cm_train", "K9": "tiny",
                     "K10": "tiny/gather_train", "K10b": "tiny/gather_train"}
    entries = []
    for name in kernels:
        path = headline_path.get(name, "small")
        if launches[path][name] < 1:
            raise AssertionError(f"{name} was not launched on its path {path}")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches[path][name], "path": path,
                 "launches_by_path": {p: launches[p][name] for p in launches},
                 "dtype": "bfloat16", **res[(name, "bfloat16")], "f32": res[(name, "float32")],
                 "tolerance": (ATTENTION_BF16_TOL if name in ("K1", "K2", "K9") else
                               ATTENTION_BWD_BF16_TOL if name in ("K6", "K7", "K7nb") else
                               SAMPLER_BF16_TOL if name in ROUNDED_AS_JAX + ("K5", "K8") else
                               f"|kernel - plain f32| <= {ATOL}{BWD_TOL.get(name, '')} + "
                               f"{RTOL['bfloat16']} x |plain| (f32: {ATOL}{BWD_TOL.get(name, '')})")}
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in ("K2", "K6"):
            entry["decoder_shape"] = both(name + "dec")
        others = {key.split("@")[1] + ("_decoder" if "dec" in key else ""): both(key)
                  for key, kname, *_ in ATTENTION_SHAPES + ATTENTION_BWD_SHAPES
                  if kname == name and "@" in key}
        if name == "K3":
            others.update(tiny=both("K3@tiny"), tiny_cm_train=both("K3@tiny_train"),
                          large=both("K3@large"))
        if name in ("K3", "K8"):
            others.update({k: both(f"{name}@{k}") for k, _ in CM_CHECKS})
        if name == "K4":
            others.update(small_train=both("K4@train"), tiny_train=both("K4@tiny_train"),
                          large_train=both("K4@large_train"))
        if name in ("K4", "K10"):
            others.update({k: both(f"{name}@{k}") for k, _ in SEP_CHECKS})
        if name == "K5":
            others.update(large_batch8=both("K5@large"), tiny_train=both("K5@tiny_train"),
                          large_train=both("K5@large_train"))
        if name in ("K5", "K10b"):
            others.update({k: both(f"{name}@{k}") for k, _ in SEP_BWD_CHECKS})
        if name == "K8":
            others.update(small_train=both("K8@small"), large_train=both("K8@large"))
        if name == "K10":
            others["tiny_eval"] = both("K10@eval")
        if others:
            entry["other_shapes"] = others
        entries.append(entry)
    for entry in entries:  # the kernels line's contract: a shape's numbers must not shadow it
        if entry["route"] not in ("cuda", "triton") or any(k not in entry for k in CONTRACT_KEYS):
            raise AssertionError(f"{entry['name']}: kernels-line entry breaks its contract")
    print(json.dumps({"forward_f32": fwd, "throughput": thr, "train_f32": train,
                      "release_train": release}))
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
