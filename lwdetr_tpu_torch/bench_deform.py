"""Per-launch time of the deformable-attention samplers (K3, K4, K5, K8, K10,
K10b) on the inputs one preset's 640x640 train step and eval step give them,
on one CUDA card.

    python -m lwdetr_tpu_torch.bench_deform --preset small --batch 4

Runs one f32 train step of the preset at `--batch` in each branch of the
decoder's cross-attention (default: panels, K4 / K5; "cm": K3 / K8; "gather":
K10 / K10b; 0: none, for the presets whose train step is not ported) and one
bf16 eval step at `--eval_batch` (0: none), and keeps every sampler call's
inputs. Then for each distinct (step, kernel, shape): the
device time of one launch (`measure_graph_ms`: calls replayed from a CUDA
graph, the card's time without the host's), the time of back-to-back calls
through the wrapper (host included), and the largest difference from the plain
version run in f32 on the same inputs, held to the tolerance of `chip_smoke.py`.
K5 is also timed, in f32 and bf16, at large's train shape (`LARGE_TRAIN`, on
inputs made from a seed: that step is not ported). Prints one JSON line;
`value` is the device time of one step's sampler launches (ms), the step
`--value_step` names (default: the default train step; `train/cm` is K3 and
K8, `eval` the bf16 eval step's forwards), the measure for comparing two
versions in turns (`compare_trees.py --tool bench_deform`). Every step's sum
is in `device_ms_by_step`. K4 on large's own bf16 eval inputs:

    python -m lwdetr_tpu_torch.bench_deform --preset large --batch 0 --eval_batch 32 \
        --value_step eval
"""
from __future__ import annotations

import argparse
import json
from unittest import mock

import torch

from lwdetr_tpu_torch import bench, bench_train
from lwdetr_tpu_torch.config import PRESETS
from lwdetr_tpu_torch.models.transformer import set_force_branch
from lwdetr_tpu_torch.ops import deform_attn as da
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_graph_ms, measure_ms

# wrapper -> (kernel, plain version); each wrapper launches its kernel once a call
WRAPPERS = {"ms_deform_attn_cm_fwd": ("K3", "ms_deform_attn_cm_plain"),
            "ms_deform_attn_sep_panels_fwd": ("K4", "ms_deform_attn_sep_panels_plain"),
            "ms_deform_attn_sep_panels_bwd": ("K5", "ms_deform_attn_sep_panels_bwd_plain"),
            "ms_deform_attn_cm_bwd": ("K8", "ms_deform_attn_cm_bwd_plain"),
            "ms_deform_attn_fwd": ("K10", "ms_deform_attn_plain"),
            "ms_deform_attn_bwd": ("K10b", "ms_deform_attn_bwd_plain")}
BRANCHES = (None, "cm", "gather")
# the steps whose sampler launches `run` sums, one of which is `value`
STEPS = tuple(f"train/{b or 'default'}" for b in BRANCHES) + ("eval",)
# large's train step is not ported yet: K5 at its shape (batch 8, 24 heads, 4
# points, 13 groups of 300 queries over P3 + P5), checked on inputs made from a
# seed, 3 launches a step: (B, heads, head_dim, points, queries, levels)
LARGE_TRAIN = (8, 24, 16, 4, 3900, [(80, 80), (20, 20)])
# kernel vs the plain version in f32 on the same inputs: 2e-5 (x max(1, max
# |plain|) for a gradient, x 4 on d(value) for the order of its sums) +
# 2^-8 |plain| in bf16
ATOL = 2e-5
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
# bf16 samplers that round where the JAX kernels round are held to their plain
# version on the same bf16 values, within one bf16 ulp (chip_smoke.py's
# SAMPLER_RTOL); K5's d(loc) and d(weights) also within sep_panels_bwd_bf16_bound
ROUNDED_AS_JAX = ("K3", "K4", "K10", "K5", "K8")
ROUNDED_RTOL = 2.0 ** -7


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return [t.detach().clone() for t in x]
    return x


def _f32(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.float()
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return [t.float() for t in x]
    return x


def _shape(x):
    if isinstance(x, torch.Tensor):
        return list(x.shape)
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], torch.Tensor):
        return [list(t.shape) for t in x]
    return None


def _value(args):
    """A sampler call's first value tensor (a panel list's first panel)."""
    return args[0][0] if isinstance(args[0], (list, tuple)) else args[0]


def _flat(out):
    """A sampler's outputs as a list of (role, tensor): its output, or d(value)
    (a tensor or one per level), d(loc) and d(weights)."""
    if isinstance(out, torch.Tensor):
        return [("out", out)]
    dv, dloc, dw = out
    return [("dvalue", t) for t in (dv if isinstance(dv, (list, tuple)) else [dv])] + \
        [("dloc", dloc), ("dweights", dw)]


def max_error(out, ref, dtype, rtol=None, bounds=None) -> float:
    """max |kernel - plain| over the outputs; raises past the tolerance
    (`rtol` in place of RTOL[dtype]; `bounds`: role -> an elementwise bound
    added)."""
    worst = 0.0
    for (role, t), (_, r) in zip(_flat(out), _flat(ref)):
        r = r.float()
        diff = (t.float() - r).abs()
        scale = 1.0 if role == "out" else max(1.0, r.abs().max().item())
        atol = ATOL * scale * (4.0 if role == "dvalue" else 1.0)
        rel = (RTOL[dtype] if rtol is None else rtol) if role in ("out", "dvalue") else 0.0
        excess = (diff - (atol + rel * r.abs() + (bounds or {}).get(role, 0.0))).max().item()
        if not torch.isfinite(t).all() or excess > 0:
            raise AssertionError(f"{role}: max abs err {diff.max().item()}, "
                                 f"over its bound by {excess}")
        worst = max(worst, diff.max().item())
    return worst


def recorded_calls(preset: str, batch: int, eval_batch: int) -> dict:
    """{(step, kernel, shapes): [launches, wrapper name, args]} of one f32
    train step in each branch (none at batch 0) and one bf16 eval step (none
    at eval_batch 0)."""
    calls, where = {}, {"step": None}

    def recorder(wrapper):
        fn = getattr(da, wrapper)

        def record(*args):
            key = (where["step"], WRAPPERS[wrapper][0],
                   json.dumps([_shape(a) for a in args] + [str(_value(args).dtype)]))
            if key in calls:
                calls[key][0] += 1
            else:
                calls[key] = [1, wrapper, [_clone(a) for a in args]]
            return fn(*args)

        return record

    patches = [mock.patch.object(da, w, recorder(w)) for w in WRAPPERS]
    for p in patches:
        p.start()
    try:
        if batch:
            state, step = bench_train.make_train_step(preset, batch, seed=0)
            for branch in BRANCHES:
                set_force_branch(state.model, branch)
                where["step"] = f"train/{branch or 'default'}"
                step()
            del state, step
        if eval_batch:
            where["step"] = "eval"
            with torch.no_grad():
                bench.make_step(preset, eval_batch, torch.bfloat16)()
    finally:
        for p in patches:
            p.stop()
    torch.cuda.synchronize()
    return calls


def large_train_call(dtype: torch.dtype, seed: int = 4) -> list:
    """K5's arguments at LARGE_TRAIN: random panels and d(out), softmax
    weights, points of which about a tenth fall outside [0, 1]."""
    B, H, D, P, Q, shapes = LARGE_TRAIN
    L = len(shapes)
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = [torch.randn((B, H, h, w * D), generator=g, device="cuda").to(dtype) for h, w in shapes]
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device="cuda") * 1.1 - 0.05
    w = torch.randn((B, Q, H, L * P), generator=g, device="cuda").softmax(-1).reshape(B, Q, H, L, P)
    dout = torch.randn((B, Q, H * D), generator=g, device="cuda").to(dtype)
    return [vals, shapes, loc, w, dout]


def timed(call, ref, dtype, rtol=None, bounds=None) -> dict:
    err = max_error(call(), ref, dtype, rtol, bounds)
    return {"device_ms": measure_graph_ms(call)["ms"], "ms": measure_ms(call)["ms"],
            "max_abs_err": err}


def run(preset: str = "small", batch: int = 4, eval_batch: int = 32,
        value_step: str = "train/default") -> dict:
    if value_step not in STEPS or not (eval_batch if value_step == "eval" else batch):
        raise ValueError(f"value_step {value_step!r}: one of {STEPS} whose step runs")
    rows, by_step = [], {}
    calls = recorded_calls(preset, batch, eval_batch)
    for dtype in (torch.float32, torch.bfloat16):
        calls[("check/large_train", "K5", str(dtype))] = [
            3, "ms_deform_attn_sep_panels_bwd", large_train_call(dtype)]
    for (step, name, _), (launches, wrapper, args) in calls.items():
        fn, plain = getattr(da, wrapper), getattr(da, WRAPPERS[wrapper][1])
        dtype = _value(args).dtype
        call = lambda: fn(*args)  # noqa: E731
        rtol = bounds = None
        with torch.no_grad():
            if dtype == torch.bfloat16 and name in ROUNDED_AS_JAX:
                ref, rtol = plain(*args), ROUNDED_RTOL
                if name == "K5":
                    bloc, bw = da.sep_panels_bwd_bf16_bound(*args)
                    bounds = {"dloc": bloc, "dweights": bw}
            else:
                ref = plain(*[_f32(a) for a in args])
            row = {"step": step, "kernel": name, "shape": [_shape(a) for a in args
                                                           if _shape(a) is not None],
                   "dtype": str(dtype).replace("torch.", ""), "launches": launches,
                   **timed(call, ref, dtype, rtol, bounds)}
        by_step[step] = by_step.get(step, 0.0) + launches * row["device_ms"]
        rows.append(row)
    kind = "bf16_eval" if value_step == "eval" else "f32_" + value_step.replace("/", "_")
    return {"metric": f"lwdetr_{preset}_640_{kind}_sampler_device_ms",
            "value": by_step[value_step], "value_step": value_step, "unit": "ms", "batch": batch,
            "eval_batch": eval_batch, "device_ms_by_step": by_step, "kernels": rows,
            "large_train": LARGE_TRAIN,
            "device": torch.cuda.get_device_name(), "card": card_line()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=4, help="the train step's; 0: none")
    ap.add_argument("--eval_batch", type=int, default=32, help="the bf16 eval step's; 0: none")
    ap.add_argument("--value_step", default="train/default", choices=STEPS,
                    help="the step whose sampler launches `value` sums")
    return ap


def main() -> None:
    args = parser().parse_args()
    print(json.dumps(run(args.preset, args.batch, args.eval_batch, args.value_step)))


if __name__ == "__main__":
    main()
