"""Per-launch time of the attention forward kernels (K1, K2, K9) on the
inputs one preset's 640x640 eval forward gives them, on one CUDA card; or,
with `--preset wide`, of the wide case (K2, K9 and the backwards K6, K7nb at
the decoder's head dims above 64).

    python -m lwdetr_tpu_torch.bench_attention --preset tiny --batch 8
    python -m lwdetr_tpu_torch.bench_attention --preset wide

Runs the bf16 eval step of `bench.py` once and keeps every `attention_cm`
call's inputs, then for each distinct (kernel, shape): the device time of one
launch (`measure_graph_ms`: calls replayed from a CUDA graph, the card's time
without the host's), the time of back-to-back calls through the wrapper (host
included), and, for K9, K2 on the same inputs. Each output is first held to
its plain version within `flash_attention.bf16_error_bound`. Prints one JSON
line; `value` is the device time of one forward's attention launches (ms),
the measure for comparing two versions of the kernels in turns
(`compare_trees.py --tool bench_attention`).

`--preset wide` times, at each head dim of WIDE_HEAD_DIMS (one head, seeded
inputs as `chip_smoke.py` draws them), K2 over 300 and 150 queries and K9 over
100 at `--batch` images, and K6 over 300 and K7nb over 100 at the train
step's 13 groups of batch 4, in f32 and bf16, each output first held to its
plain version (f32: 2e-5 x max(1, max |plain|); bf16: `bf16_error_bound` /
`bf16_bwd_error_bound`). A head dim this checkout's wide case does not take
(`wide_case_takes`) is reported as refused. `value` sums the device ms
of the shapes at WIDE_COMMON_DIMS, which every version of the wide case takes.
"""
from __future__ import annotations

import argparse
import json
import sys
from unittest import mock

import torch

from lwdetr_tpu_torch.bench import make_step
from lwdetr_tpu_torch.config import PRESETS
from lwdetr_tpu_torch.ops import flash_attention as fa
from lwdetr_tpu_torch.utils.device import card_line
from lwdetr_tpu_torch.utils.timing import measure_graph_ms, measure_ms


def recorded_calls(preset: str, batch: int) -> dict:
    """{(kernel, shape, heads): [launches, qkv_t, heads, scale, bias]} of one
    bf16 eval step, the kernel read from the launch counters; the bias is
    added to qkv_t where `attention_cm` adds it before K2."""
    calls = {}
    dispatch = fa.attention_cm
    kernels = {"K1": fa.window_attention_bias_kernel, "K2": fa.flash_attention_cm_kernel,
               "K9": fa.window_attention_kernel}

    def record(qkv_t, num_heads, scale=None, bias=None):
        before = {name: k.launches for name, k in kernels.items()}
        out = dispatch(qkv_t, num_heads, scale, bias)
        (name,) = [n for n, k in kernels.items() if k.launches != before[n]]
        key = (name, tuple(qkv_t.shape), num_heads)
        if key in calls:
            calls[key][0] += 1
        else:
            x = qkv_t if name != "K2" or bias is None else qkv_t + bias.to(qkv_t.dtype)[:, None]
            calls[key] = [1, x.clone(), num_heads, scale, None if name != "K1" else bias.clone()]
        return out

    step = make_step(preset, batch, torch.bfloat16)
    with torch.no_grad(), mock.patch.object(fa, "attention_cm", record):
        step()
    return calls


def run(preset: str = "small", batch: int = 8) -> dict:
    rows, total = [], 0.0
    with torch.no_grad():
        for (name, shape, heads), (launches, qkv_t, _, scale, bias) in recorded_calls(
                preset, batch).items():
            scale = scale if scale is not None else (shape[1] // 3 // heads) ** -0.5
            if name == "K1":
                call = lambda: fa.window_attention_bias(qkv_t, bias, heads, scale)  # noqa: E731
                panel = qkv_t + bias.to(qkv_t.dtype)[:, None]
            elif name == "K9":
                call = lambda: fa.window_attention(qkv_t, heads, scale)  # noqa: E731
                panel = qkv_t
            else:
                call = lambda: fa.flash_attention_cm(qkv_t, heads, scale)  # noqa: E731
                panel = qkv_t
            ref = fa.attention_cm_plain(panel, heads, scale).float()
            excess = ((call().float() - ref).abs()
                      - fa.bf16_error_bound(panel, heads, scale, ref)).max().item()
            if excess > 0:
                raise AssertionError(f"{name} {shape}: over its bf16 bound by {excess}")
            row = {"kernel": name, "shape": list(shape), "heads": heads, "launches": launches,
                   "device_ms": measure_graph_ms(call)["ms"], "ms": measure_ms(call)["ms"]}
            if name == "K9":
                k2 = lambda: fa.flash_attention_cm(qkv_t, heads, scale)  # noqa: E731
                row["k2_device_ms"] = measure_graph_ms(k2)["ms"]
                row["k2_ms"] = measure_ms(k2)["ms"]
            total += launches * row["device_ms"]
            rows.append(row)
    return {"metric": f"lwdetr_{preset}_640_bf16_attention_device_ms", "value": total,
            "unit": "ms", "batch": batch, "kernels": rows,
            "device": torch.cuda.get_device_name(), "card": card_line()}


WIDE_HEAD_DIMS = (128, 192, 256, 384, 512, 1024, 2048, 2112)
WIDE_COMMON_DIMS = (128, 256, 512, 1024, 2048)
WIDE_TRAIN_BATCH = 13 * 4  # the decoder's 13 groups folded into the batch of 4
WIDE_ATOL = 2e-5


def wide_case_takes(head_dim: int) -> bool:
    """Whether this checkout's wide case takes `head_dim` unpadded (a checkout
    from before the rule of multiples of 64 lists its head dims)."""
    rule = getattr(fa, "is_wide_head_dim", None)
    return rule(head_dim) if rule is not None else head_dim in fa._WIDE_HEAD_DIMS


def _wide_row(name, dtype, B, D, N, run, check):
    row = {"kernel": name, "dtype": str(dtype).split(".")[-1], "shape": [B, 3 * D, N],
           "head_dim": D}
    if not wide_case_takes(D):
        row["refused"] = "this checkout's wide case does not take the head dim"
        return row
    check(run())
    row["device_ms"] = measure_graph_ms(run, iters=5, repeats=3)["ms"]
    return row


def run_wide(batch: int = 8) -> dict:
    """The wide case's forward and backward kernels at WIDE_HEAD_DIMS."""
    rows = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for D in WIDE_HEAD_DIMS:
                scale = D ** -0.5
                for name, B, N in (("K2", batch, 300), ("K2", batch, 150), ("K9", batch, 100),
                                   ("K6", WIDE_TRAIN_BATCH, 300), ("K7nb", WIDE_TRAIN_BATCH, 100)):
                    gen = torch.Generator(device="cuda").manual_seed(N + D)
                    qkv = (0.5 * torch.randn((B, 3 * D, N), generator=gen, device="cuda")).to(dtype)
                    dout = torch.randn((B, D, N), generator=gen, device="cuda").to(dtype)
                    if name in ("K2", "K9"):
                        wrapper = fa.window_attention if name == "K9" else fa.flash_attention_cm
                        run = lambda: wrapper(qkv, 1, scale)  # noqa: E731
                        ref = fa.attention_cm_plain(qkv, 1, scale).float()
                        bound = (fa.bf16_error_bound(qkv, 1, scale, ref) if dtype == torch.bfloat16
                                 else WIDE_ATOL * max(1.0, ref.abs().max().item()))
                    else:
                        if name == "K6":
                            lse = {}

                            def run():
                                if "lse" not in lse:  # K2's row log-sum-exp, made once
                                    lse["lse"] = fa.flash_attention_cm_fwd(qkv, 1, scale, True)[1]
                                return fa.flash_attention_cm_bwd(qkv, lse["lse"], dout, 1, scale)
                        else:
                            run = lambda: fa.window_attention_bias_bwd(qkv, None, dout, 1,  # noqa: E731
                                                                       scale)
                        ref = fa.attention_cm_bwd_plain(qkv, dout, 1, scale).float()
                        bound = (fa.bf16_bwd_error_bound(qkv, dout, 1, scale, ref)
                                 if dtype == torch.bfloat16
                                 else WIDE_ATOL * max(1.0, ref.abs().max().item()))

                    def check(out, ref=ref, bound=bound, name=name, D=D, N=N):
                        excess = ((out.float() - ref).abs() - bound).max().item()
                        if not torch.isfinite(out).all() or excess > 0:
                            raise AssertionError(f"{name} D={D} N={N} {dtype}: over its bound "
                                                 f"by {excess}")

                    rows.append(_wide_row(name, dtype, qkv.shape[0], D, N, run, check))
                    print(f"{rows[-1]}", file=sys.stderr, flush=True)
    total = sum(r["device_ms"] for r in rows
                if r["head_dim"] in WIDE_COMMON_DIMS and "device_ms" in r)
    return {"metric": "lwdetr_wide_attention_device_ms", "value": total, "unit": "ms",
            "batch": batch, "kernels": rows, "device": torch.cuda.get_device_name(),
            "card": card_line()}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS) + ("wide",))
    ap.add_argument("--batch", type=int, default=8)
    return ap


def main() -> None:
    args = parser().parse_args()
    out = run_wide(args.batch) if args.preset == "wide" else run(args.preset, args.batch)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
