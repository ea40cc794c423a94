"""Per-launch time of the attention forward kernels (K1, K2, K9) on the
inputs one preset's 640x640 eval forward gives them, on one CUDA card.

    python -m lwdetr_tpu_torch.bench_attention --preset tiny --batch 8

Runs the bf16 eval step of `bench.py` once and keeps every `attention_cm`
call's inputs, then for each distinct (kernel, shape): the device time of one
launch (`measure_graph_ms`: calls replayed from a CUDA graph, the card's time
without the host's), the time of back-to-back calls through the wrapper (host
included), and, for K9, K2 on the same inputs. Each output is first held to
its plain version within `flash_attention.bf16_error_bound`. Prints one JSON
line; `value` is the device time of one forward's attention launches (ms),
the measure for comparing two versions of the kernels in turns
(`compare_trees.py --tool bench_attention`).
"""
from __future__ import annotations

import argparse
import json
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="small", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=8)
    return ap


def main() -> None:
    args = parser().parse_args()
    print(json.dumps(run(args.preset, args.batch)))


if __name__ == "__main__":
    main()
