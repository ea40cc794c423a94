"""Two checkouts of the repo measured in turns, on one CUDA card.

    python -m lwdetr_tpu_torch.compare_trees --other path/to/other/checkout \\
        --presets small tiny [--tool bench|bench_train|bench_attention|bench_deform] \\
        [--breakdown] [--value_step train/cm] [--dtype bfloat16]

Host-bound steps move with the machine by 25% between runs, so two versions
are compared only inside one run, in turns. This builds each checkout's
kernels first (its own `build/`, one nvcc per source), then for each preset
runs `python -m lwdetr_tpu_torch.<tool> --preset P --batch B` from the other
checkout and from this one in the order other, this, this, other (each a
fresh process): `bench` (eval img/s, B 32), `bench_train` (the f32 train
step, B 4), `bench_attention` (device ms of the attention kernels, B 8;
`--presets wide`: the wide case's forwards and backwards at the decoder's
head dims above 64, copy `lwdetr_tpu_torch/bench_attention.py` into a parent
that lacks the mode) or
`bench_deform` (device ms of the samplers, train step B 4; both trees must
have `bench_deform.py`; `--value_step` is passed to it: the step whose
sampler launches are `value`). `--batch` replaces the tool's batch (for
`bench_deform`, 0 runs the eval step alone:
`--tool bench_deform --presets large --batch 0 --value_step eval`).
`--dtype` (bench_train only) is the train step's compute dtype, passed to
both tools. With `--breakdown` (bench, bench_train) it adds `python -m
lwdetr_tpu_torch.breakdown` with the same step, in the same turns (device
busy time and idle share). Prints one JSON line: every run's output in that
order, and the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from lwdetr_tpu_torch.utils.device import card_line

THIS = Path(__file__).resolve().parents[1]
BUILD = "from lwdetr_tpu_torch.ops import _build; _build.build(_build.SOURCES)"
# each tool's batch: the eval metric's, the train step's, the kernel checks' of
# chip_smoke.py, the train step's
BATCH = {"bench": 32, "bench_train": 4, "bench_attention": 8, "bench_deform": 4}


def run_json(tree: Path, args) -> dict:
    """The last line of `python args...` run from `tree`, parsed as JSON."""
    proc = subprocess.run([sys.executable, *args], cwd=tree, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: {' '.join(args)} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="root of the other checkout")
    ap.add_argument("--presets", nargs="+", default=["small", "tiny"])
    ap.add_argument("--tool", default="bench", choices=tuple(BATCH))
    ap.add_argument("--breakdown", action="store_true", help="bench and bench_train only")
    ap.add_argument("--value_step", help="bench_deform only: its --value_step")
    ap.add_argument("--batch", type=int, help="the tool's --batch (default: BATCH[tool])")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    help="bench_train only: the train step's compute dtype")
    args = ap.parse_args()
    tool = args.tool
    batch = BATCH[tool] if args.batch is None else args.batch
    if args.breakdown and tool in ("bench_attention", "bench_deform"):
        ap.error("--breakdown times a whole step: bench or bench_train")
    if args.value_step and tool != "bench_deform":
        ap.error("--value_step is bench_deform's")
    if args.dtype and tool != "bench_train":
        ap.error("--dtype is bench_train's")
    trees = {"other": args.other.resolve(), "this": THIS}
    for tree in trees.values():  # so that no timed run compiles
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True)
    runs = []
    for preset in args.presets:
        tail = ["--preset", preset, "--batch", str(batch)]
        tail += ["--dtype", args.dtype] if args.dtype else []
        step = ["--value_step", args.value_step] if args.value_step else []
        for which in ("other", "this", "this", "other"):
            out = run_json(trees[which], ["-m", f"lwdetr_tpu_torch.{tool}", *tail, *step])
            runs.append({"tree": which, "tool": tool, "preset": preset, **out})
            print(f"{preset} {which}: {out['value']:.4f} {out['unit']}", file=sys.stderr,
                  flush=True)
        if args.breakdown:
            for which in ("other", "this", "this", "other"):
                out = run_json(trees[which], ["-m", "lwdetr_tpu_torch.breakdown", *tail,
                                              *(["--train"] if tool == "bench_train" else [])])
                runs.append({"tree": which, "tool": "breakdown", "preset": preset, **out})
    print(json.dumps({"other": str(trees["other"]), "runs": runs, "card": card_line()}))


if __name__ == "__main__":
    main()
