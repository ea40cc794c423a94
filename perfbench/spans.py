"""One cell with the program's span recorder on, until the harness reads the program's spans.

    python3 perfbench/spans.py --workload small.train_b32 --seed 7 --seconds 30 --turns 2

Set-up as a run of the cell, then windows of `--seconds` in turns with the
program's recorder (`lwdetr_tpu_torch/utils/trace.py`) off and on (off, on,
on, off, `--turns` times), each window's rate and the benchmark's own host
spans read apart; the program's spans of the recorded windows read as
`lib/program_spans.py` reads them; then the cell's traced steps with the
recorder on, and the device's idle share with and without a program span
open. Prints one JSON line. No output check: the cell's own runs check it.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))

from perfbench.lib import common, harness, program_spans as ps, readers  # noqa: E402
from perfbench.lib import trace as tr  # noqa: E402

HOST = ("loader", "to_device", "step", "fetch", "evaluator", "metric fetch", "forward",
        "criterion", "backward", "optimizer", "matcher", "post_process")


def window(driver, seconds: float, recorded: bool, spans) -> dict:
    """One window; the benchmark's own spans and, `recorded`, the program's."""
    driver.spans = tr.Spans()
    if recorded:
        spans.reset()
        spans.enable()
    try:
        w = driver.run_window(seconds)
    finally:
        spans.disable()
    rate = next(v for k, v in driver.end_to_end().items() if k.endswith("img_per_s"))
    ctx = readers.Context(mode=driver.mode, config=driver.cell.config,
                          traffic=driver.cell.traffic, window=w,
                          spans=dict(driver.spans.seconds))
    out = {"recorded": recorded, "img_per_s": rate, "batches": w["batches"],
           "enqueue_ms": readers.mean_span_ms(ctx, "enqueue", driver.mode),
           "to_device_ms": readers.mean_span_ms(ctx, "to_device", driver.mode)}
    if recorded:
        snap = spans.snapshot()
        out["host_ms_per_step"] = {n: ps.host_ms_per_step(ctx, snap, n, driver.mode)
                                   for n in HOST}
        out["calls_per_step"] = {n: snap[n]["calls"] / w["batches"] for n in HOST if n in snap}
    return out


def run(cell, seed: int, seconds: float, turns: int, device) -> dict:
    """Set-up, the windows in turns and the traced steps of `cell` on `device`."""
    from lwdetr_tpu_torch.utils import trace as spans

    driver = harness.driver_for(cell, seed, device, tr.Spans())
    driver.setup()
    setup_s = time.time() - T_START
    windows = [window(driver, seconds, on, spans) for _ in range(turns)
               for on in (False, True, True, False)]
    driver.spans = tr.Spans()
    spans.reset()
    spans.enable()
    try:
        trace, sizes = driver.run_traced()
    finally:
        spans.disable()
    ctx = readers.Context(mode=driver.mode, config=cell.config, traffic=cell.traffic, window={},
                          trace=trace, traced_sizes=sizes)
    rates = {on: [w["img_per_s"] for w in windows if w["recorded"] == on] for on in (False, True)}
    return {
        "workload": cell.workload["name"], "seed": seed, "setup_s": setup_s, "windows": windows,
        "median_img_per_s": {"off": statistics.median(rates[False]),
                             "on": statistics.median(rates[True])},
        "traced": {"idle_share": readers.idle_share(ctx, driver.mode),
                   "unspanned_idle_share": ps.unspanned_idle_share(ctx, driver.mode),
                   "program_ranges": len(ps.program_ranges(trace)),
                   "program_ranges_on_device": sum(n.startswith(ps.PREFIX)
                                                   for _, _, n in trace.device),
                   "idle_gaps_ms": [[n, us / 1e3] for n, us in ps.idle_gaps(trace)],
                   "benchmark_idle_gaps_ms": [[n, us / 1e3] for n, us in tr.idle_gaps(trace)]},
    }


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    cell = common.load_cell(args.workload)
    card = common.start_card_query()
    import torch

    if not torch.cuda.is_available():
        common.finish_card_query(card)
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, args.turns, torch.device("cuda", 0))
    out.update(card=common.finish_card_query(card), torch=torch.__version__)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
