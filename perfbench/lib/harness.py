"""One run of one cell: set-up, the measured window, the traced steps, the
output check, the result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` reports the cell's end-to-end metrics; `--trace 1` runs the same
window with the benchmark's host spans on (they feed the host metrics and
`mfu`), then a few steps under `torch.profiler` with the model's stages
ranged (they feed the device metrics and `breakdown`), and reports the
per-layer metrics. Both check the outputs against the plain reference once
the program's state is freed, print each number compared beside its limit
as the last lines on standard error and under "checks", the result line's
last key.

A traffic file's "kind" names the module `perfbench/lib/<kind>.py` whose
`Driver` generates that kind of traffic: a new kind is a new file.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import sys
import time
from pathlib import Path
from typing import Optional

from perfbench.lib import common
from perfbench.lib import trace as tr


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg) -> None:
    print(msg, file=sys.stderr, flush=True)


def driver_for(cell, seed, device, spans):
    """The `Driver` of the cell's traffic kind; it reads the chips the cell
    asks for from `cell.workload["chips"]`."""
    kind = cell.traffic["kind"]
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} is no module name")
    return importlib.import_module(f"perfbench.lib.{kind}").Driver(cell, seed, device, spans,
                                                                   log=log)


def built_libraries() -> set:
    """The port's native libraries (nvcc and g++) built so far in this checkout."""
    from lwdetr_tpu_torch.ops import _build

    return set(_build.BUILD_DIR.glob("*.so"))


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Optional[Path] = None) -> dict:
    """Set-up, window, traced steps (`trace`) and check of `cell` on `device`;
    returns the result (without printing it) and the driver."""
    import torch

    from perfbench.lib.readers import Context

    spans = tr.Spans()
    driver = driver_for(cell, seed, device, spans)
    on_card = torch.device(device).type == "cuda"
    chips = range(int(cell.workload["chips"]) if on_card else 0)
    if on_card:
        torch.cuda.init()  # the allocator's statistics exist once CUDA is up
    for i in chips:
        torch.cuda.reset_peak_memory_stats(i)
    driver.setup()
    setup_s = time.time() - t_start
    window = driver.run_window(seconds)
    e2e = driver.end_to_end()
    trace_obj, traced_sizes = (driver.run_traced() if trace else (None, []))
    peak = max((torch.cuda.max_memory_allocated(i) for i in chips), default=0)
    ctx = Context(mode=driver.mode, config=cell.config, traffic=cell.traffic, window=window,
                  spans=dict(spans.seconds), trace=trace_obj, traced_sizes=traced_sizes,
                  sampler_positions=getattr(driver, "sampler_positions", None))
    driver.release()
    gc.collect()
    checks = common.Checks()
    driver.check(checks)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = common.metric_reader(m["name"], root or common.ROOT)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and trace_obj is not None and trace_obj.device:
        a, b = trace_obj.window
        dev["busy_s"] = tr.busy_us(trace_obj) / 1e6
        dev["window_s"] = (b - a) / 1e6
        breakdown = tr.breakdown(trace_obj)
    return {"correct": checks.correct, "attempted": window["batches"],
            "failed": window["batches"] - window["done"], "metrics": metrics, "device": dev,
            "breakdown": breakdown, "checks": checks, "driver": driver}


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = common.load_cell(args.workload)
    card = common.start_card_query()
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.finish_card_query(card)
        log(f"refused: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    before = built_libraries()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t_start)
    # the first run of a cell in a checkout builds the libraries it launches
    # inside its set-up: its setup_s is of another kind than a warm run's
    cold = len(built_libraries() - before)
    build = (f"build: cold, {cold} native libraries built in set-up" if cold
             else "build: warm, every native library the cell loads was built before")
    log(build)
    card_line = common.finish_card_query(card)
    found = common.forbidden_modules()
    if found:
        log(f"refused: the process loaded {found}")
        return 3
    checks = result["checks"]
    print(f"card: {card_line}; torch {torch.__version__} cuda {torch.version.cuda}; {build}",
          flush=True)
    log(f"card: {card_line}")
    for line in checks.lines():
        log(line)
    print(common.result_line(result["correct"], result["attempted"], result["failed"],
                             result["metrics"], result["device"], checks,
                             result["breakdown"]), flush=True)
    return 0

