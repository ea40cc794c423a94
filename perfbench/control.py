"""The output check's two readings, over many seeds in one process.

    python3 perfbench/control.py --workload small.train_b32 --seconds 2 \\
        --seeds 101 102 103 --control-seeds 101 102 103

For each seed a whole run of the cell (set-up, a short window, the check
against the float32 reference) gives the program's readings, the lower ones;
for each control seed the same images or steps are run again through the
control, the reference in the next precision below the configuration's
(float8 for a bfloat16 cell, TF32 for a float32 one) put in the program's
place, and, in a training cell, through a planted fault (half of each batch
left out): the upper readings. One JSON line a seed. The benchmark's own runs
never run this; the limits in `perfbench/limits/` are set from its lines.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib import common, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 2
    cell = common.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.time()
        result = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), t0)
        driver = result.pop("driver")
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                "program": driver.reading}
        if seed in args.control_seeds:
            line["control"] = driver.control()
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del driver, result
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
