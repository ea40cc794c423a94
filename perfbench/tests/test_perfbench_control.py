"""The control fails the check, on the card, at a size a test run holds.

The real cells' configurations and limits at a smaller batch (the numbers
compared are per image or per leaf): the program passes, and the control
(the reference one precision below the configuration's, in the program's
place: float8 products for a bfloat16 cell, TF32 for a float32 one) fails at
least one number. At the cells' own sizes `perfbench/control.py` reads the
same over many seeds; PERF.md keeps those readings. Skips without a card.
"""
import dataclasses
import sys
import time
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import common, harness, infer  # noqa: E402

SMALLER = {"large.infer_b32": {"batch": 4, "pool": 2},
           "small.train_b32": {"batch": 4, "sizes": [448, 512, 576]},
           "large.train_b16": {"batch": 2, "sizes": [448, 512, 576]}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SMALLER))
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_the_control_fails_where_the_program_passes(workload, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs the port's kernels")
    cell = common.load_cell(workload)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, **SMALLER[workload]))
    with mock.patch.object(infer, "CHECK_IMAGES", 8):
        result = harness.run_cell(cell, seed, 1.0, False, torch.device("cuda", 0), time.time())
        readings = result["driver"].control()
    assert result["correct"], result["checks"].items
    for name, reading in readings.items():
        failed = [k for k, limit in cell.limits.items() if k in reading and reading[k] > limit]
        assert failed, (name, reading, cell.limits)
