"""The harness is driven by data: a configuration, a traffic mix, the
limits of a check and a per-layer metric, each dropped in as a file of its
own, are found by name; the result line has the contract's keys. On the CPU
at the micro size: the port runs its kernels' plain versions here."""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness_micro import make_root, micro_settings  # noqa: E402
from perfbench.lib import common, harness, trace as tr  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def settings():
    with micro_settings():
        yield


def line_of(result, trace):
    return json.loads(common.result_line(result["correct"], result["attempted"],
                                         result["failed"], result["metrics"], result["device"],
                                         result["checks"],
                                         tr.breakdown(trace) if trace else None))


@pytest.mark.parametrize("workload", ["micro.infer", "micro.train"])
@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_added_as_files_runs_and_reports(root, workload, traced):
    cell = common.load_cell(workload, root)
    assert cell.config["name"] == "micro" and cell.traffic["batch"] == 2
    result = harness.run_cell(cell, 2 ** 32 + 3, 0.5, traced, torch.device("cpu"), time.time(),
                              root=root)
    assert result["correct"], result["checks"].items
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = set(result["metrics"])
    if traced:
        mode = workload.split(".")[1]
        assert names and all(n.endswith("." + mode) for n in names)
        assert ("images_per_batch.infer" in names) == (mode == "infer")
        if mode == "infer":
            assert result["metrics"]["images_per_batch.infer"]["value"] == 2.0
        # the sampler's points were noted, a decoder layer of each traced step
        positions = result["driver"].sampler_positions
        assert len(positions) == 2 * 2 and min(positions) > 0
    else:
        assert names == {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names
    line = line_of(result, None)
    assert list(line) == KEYS + ["checks"]
    assert set(line["checks"]) == set(cell.limits)


def test_the_traced_line_carries_the_breakdown_before_the_checks(root):
    t = tr.Trace(device=[(0, 10, "sm90_gemm")], launches=[(1, [("sm90_gemm", 10.0)])],
                 ranges=[(0, 30, tr.WINDOW), (9, 20, tr.SPAN + "fetch wait")])
    result = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
              "checks": common.Checks()}
    line = line_of(result, t)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert line["breakdown"] == {"device_ops": [["gemm", 1e-5]],
                                 "idle_gaps": [["fetch wait", 2e-5]]}


def run_py(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "large.infer_b32",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    proc = run_py(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "refused" in proc.stderr


def test_the_benchmark_alone_is_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    proc = run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_traffic_kind_is_found_by_its_module(root):
    cell = common.load_cell("micro.infer", root)
    driver = harness.driver_for(cell, 1, torch.device("cpu"), tr.Spans())
    assert type(driver).__module__ == "perfbench.lib.infer"
    bad = common.Cell(**{**cell.__dict__, "traffic": dict(cell.traffic, kind="../infer")})
    with pytest.raises(ValueError):
        harness.driver_for(bad, 1, torch.device("cpu"), tr.Spans())
