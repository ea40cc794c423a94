"""What every run shares: the files a cell is made of, the card's record,
the check that the JAX package never loaded, and the result line.

A cell is found by name: `BENCHMARK.json` names its configuration and its
traffic mix; the configuration's file is the one `BENCHMARK.json` gives, the
mix is `perfbench/traffic/<traffic>.json`, whose "kind" names the module of
its generator (`perfbench/lib/<kind>.py`), the limits of its output check are
`perfbench/limits/<workload>.json` and each per-layer metric is read by
`perfbench/metrics/<metric>.py`. Adding a cell adds files; it edits none.
"""
from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lwdetr_tpu")  # whole top-level module names


@dataclass
class Cell:
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its files."""
    bench = read_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(workload=w, config=read_json(root / conf["file"]),
                traffic=read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(root / "perfbench" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(ctx)` of `perfbench/metrics/<name>.py`."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose whole top-level name is a JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def start_card_query() -> Optional[subprocess.Popen]:
    """`nvidia-smi`'s name, power limit and clocks, read beside the set-up."""
    try:
        return subprocess.Popen(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
    except OSError:
        return None


def finish_card_query(proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return "nvidia-smi not found"
    out, _ = proc.communicate(timeout=60)
    return " | ".join(line.strip() for line in out.splitlines() if line.strip())


@dataclass
class Checks:
    """The numbers compared with the plain reference, each beside its limit."""

    items: Dict[str, Dict[str, float]] = field(default_factory=dict)

    def add(self, name: str, value: float, limit: float) -> None:
        self.items[name] = {"value": float(value), "limit": float(limit)}

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(v["value"] <= v["limit"] for v in self.items.values())

    def lines(self) -> List[str]:
        return [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in self.items.items()]


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, dict],
                device: dict, checks: Checks, breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks.items
    return json.dumps(out)
