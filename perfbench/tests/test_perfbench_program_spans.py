"""The readers of the program's own spans on a trace and a snapshot worked
by hand; the existing metrics unmoved by the program's ranges in a trace;
`perfbench/spans.py` on the micro cells on the CPU."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness_micro import make_root, micro_settings  # noqa: E402
from perfbench.lib import common, program_spans as ps, trace as tr  # noqa: E402
from test_perfbench_yardstick import context, synthetic  # noqa: E402


def worked():
    """Device busy [0, 10], [20, 22], [30, 40] of the window [0, 50]; the
    program's "step" open over [0, 12] and "fetch" over [40, 48]. Idle
    stretches: [10, 20] begins inside "step", [22, 30] inside no program span,
    [40, 50] inside "fetch". Idle and in no program span: [12, 20], [22, 30],
    [48, 50]: 18 of 50."""
    t = tr.Trace()
    t.device = [(0, 10, "sm90_gemm"), (20, 22, "elt"), (30, 40, "elt")]
    t.launches = [(1, [("sm90_gemm", 10.0)])]
    t.ranges = [(0, 50, tr.WINDOW), (0, 12, "lwdetr:step"), (40, 48, "lwdetr:fetch"),
                (41, 42, tr.SPAN + "fetch wait")]
    return t


def test_unspanned_idle_share_and_the_gaps_by_hand():
    ctx = context("infer", worked())
    assert ps.unspanned_idle_share(ctx, "infer") == pytest.approx(100 * 18 / 50)
    assert ps.unspanned_idle_share(ctx, "train") is None
    assert ps.idle_gaps(ctx.trace) == [("step", 10), ("fetch", 10), (ps.NO_SPAN, 8)]
    # the benchmark's own idle share counts the spanned stretches too: 28 of 50
    from perfbench.lib import readers

    assert readers.idle_share(ctx, "infer") == pytest.approx(56.0)
    # a trace without the program's ranges has nothing to read
    assert ps.unspanned_idle_share(context("infer", synthetic()), "infer") is None


def test_host_ms_per_step_by_hand():
    snap = {"fetch": {"calls": 4, "ns": 8_000_000, "per_call_ns": [2_000_000] * 4},
            "backward": {"calls": 0, "ns": 0, "per_call_ns": []}}
    ctx = context("infer")  # a window of 4 batches
    assert ps.host_ms_per_step(ctx, snap, "fetch", "infer") == pytest.approx(2.0)
    assert ps.host_ms_per_step(ctx, snap, "fetch", "train") is None
    assert ps.host_ms_per_step(ctx, snap, "metric fetch", "infer") is None
    assert ps.host_ms_per_step(ctx, snap, "backward", "infer") is None
    assert ps.host_ms_per_step(ctx, None, "fetch", "infer") is None
    ctx.window["batches"] = 0
    assert ps.host_ms_per_step(ctx, snap, "fetch", "infer") is None


def with_program_ranges(t):
    """`t` with the program's ranges added: over the whole window, over each
    kernel's launch and across the benchmark's spans."""
    t.ranges = t.ranges + [(0, 50, "lwdetr:forward"), (0, 2, "lwdetr:window blocks"),
                           (2, 30, "lwdetr:backward"), (12, 20, "lwdetr:step"),
                           (14, 60, "lwdetr:fetch")]
    return t


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_every_existing_metric_reads_the_same_with_the_program_ranges(mode):
    names = [m["name"] for m in common.read_json(ROOT / "BENCHMARK.json")["per_layer"]]
    assert len(names) >= 18
    plain, ranged = context(mode, synthetic()), context(mode, with_program_ranges(synthetic()))
    plain.sampler_positions = ranged.sampler_positions = [20]
    for name in names:
        read = common.metric_reader(name)
        assert read(plain) == read(ranged), name
    assert tr.breakdown(plain.trace) == tr.breakdown(ranged.trace)
    assert ps.unspanned_idle_share(ranged, mode) is not None


def test_the_profilers_trace_keeps_the_program_ranges_off_the_device():
    from lwdetr_tpu_torch.utils import trace as spans

    with spans.recording(), tr.profiled("cpu") as holder:
        with spans.span("step"):
            torch.ones(8).add_(1)
    t = holder["trace"]
    assert ("lwdetr:step" in {n for _, _, n in t.ranges}
            and not any(n.startswith(ps.PREFIX) for _, _, n in t.device))
    assert [n for _, _, n in ps.program_ranges(t)] == ["step"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["micro.infer", "micro.train"])
def test_spans_runs_a_cell_with_the_recorder_in_turns(root, workload):
    sys.path.insert(0, str(ROOT / "perfbench"))
    import spans as probe

    from lwdetr_tpu_torch.utils import trace as spans

    cell = common.load_cell(workload, root)
    with micro_settings():
        out = probe.run(cell, 2 ** 32 + 5, 0.3, 1, torch.device("cpu"))
    assert [w["recorded"] for w in out["windows"]] == [False, True, True, False]
    assert not spans.enabled()
    mode = workload.split(".")[1]
    read = ("fetch",) if mode == "infer" else ("metric fetch",) + spans.PHASES
    for w in out["windows"]:
        assert w["img_per_s"] > 0 and w["enqueue_ms"] > 0
        if w["recorded"]:
            assert all(w["host_ms_per_step"][n] > 0 for n in read)
            assert w["calls_per_step"]["step"] == 1
        else:
            assert "host_ms_per_step" not in w
    # the CPU has no device timeline: nothing idle to read, the ranges there all the same
    assert out["traced"]["program_ranges"] > 0 and out["traced"]["program_ranges_on_device"] == 0
    assert out["traced"]["unspanned_idle_share"] is None
