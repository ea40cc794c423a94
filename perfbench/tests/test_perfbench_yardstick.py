"""The frozen arithmetic and the metric readers on synthetic traces with
answers worked by hand, and the stored FLOP counts recounted."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import common, readers, trace as tr, yardstick as ys  # noqa: E402

TINY = {"encoder": "vit_tiny", "vit_encoder_num_layers": 2, "window_block_indexes": [0],
        "group_detr": 2, "sa_nheads": 4, "hidden_dim": 64, "num_queries": 10, "dec_layers": 1,
        "ca_nheads": 8, "projector_scale": ["P4"], "dec_n_points": 2}


def test_attention_least_time_by_hand():
    # 64 px: a 4 x 4 token map. Window block: 16 windows of 1 token, 12 heads of
    # 16: 4*16*12*1*16 = 12288 operations, 4*16*192*1*2 = 24576 bytes. Global
    # block: 16 tokens, 4*12*256*16 = 196608 operations, 4*192*16*2 = 24576
    # bytes. Decoder (eval: one group): 10 queries, 4 heads of 16: 25600
    # operations, 4*64*10*2 = 5120 bytes. Every call is bound by its bytes.
    want = (24576 + 24576 + 5120) / 3.35e12
    assert ys.attention_least_s(TINY, 64, 1, False, "bfloat16") == pytest.approx(want)
    # training: two groups in the decoder (10240 bytes), and each backward
    # moves 7 / 4 of its forward's bytes
    fwd = (24576 + 24576 + 10240) / 3.35e12
    assert ys.attention_least_s(TINY, 64, 1, True, "bfloat16") == pytest.approx(fwd * 11 / 4)


def test_sampler_least_time_by_hand():
    # eval, 64 px, P4: 4 x 4 positions; heads of 64 / 8 = 8 channels. 10 queries
    # x 8 heads x 1 level x 2 points = 160 points; the layer's corners name 20
    # positions (160 values); float32: (160 + 160 * 3 + 10 * 64) * 4 = 5120 bytes
    # against 8 * 10 * 8 * 8 * 1 * 2 = 10240 operations: bytes bound
    assert ys.sampler_least_s(TINY, 64, 1, False, "float32", [20]) == \
        pytest.approx(5120 / 3.35e12)
    # train: 20 queries, 320 points, 30 positions (240 values); forward
    # (240 + 320 * 3 + 20 * 64) * 4 = 9920 bytes; backward
    # (240 + 20 * 64 + 2 * 320 * 3 + 16 * 64) * 4 = 17856 bytes
    assert ys.sampler_least_s(TINY, 64, 1, True, "float32", [30]) == \
        pytest.approx((9920 + 17856) / 3.35e12)
    # the traced steps' positions, one a decoder layer of each step in turn
    assert ys.sampler_total_least(TINY, [64, 64], 1, False, "float32", [20, 20]) == \
        pytest.approx(2 * 5120 / 3.35e12)
    assert ys.sampler_total_least(TINY, [64, 64], 1, False, "float32", [20]) is None


def test_touched_positions_by_hand():
    import torch

    # one image, one head, 2 levels (4 x 4, 2 x 2), 3 points. Level 0: (0.5,
    # 0.5) * 4 - 0.5 = 1.5 names rows and columns 1-2: 4 positions; (0, 0)
    # names -1 and 0, of which only (0, 0) is inside; (0.55, 0.5): x 1.7, the
    # same 4 as the first. Level 1: (0.5, 0.5) * 2 - 0.5 = 0.5: all 4 of the
    # map; (0, 0): (0, 0) alone; (1.2, 0.5): x 1.9 names column 1 (inside)
    # and 2 (outside), rows 0-1, both already named: 4 + 1 + 4 = 9
    loc = torch.tensor([[[0.5, 0.5], [0.0, 0.0], [0.55, 0.5]],
                        [[0.5, 0.5], [0.0, 0.0], [1.2, 0.5]]]).reshape(1, 1, 1, 2, 3, 2)
    assert ys.touched_positions(loc, [(4, 4), (2, 2)]) == 9
    # a second head or image reads positions of its own
    assert ys.touched_positions(loc.expand(2, 1, 3, 2, 3, 2), [(4, 4), (2, 2)]) == 54


def synthetic():
    t = tr.Trace()
    t.device = [(0, 10, "sm90_gemm"), (5, 15, "flash_attention_cm_kernel<1>"), (30, 40, "elt")]
    t.launches = [(1, [("sm90_gemm_f32", 10.0)]), (3, [("flash_attention_cm_kernel<1>", 10.0)]),
                  (25, [("vectorized_elementwise", 10.0)]), (60, [("late_kernel", 5.0)])]
    t.ranges = [(0, 2, "encoder window blocks"), (0, 30, tr.BACKWARD), (0, 50, tr.WINDOW),
                (12, 20, tr.SPAN + "enqueue"), (14, 35, tr.SPAN + "to_device")]
    return t


def test_trace_arithmetic_by_hand():
    t = synthetic()
    assert tr.busy_us(t) == 25  # [0, 15] and [30, 40] of the window [0, 50]
    assert tr.idle_gaps(t) == [("enqueue", 15), ("no span", 10)]
    assert tr.group_times(t) == {"gemm": 10.0, "K2 flash_attention_cm": 10.0,
                                 tr.OTHER: 10.0}  # the launch at 60 is past the window
    names = {n for n, _ in tr.STAGES} | {tr.BACKWARD}
    assert tr.stage_times(t, names) == {"encoder window blocks": 10.0, tr.BACKWARD: 20.0}
    b = tr.breakdown(t)
    assert b["idle_gaps"] == [["enqueue", 15e-6], ["no span", 10e-6]]
    assert [g for g, _ in b["device_ops"]] == ["gemm", "K2 flash_attention_cm", tr.OTHER]


def context(mode="infer", trace=None):
    conf = {"model": TINY, "flops_per_image": {"infer": {"64": 1e12}, "train": {"64": 3e12}}}
    return readers.Context(mode=mode, config=conf, traffic={"batch": 1, "dtype": "bfloat16"},
                           window={"window_s": 2.0, "batches": 4, "images": 4,
                                   "sizes": [64] * 4},
                           spans={"to_device": [0.001, 0.003], "matcher": [0.004] * 2},
                           trace=trace, traced_sizes=[64])


def test_readers_by_hand():
    ctx = context(trace=synthetic())
    assert readers.mean_span_ms(ctx, "to_device", "infer") == pytest.approx(2.0)
    assert readers.mean_span_ms(ctx, "to_device", "train") is None
    assert readers.span_ms_per_step(context("train"), "matcher", "train") == pytest.approx(2.0)
    assert readers.idle_share(ctx, "infer") == pytest.approx(50.0)
    assert readers.stage_ms(ctx, tr.ENCODER_STAGES, "infer") == pytest.approx(0.010)
    assert readers.stage_ms(ctx, tr.DECODER_STAGES, "infer") is None  # nothing to read
    # 4 steps of 1e12 FLOPs in 2 s over 989 TFLOP/s
    assert readers.mfu(ctx, "infer") == pytest.approx(100 * 4e12 / 2 / 989e12)
    least = ys.attention_least_s(TINY, 64, 1, False, "bfloat16")
    assert readers.roofline(ctx, tr.ATTENTION_GROUPS, ys.attention_least_s, "infer") == \
        pytest.approx(100 * least / 10e-6)
    assert readers.sampler_roofline(ctx, "infer") is None  # no points noted
    ctx.sampler_positions = [20]
    assert readers.sampler_roofline(ctx, "infer") is None  # no sampler kernel ran
    ctx.trace.launches.append((4, [("deform_attn_sep_kernel<2>", 1.0)]))
    assert readers.sampler_roofline(ctx, "infer") == pytest.approx(
        100 * ys.sampler_least_s(TINY, 64, 1, False, "bfloat16", [20]) / 1e-6)


@pytest.mark.parametrize("name", ["to_device_ms.infer", "idle_share.train", "mfu.infer",
                                  "attention_roofline.infer", "matcher_host_ms.train",
                                  "sampler_roofline.infer"])
def test_metric_files_are_found_by_name(name):
    read = common.metric_reader(name)
    mode = name.rsplit(".", 1)[1]
    value = read(context(mode, synthetic()))
    assert value is None or value >= 0


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_stored_flop_counts_recount(path):
    from perfbench.lib.flops import flops_per_image

    conf = json.loads(path.read_text())
    assert flops_per_image(conf["model"], conf["sizes"]["infer"], conf["sizes"]["train"]) == \
        conf["flops_per_image"]
