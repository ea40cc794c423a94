"""The port's span recorder (`lwdetr_tpu_torch/utils/trace.py`) on the CPU:
off by default at the cost of a flag read, totals and nesting when on, its
ranges on the profiler's timeline, the spans that one train step and one eval
batch record through the engine's loops, and the model's stage spans against
the stage boundaries that forward hooks on the same modules draw."""
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.data.loader import to_device
from lwdetr_tpu_torch.models.criterion import SetCriterion
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.train import engine
from lwdetr_tpu_torch.utils import trace
from lwdetr_tpu_torch.weights import init_state_dict

MICRO = ModelConfig(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
                    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
                    dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2,
                    dec_layers=2, group_detr=2, num_queries=12, num_select=10, num_classes=7,
                    two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
SIZE = 64


@pytest.fixture(autouse=True)
def fresh_recorder():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _range_events(prof):
    return [e for e in prof.events() if e.key.startswith(trace.PREFIX)]


def test_a_disabled_span_reads_no_clock_records_nothing_and_opens_no_range():
    def refuse(*args):
        raise AssertionError("a disabled span made a call")

    assert not trace.enabled()
    with mock.patch.object(trace.time, "perf_counter_ns", refuse), \
            mock.patch.object(torch.profiler, "record_function", refuse), \
            torch.profiler.profile() as prof:
        assert trace.span("a") is trace.span("b")  # one shared no-op
        with trace.span("step"):
            torch.ones(3).add_(1)
        assert trace.call("fetch", torch.zeros, 2).shape == (2,)
    assert trace.snapshot() == {}
    assert not _range_events(prof)


def test_an_enabled_span_records_calls_nanoseconds_and_nesting():
    clock = iter(range(0, 10 ** 6, 10))  # each reading 10 ns after the last
    with mock.patch.object(trace.time, "perf_counter_ns", lambda: next(clock)):
        trace.enable()
        for _ in range(2):
            with trace.span("step"):  # readings t, then the inner two, then t + 30
                with trace.span("matcher"):
                    pass
        trace.disable()
        with trace.span("step"):  # off again: nothing more
            pass
    snap = trace.snapshot()
    assert snap == {"matcher": {"calls": 2, "ns": 20, "per_call_ns": []},
                    "step": {"calls": 2, "ns": 60, "per_call_ns": [30, 30]}}
    assert trace.mean_ms(snap, "step") == pytest.approx(30e-6)
    assert trace.mean_ms(snap, "fetch") is None
    trace.reset()
    assert trace.snapshot() == {}


def test_recording_turns_on_for_its_block_and_a_span_stays_open_through_a_raise():
    with pytest.raises(ValueError):
        with trace.recording():
            assert trace.enabled()
            with trace.span("fetch"):
                raise ValueError("the block's own error")
    assert not trace.enabled()
    assert trace.snapshot()["fetch"]["calls"] == 1


def test_a_span_range_on_the_profiler_timeline_holds_the_operators_launched_in_it():
    a = torch.randn(32, 32)
    with trace.recording(), torch.profiler.profile() as prof:
        with trace.span("forward"):
            with trace.span("heads"):
                b = a @ a
            b.relu_()
        a.sum()
    events = prof.events()
    ranges = {e.key: e.time_range for e in _range_events(prof)}
    assert set(ranges) == {"lwdetr:forward", "lwdetr:heads"}

    def inside(op, name):
        r = ranges[name]
        return [r.start <= e.time_range.start and e.time_range.end <= r.end
                for e in events if e.key == op]

    assert inside("aten::mm", "lwdetr:heads") == [True]
    assert inside("aten::relu_", "lwdetr:forward") == [True]
    assert inside("aten::relu_", "lwdetr:heads") == [False]
    assert inside("aten::sum", "lwdetr:forward") == [False]
    assert trace.snapshot()["heads"]["calls"] == 1


# -- the spans of one train step and one eval batch through the engine's loops ----------------

# a forward of MICRO (one window block, one global block, one level, two
# decoder layers, lite refinement, two-stage), each stage's spans: proposals
# once a query group in the decoder's two-stage heads and once a group for
# the encoder outputs' class heads; norms three a layer, the query-position
# head once, the final norm a layer; the FFN's two products a layer; the
# heads' box and class products
STAGE_CALLS = {"patch embed": 1, "window blocks": 1, "global blocks": 1, "projector": 1,
               "decoder self-attention": 2, "decoder cross-attention": 2, "decoder FFN": 4,
               "decoder norms": 9, "heads": 2}


def _train_batch(seed):
    g = torch.Generator().manual_seed(seed)
    valid = torch.zeros(2, 4, dtype=torch.bool)
    valid[:, :2] = True
    return {"images": torch.randn(2, SIZE, SIZE, 3, generator=g).numpy(),
            "labels": torch.randint(1, 7, (2, 4), generator=g).numpy(),
            "boxes": (torch.rand(2, 4, 4, generator=g) * 0.4 + 0.2).numpy(),
            "valid": valid.numpy(), "image_id": np.arange(2)}


def test_one_train_step_records_the_loops_phases_and_stages():
    tcfg = TrainConfig(ia_bce_loss=True, use_ema=True, max_gt=4)
    state = engine.create_train_state(MICRO, tcfg, niter_per_ep=10, device="cpu",
                                      state_dict=init_state_dict(MICRO, 0))
    step = engine.build_train_step(state, SetCriterion(MICRO, tcfg), tcfg,
                                   static_zero_drop_path=True, static_zero_dropout=True)
    put = lambda b: to_device(b, "cpu")  # noqa: E731
    engine.train_one_epoch(step, state, [_train_batch(0)], 0, 10, put_fn=put,
                           logger=lambda s: None)  # warm: nothing recorded
    assert trace.snapshot() == {}
    with trace.recording():
        engine.train_one_epoch(step, state, [_train_batch(1), _train_batch(2)], 0, 10,
                               put_fn=put, logger=lambda s: None)
    calls = {k: v["calls"] for k, v in trace.snapshot().items()}
    steps = 2
    per_step = dict(STAGE_CALLS, proposals=2 * MICRO.group_detr, value_panels=2, matcher=1,
                    to_device=1, step=1, **{"metric fetch": 1}, forward=1, criterion=1,
                    backward=1, optimizer=1)
    # the loader's last wait finds it run out
    assert calls == dict({k: v * steps for k, v in per_step.items()}, loader=steps + 1)
    snap = trace.snapshot()
    assert all(len(snap[k]["per_call_ns"]) == steps for k in trace.PHASES)
    phases = sum(snap[k]["ns"] for k in trace.PHASES)
    assert 0 < phases <= snap["step"]["ns"]


class Collector:
    def __init__(self):
        self.images = 0

    def update(self, results):
        self.images += len(results)

    def export(self):
        return None

    def summarize(self):
        return {}


def test_one_eval_batch_records_the_loops_and_stages():
    model = build_model(MICRO, device="cpu", state_dict=init_state_dict(MICRO, 0))
    eval_step = engine.build_eval_step(model, MICRO.num_select)
    g = torch.Generator().manual_seed(0)
    batch = {"images": torch.randn(2, SIZE, SIZE, 3, generator=g).numpy(),
             "orig_size": np.full((2, 2), SIZE, np.float32), "image_id": np.arange(2)}
    put = lambda b: to_device(b, "cpu")  # noqa: E731
    collector = Collector()
    with trace.recording():
        engine.evaluate(eval_step, [batch], collector, put_fn=put, logger=lambda s: None)
    assert collector.images == 2
    calls = {k: v["calls"] for k, v in trace.snapshot().items()}
    # eval: one query group; the channel-major values (a short memory): no panels
    assert calls == dict(STAGE_CALLS, proposals=2, post_process=1, to_device=1, step=1, fetch=1,
                         evaluator=1, loader=2)


# -- the stage spans against forward hooks on the same modules -------------------------------

def _stage_of(ranges, t):
    inside = [r for r in ranges if r[0] <= t <= r[1]]
    return min(inside, key=lambda r: r[1] - r[0])[2] if inside else None


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_the_stage_spans_draw_the_forward_hooks_stage_boundaries(train):
    """Every operator of a forward (and in train mode of the criterion and
    the backward) falls in the innermost stage span of the program that
    matches the innermost stage range of forward hooks hung on the stages'
    modules (the module patterns of the benchmark's frozen copy of
    `breakdown.py`'s stages), and in no stage span where it falls in none of
    those ranges: the device time by stage reads the same either way."""
    from perfbench.lib import trace as hooks

    renamed = {"encoder window blocks": "window blocks", "encoder global blocks": "global blocks",
               "two-stage proposals": "proposals",
               "decoder norms, reference points": "decoder norms"}
    stage_names = {name for name, _ in hooks.STAGES}
    assert {renamed.get(n, n) for n in stage_names} == set(trace.STAGES)
    tcfg = TrainConfig(ia_bce_loss=True, max_gt=4)
    model = build_model(MICRO, device="cpu", state_dict=init_state_dict(MICRO, 0), train=train)
    batch = to_device(_train_batch(3), "cpu")
    stages = hooks.StageRanges(model)
    stages.enabled = True
    with torch.set_grad_enabled(train), trace.recording(), torch.profiler.profile() as prof:
        out = model(batch["images"])
        if train:
            total, _ = SetCriterion(MICRO, tcfg)(out, engine._targets(batch), train=True)
            total.backward()
    stages.remove()
    program = [(e.time_range.start, e.time_range.end, e.key[len(trace.PREFIX):])
               for e in prof.events() if e.key[len(trace.PREFIX):] in trace.STAGES]
    hooked = [(e.time_range.start, e.time_range.end, renamed.get(e.key, e.key))
              for e in prof.events() if e.key in stage_names]
    ops = [e for e in prof.events() if e.key.startswith("aten::")]
    assert program and hooked and len(ops) > 100
    pairs = Counter((_stage_of(hooked, e.time_range.start), _stage_of(program, e.time_range.start))
                    for e in ops)
    assert all(a == b for a, b in pairs), {k: v for k, v in pairs.items() if k[0] != k[1]}
    assert {a for a, _ in pairs} >= set(trace.STAGES) | {None}


# -- on the card ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_recording_through_a_train_chains_capture_and_replays():
    """The step body's spans run on the host at the chain's warm-up steps and
    its capture, with recording on; the replays run no host code and record
    nothing more, and the replayed steps still move the parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tcfg = TrainConfig(ia_bce_loss=True, use_ema=True, max_gt=4)
    state = engine.create_train_state(MICRO, tcfg, niter_per_ep=10, device="cuda",
                                      state_dict=init_state_dict(MICRO, 0))
    batch = {k: torch.as_tensor(v).cuda() for k, v in _train_batch(4).items() if k != "image_id"}
    with trace.recording():
        chain = engine.build_train_chain(state, SetCriterion(MICRO, tcfg), tcfg, batch, 10,
                                         static_zero_drop_path=True, static_zero_dropout=True,
                                         warmup=2)
        captured = {k: v["calls"] for k, v in trace.snapshot().items()}
        before = state.model.class_embed.weight.detach().clone()
        losses = [float(chain(1)["loss"]) for _ in range(3)]
    assert {k: captured[k] for k in trace.PHASES} == dict.fromkeys(trace.PHASES, 3)
    assert {k: v["calls"] for k, v in trace.snapshot().items()} == captured
    assert all(np.isfinite(losses)) and state.step == 3
    assert not torch.equal(before, state.model.class_embed.weight)
