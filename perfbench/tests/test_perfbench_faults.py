"""The output check fails a broken program. On the CPU at the micro size, the
harness runs whole (no look for a card) with the timed path broken
underneath, under the limits of the real cells, and `correct` comes out
false for each fault the cell can have; the same run unbroken passes.

Faults: inference, an answer altered where it is produced (one image's
scores raised by one logit in `post_process`) and half of the batch left out
(the other half given its answers); training, a step that leaves the state
unchanged (AdamW's step does nothing), an EMA left unchanged, and half of
each batch left out (the mean taken over the rest). A one-card cell has no
exchange between chips.
"""
import contextlib
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness_micro import make_root, micro_settings  # noqa: E402
from perfbench.lib import common, harness  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"),
                     limits_from={"micro.infer": "large.infer_b32",
                                  "micro.train": "small.train_b32"})


def altered_answers():
    from lwdetr_tpu_torch.train import engine

    produce = engine.post_process

    def post_process(logits, boxes, sizes, num_select):
        scores, labels, boxes = produce(logits, boxes, sizes, num_select=num_select)
        scores = scores.clone()
        scores[0] = torch.sigmoid(torch.logit(scores[0]) + 1.0)
        return scores, labels, boxes

    return mock.patch.object(engine, "post_process", post_process)


def half_batch_infer():
    from lwdetr_tpu_torch.models.lwdetr import LWDETR

    forward = LWDETR.forward

    def halved(self, images, *args, **kwargs):
        n = images.shape[0]
        out = forward(self, images[:max(1, n // 2)], *args, **kwargs)
        return {k: torch.cat([v] * 2)[:n] if torch.is_tensor(v) else v for k, v in out.items()}

    return mock.patch.object(LWDETR, "forward", halved)


def unchanged_state():
    return mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None)


def unchanged_ema():
    from lwdetr_tpu_torch.train import optim

    return mock.patch.object(optim, "ema_update", lambda *args, **kwargs: None)


def half_batch_train():
    from lwdetr_tpu_torch.train import engine

    make = engine._step_body

    def step_body(*args):
        body = make(*args)

        def halved(batch, *rest):
            n = batch["images"].shape[0]
            return body({k: v[:max(1, n // 2)] for k, v in batch.items()}, *rest)

        return halved

    return mock.patch.object(engine, "_step_body", step_body)


FAULTS = {"micro.infer": [None, altered_answers, half_batch_infer],
          "micro.train": [None, unchanged_state, unchanged_ema, half_batch_train]}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", str(x)))
def test_a_broken_program_is_not_correct(root, workload, fault):
    cell = common.load_cell(workload, root)
    with micro_settings(), (fault() if fault else contextlib.nullcontext()):
        result = harness.run_cell(cell, 2 ** 33 + 1, 0.3, False, torch.device("cpu"),
                                  time.time(), root=root)
    items = result["checks"].items
    assert result["correct"] == (fault is None), items
