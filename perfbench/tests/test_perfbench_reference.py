"""The plain reference against the port's CPU path at the micro size.

The test imports both; the reference itself imports nothing of the port.
One state dict, drawn by the benchmark, goes into both: the eval forward's
outputs and one release-recipe train step (losses, first gradients as AdamW
got them, the parameters' change) must agree to float32 rounding.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import weights  # noqa: E402
from perfbench.reference import model as ref  # noqa: E402
from perfbench.reference import train as rtrain  # noqa: E402

MICRO = dict(encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
             out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64,
             dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2,
             group_detr=2, num_queries=12, num_select=10, two_stage=True,
             lite_refpoint_refine=True, bbox_reparam=True)


def configs(**over):
    from lwdetr_tpu_torch.config import ModelConfig, get_train_config

    mc = ModelConfig(**dict(MICRO, **over))
    tc = get_train_config("small", max_gt=6)
    as_dict = lambda c: {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}  # noqa: E731
    return mc, tc, as_dict(mc), as_dict(tc)


@pytest.mark.parametrize("levels", [("P4",), ("P3", "P5")])
def test_eval_forward_matches_the_port(levels):
    from lwdetr_tpu_torch.models.lwdetr import build_model, post_process

    mc, _, cfg, _ = configs(projector_scale=levels)
    sd = weights.make_state_dict(ref.state_shapes(cfg), 2 ** 31 + 7, "cpu")
    port = build_model(mc, device="cpu", state_dict=sd)
    net = ref.build(cfg, sd)
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    sizes = torch.tensor([[480.0, 640.0], [640.0, 427.0]])
    with torch.no_grad():
        a, b = port(x), net(x)
        for key in ("pred_logits", "pred_boxes"):
            assert (a[key] - b[key]).abs().max() < 1e-4, key
            assert (a["enc_outputs"][key] - b["enc_outputs"][key]).abs().max() < 1e-4, key
        for got, want in zip(post_process(a["pred_logits"], a["pred_boxes"], sizes, 10),
                             ref.post_process(b["pred_logits"], b["pred_boxes"], sizes, 10)):
            assert torch.allclose(got.float(), want.float(), atol=1e-3)


def _batch(g, size, counts, T=6):
    B = len(counts)
    labels = torch.zeros(B, T, dtype=torch.int32)
    boxes = torch.tensor([0.5, 0.5, 1.0, 1.0]).repeat(B, T, 1)
    valid = torch.zeros(B, T, dtype=torch.bool)
    for i, n in enumerate(counts):
        labels[i, :n] = torch.randint(1, 91, (n,), generator=g)
        wh = torch.rand(n, 2, generator=g) * 0.4 + 0.05
        c = torch.rand(n, 2, generator=g) * (1 - wh) + wh / 2
        boxes[i, :n] = torch.cat([c, wh], -1)
        valid[i, :n] = True
    return {"images": torch.randn(B, size, size, 3, generator=g), "labels": labels,
            "boxes": boxes, "valid": valid}


def test_train_steps_match_the_port():
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.train import engine

    mc, tc, cfg, tcfg = configs()
    sd = weights.make_state_dict(ref.state_shapes(cfg), 11, "cpu")
    state = engine.create_train_state(mc, tc, 100, device="cpu", state_dict=sd)
    step = engine.build_train_step(state, SetCriterion(mc, tc), tc)
    trainer = rtrain.Trainer(ref.build(cfg, sd, train=True), cfg, tcfg)
    g = torch.Generator().manual_seed(1)
    batches = [_batch(g, s, [2, 5, 0]) for s in (128, 192, 128)]
    p0 = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    losses = []
    for k, b in enumerate(batches):
        losses.append(float(step(b)["loss"]))
        if k == 0:
            grads = {n: state.optimizer.state[p]["exp_avg"] / 0.1
                     for n, p in state.model.named_parameters()}
    for k, b in enumerate(batches):
        targets = [{"labels": b["labels"][i][b["valid"][i]].long(),
                    "boxes": b["boxes"][i][b["valid"][i]]} for i in range(3)]
        assert abs(trainer.step(b["images"], targets) - losses[k]) < 1e-5 * abs(losses[k])
    delta = {n: p.detach() - p0[n] for n, p in state.model.named_parameters()}
    ref_delta = {n: p.detach() - sd[n] for n, p in trainer.model.named_parameters()}
    assert rtrain.leaf_gaps(grads, trainer.first_grads, trainer.first_grads)[0] < 1e-4
    assert rtrain.leaf_gaps(delta, ref_delta, trainer.first_grads)[0] < 1e-3


def test_leaf_gaps_leaves_out_round_off_leaves_and_reads_one_for_an_unmoved_state():
    ref_g = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.full((4,), 1e-9)}
    moved = {"a": torch.ones(4), "b": torch.full((4,), 2.0), "c": torch.zeros(4)}
    gap, leaf, n, out = rtrain.leaf_gaps(moved, ref_g, ref_g)
    assert (gap, n, out) == (0.0, 2, ["c"])
    unmoved = {k: torch.zeros(4) for k in ref_g}
    assert rtrain.leaf_gaps(unmoved, ref_g, ref_g)[0] == 1.0
