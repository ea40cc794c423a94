"""The port's matcher and criterion against the JAX package's, on the CPU in
f32: the same predictions and targets, made from a seed with numpy, go to both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models import criterion as jcrit
from lwdetr_tpu.models import matcher as jmatcher
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import criterion as tcrit
from lwdetr_tpu_torch.models import matcher as tmatcher

B, G, QG, K, T = 3, 2, 10, 7, 6
VALID = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0], [0, 0, 0, 0, 0, 0]], bool)
MCFG = ModelConfig(dec_layers=3, group_detr=G, num_queries=QG, num_classes=K, two_stage=True,
                   bbox_reparam=True, lite_refpoint_refine=True, aux_loss=True)
VARIANTS = {"ia_bce": dict(ia_bce_loss=True), "focal": {},
            "varifocal": dict(use_varifocal_loss=True),
            "position_supervised": dict(use_position_supervised_loss=True)}


def _predictions(seed, sets=1):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((sets, B, G * QG, K)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (sets, B, G * QG, 2)),
                            rng.uniform(0.05, 0.4, (sets, B, G * QG, 2))], -1).astype(np.float32)
    return logits, boxes


def _targets(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K, (B, T)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)),
                            rng.uniform(0.05, 0.4, (B, T, 2))], -1).astype(np.float32)
    return labels, boxes, VALID.copy()


def _both_targets(seed):
    labels, boxes, valid = _targets(seed)
    return (jcrit.Targets(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid)),
            tcrit.Targets(torch.from_numpy(labels), torch.from_numpy(boxes),
                          torch.from_numpy(valid)))


def test_cost_matrix_matches_jax():
    logits, boxes = _predictions(0)
    labels, tboxes, valid = _targets(1)
    cost = tmatcher.match_cost_matrix(torch.from_numpy(logits[0]), torch.from_numpy(boxes[0]),
                                      torch.from_numpy(labels), torch.from_numpy(tboxes),
                                      torch.from_numpy(valid), 2.0, 5.0, 2.0, 0.25)
    assert cost.shape == (B, T, G * QG)
    for b in range(B):
        ref = jmatcher.match_cost_matrix(jnp.asarray(logits[0, b]), jnp.asarray(boxes[0, b]),
                                         jnp.asarray(labels[b]), jnp.asarray(tboxes[b]),
                                         jnp.asarray(valid[b]), 2.0, 5.0, 2.0, 0.25)
        np.testing.assert_allclose(cost[b].numpy(), np.asarray(ref), atol=1e-5)
    assert not cost[2].any()  # an image without targets: all rows padded


def test_assignment_is_optimal_like_the_jax_solver():
    logits, boxes = _predictions(2, sets=2)
    labels, tboxes, valid = _targets(3)
    matched = tmatcher.hungarian_match(
        torch.from_numpy(logits), torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(tboxes), torch.from_numpy(valid), group_detr=G)
    assert matched.shape == (2, B, G, T) and matched.dtype == torch.int64
    cost = tmatcher.match_cost_matrix(torch.from_numpy(logits), torch.from_numpy(boxes),
                                      torch.from_numpy(labels), torch.from_numpy(tboxes),
                                      torch.from_numpy(valid)).numpy()  # (S, B, T, Q)
    for s in range(2):
        ref = np.asarray(jmatcher.hungarian_match(
            jnp.asarray(logits[s]), jnp.asarray(boxes[s]), jnp.asarray(labels),
            jnp.asarray(tboxes), jnp.asarray(valid), group_detr=G))
        for b in range(B):
            rows = np.nonzero(valid[b])[0]
            for g in range(G):
                cols = matched[s, b, g].numpy()[rows]
                # distinct queries of this group, global indices
                assert len(set(cols.tolist())) == len(rows)
                assert ((cols >= g * QG) & (cols < (g + 1) * QG)).all()
                # equal total cost on the valid rows (not equal indices: ties;
                # the JAX solver's padded rows hold junk)
                total = cost[s, b, rows, cols].sum()
                total_ref = cost[s, b, rows, ref[b, g][rows]].sum()
                assert total == pytest.approx(total_ref, abs=1e-5)


def test_assignment_beats_every_other_on_a_small_problem():
    # 3 targets, 4 queries: brute force over all injective maps
    import itertools

    logits, boxes = _predictions(4)
    labels, tboxes, valid = _targets(5)
    lg, bx = torch.from_numpy(logits[0, :, :4]), torch.from_numpy(boxes[0, :, :4])
    args = (torch.from_numpy(labels), torch.from_numpy(tboxes), torch.from_numpy(valid))
    matched = tmatcher.hungarian_match(lg, bx, *args, group_detr=1)
    cost = tmatcher.match_cost_matrix(lg, bx, *args).numpy()
    rows = np.nonzero(valid[0])[0]
    best = min(sum(cost[0, r, c] for r, c in zip(rows, perm))
               for perm in itertools.permutations(range(4), len(rows)))
    assert cost[0, rows, matched[0, 0].numpy()[rows]].sum() == pytest.approx(best, abs=1e-6)


def _matched(seed, logits, boxes, ttargets):
    """The port's matching of one output set, for both sides."""
    m = tmatcher.hungarian_match(torch.from_numpy(logits), torch.from_numpy(boxes),
                                 ttargets.labels, ttargets.boxes, ttargets.valid, group_detr=G)
    return m, jnp.asarray(m.numpy().astype(np.int32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_classification_loss_and_gradient_match_jax(variant):
    logits, boxes = _predictions(6)
    jt, tt = _both_targets(7)
    tm, jm = _matched(8, logits[0], boxes[0], tt)
    num_boxes = float(VALID.sum() * G)

    def jloss(lg, bx):
        return jcrit.classification_loss(lg, bx, jm, jt, jnp.float32(num_boxes), variant, 0.25)

    ref, (jdl, jdb) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(logits[0]),
                                                                jnp.asarray(boxes[0]))
    tl = torch.from_numpy(logits[0]).requires_grad_()
    tb = torch.from_numpy(boxes[0]).requires_grad_()
    loss = tcrit.classification_loss(tl, tb, tm, tt, torch.tensor(num_boxes), variant, 0.25)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref), rel=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jdl), atol=1e-5)
    # the IoU target is detached: no gradient reaches the boxes from this loss
    assert tb.grad is None or not tb.grad.any()
    assert not np.asarray(jdb).any()


def test_box_losses_diagnostics_and_gradients_match_jax():
    logits, boxes = _predictions(9)
    jt, tt = _both_targets(10)
    tm, jm = _matched(11, logits[0], boxes[0], tt)
    num_boxes = float(VALID.sum() * G)

    def jloss(bx):
        l1, giou = jcrit.box_losses(bx, jm, jt, jnp.float32(num_boxes))
        return 5.0 * l1 + 2.0 * giou, (l1, giou)

    (_, (jl1, jgiou)), jdb = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(boxes[0]))
    tb = torch.from_numpy(boxes[0]).requires_grad_()
    l1, giou = tcrit.box_losses(tb, tm, tt, torch.tensor(num_boxes))
    (5.0 * l1 + 2.0 * giou).backward()
    assert l1.item() == pytest.approx(float(jl1), rel=1e-5)
    assert giou.item() == pytest.approx(float(jgiou), rel=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), atol=1e-5)

    jce, jcard = jcrit.diagnostics(jnp.asarray(logits[0]), jm, jt)
    ce, card = tcrit.diagnostics(torch.from_numpy(logits[0]), tm, tt)
    assert ce.item() == pytest.approx(float(jce), abs=1e-4)
    assert card.item() == pytest.approx(float(jcard), abs=1e-6)


def _outputs(seed):
    """Model outputs with two auxiliary sets and the encoder set, for both sides."""
    logits, boxes = _predictions(seed, sets=4)

    def build(conv):
        sets = [{"pred_logits": conv(logits[i]), "pred_boxes": conv(boxes[i])} for i in range(4)]
        return {**sets[0], "aux_outputs": sets[1:3], "enc_outputs": sets[3]}

    return build(jnp.asarray), build(lambda a: torch.from_numpy(a).requires_grad_())


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("sum_group_losses", [False, True], ids=["per-group", "summed"])
def test_set_criterion_matches_jax(variant, sum_group_losses):
    flags = dict(VARIANTS[variant], cls_loss_coef=1.0, sum_group_losses=sum_group_losses)
    jc = jcrit.SetCriterion(JaxModelConfig(**dataclasses.asdict(MCFG)), JaxTrainConfig(**flags))
    tc = tcrit.SetCriterion(MCFG, TrainConfig(**flags))
    assert tc.variant == jc.variant == variant and tc.weight_dict() == jc.weight_dict()
    jout, tout = _outputs(12)
    jt, tt = _both_targets(13)
    jtotal, jlosses = jc(jout, jt, train=True)  # its own matching, on the device
    total, losses = tc(tout, tt, train=True)  # its own matching, on the host
    assert set(losses) == set(jlosses)
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert total.item() == pytest.approx(float(jtotal), rel=1e-5)


def test_set_criterion_gradients_match_jax():
    flags = dict(ia_bce_loss=True, cls_loss_coef=1.0)
    jc = jcrit.SetCriterion(JaxModelConfig(**dataclasses.asdict(MCFG)), JaxTrainConfig(**flags))
    tc = tcrit.SetCriterion(MCFG, TrainConfig(**flags))
    jout, tout = _outputs(14)
    jt, tt = _both_targets(15)
    grads = jax.grad(lambda o: jc(o, jt, train=True)[0])(jout)
    total, _ = tc(tout, tt, train=True)
    total.backward()
    pairs = [(tout, grads)] + list(zip(tout["aux_outputs"], grads["aux_outputs"])) \
        + [(tout["enc_outputs"], grads["enc_outputs"])]
    for t, j in pairs:
        for key in ("pred_logits", "pred_boxes"):
            np.testing.assert_allclose(t[key].grad.numpy(), np.asarray(j[key]), atol=1e-5)


def test_eval_losses_use_one_group_and_a_given_matching_is_used():
    tc = tcrit.SetCriterion(MCFG, TrainConfig(ia_bce_loss=True))
    jc = jcrit.SetCriterion(JaxModelConfig(**dataclasses.asdict(MCFG)),
                            JaxTrainConfig(ia_bce_loss=True))
    jout, tout = _outputs(16)
    jt, tt = _both_targets(17)
    first = lambda o: {k: (v[:, :QG] if not isinstance(v, (list, dict)) else v)  # noqa: E731
                       for k, v in o.items() if k in ("pred_logits", "pred_boxes")}
    jtotal, _ = jc(first(jout), jt, train=False)
    with torch.no_grad():
        total, losses = tc(first(tout), tt, train=False)
        assert total.item() == pytest.approx(float(jtotal), rel=1e-5)
        # a matching handed in replaces the criterion's own
        matched = tc.match(first(tout)["pred_logits"][None], first(tout)["pred_boxes"][None], tt, 1)
        again, _ = tc(first(tout), tt, train=False, matched=matched)
        other, _ = tc(first(tout), tt, train=False, matched=(matched + 1) % QG)
    assert again.item() == total.item() and other.item() != total.item()
