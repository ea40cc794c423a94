"""A reduced model of the tiny preset's shape (one P4 level, 2 sampling points,
self-attention heads of 32 channels over fewer than 128 queries, so that the
decoder's self-attention takes the short kernel without a bias) against the
JAX package, on the CPU in f32: the eval forward, one train step's gradients
in each cross-attention branch, and the eval-mode forward differentiated. The
JAX model is initialized from a PRNG key, its variables cross into the port
through `weights.state_dict_from_jax`, gradients come back through
`weights.grads_from_jax`, and the same numpy batch goes through both. On the
CPU the JAX model samples through its gather formulation; every branch
computes the same function.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.criterion import Targets as JaxTargets
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig, get_config
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.ops import flash_attention as tfa
from lwdetr_tpu_torch.weights import grads_from_jax, state_dict_from_jax

PICO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=2, ca_nheads=4, dec_n_points=2, dec_layers=2, group_detr=2, num_queries=10,
    num_select=10, num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, max_gt=6)
IMG, BATCH = 128, 2
BRANCH_WRAPPER = {"cm": "ms_deform_attn_cm", "sep": "ms_deform_attn_sep_panels",
                  "gather": "ms_deform_attn"}


def test_pico_has_the_tiny_presets_shape():
    tiny = get_config("tiny")
    assert tiny.num_queries == 100 <= tfa._WINDOW_MAX_N and PICO.num_queries <= tfa._WINDOW_MAX_N
    for cfg in (tiny, PICO):
        assert cfg.projector_scale == ("P4",) and cfg.dec_n_points == 2
        assert cfg.hidden_dim // cfg.sa_nheads == 32 and cfg.hidden_dim // cfg.ca_nheads == 16


@pytest.fixture(scope="module")
def bridged():
    jm = JaxModelConfig(**dataclasses.asdict(PICO))
    jmodel = jax_build_model(jm)
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    rng = np.random.default_rng(5)
    # no head or offset projection stays zero
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    batch = {
        "images": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
        "labels": rng.integers(0, PICO.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[2], [4]]),
    }
    return jm, jmodel, params, stats, state_dict_from_jax(params, stats, PICO), batch


def _spied(fn):
    """Run fn() and count the calls of the attention and sampler wrappers."""
    fa_names = ("window_attention", "window_attention_bias", "flash_attention_cm")
    fa_spies = {n: mock.Mock(wraps=getattr(tfa, n)) for n in fa_names}
    da_spies = {n: mock.Mock(wraps=getattr(tda, n)) for n in BRANCH_WRAPPER.values()}
    with mock.patch.multiple(tfa, **fa_spies), mock.patch.multiple(tda, **da_spies):
        result = fn()
    return result, {n: s.call_count for n, s in {**fa_spies, **da_spies}.items()}


def _rel_errors(named_grads, ref):
    """Per tensor: max |difference| over the tensor's largest reference
    gradient, floored at 1e-6 of the largest gradient of all (a gradient that is
    zero in exact arithmetic is rounding noise on both sides)."""
    assert set(named_grads) == set(ref)
    top = max(g.abs().max().item() for g in ref.values())
    return {n: ((named_grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-6 * top)).item()
            for n, g in ref.items()}


@pytest.mark.parametrize("branch", [None, "cm", "sep", "gather"])
def test_eval_forward_matches_jax_in_each_branch(bridged, branch):
    _, jmodel, params, stats, sd, batch = bridged
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(batch["images"]))
    tmodel = ttr.set_force_branch(build_model(PICO, device="cpu", state_dict=sd), branch)
    with torch.no_grad():
        tout, calls = _spied(lambda: tmodel(torch.from_numpy(batch["images"])))
    # the two ViT blocks carry a qkv bias and see at most 64 tokens of a 128x128
    # image (the short kernel with a bias); the decoder's two self-attentions
    # have no bias and 10 queries (the short kernel without); two cross-attentions
    taken = BRANCH_WRAPPER[branch or "cm"]
    assert calls == {"window_attention": 2, "window_attention_bias": 2, "flash_attention_cm": 0,
                     **{n: 2 * int(n == taken) for n in BRANCH_WRAPPER.values()}}
    for key in ("pred_logits", "pred_boxes"):
        assert tout[key].shape == (BATCH, PICO.num_queries, tout[key].shape[-1])
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=1e-4)
        np.testing.assert_allclose(tout["enc_outputs"][key].numpy(),
                                   np.asarray(jout["enc_outputs"][key]), atol=1e-4)


@pytest.fixture(scope="module")
def train_reference(bridged):
    """The port's train-mode forward in its default branch, its matching, and
    the JAX package's loss and parameter gradients on that matching."""
    jm, jmodel, params, stats, sd, batch = bridged
    jcrit = JaxSetCriterion(jm, JaxTrainConfig(**dataclasses.asdict(TCFG)))
    tcrit = SetCriterion(PICO, TCFG)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    targets = Targets(tb["labels"], tb["boxes"], tb["valid"])
    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))
    tmodel = build_model(PICO, device="cpu", state_dict=sd, train=True)
    with torch.no_grad():
        tout = tmodel(tb["images"])
    sets = [tout] + tout["aux_outputs"] + [tout["enc_outputs"]]
    matched = tcrit.match(torch.stack([s["pred_logits"] for s in sets]),
                          torch.stack([s["pred_boxes"] for s in sets]), targets, PICO.group_detr)
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(2)})
        num_boxes = jnp.maximum(jnp.sum(jtargets.valid.astype(jnp.float32)) * PICO.group_detr, 1.0)
        jsets = [(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
        jsets.append((out["enc_outputs"], "_enc", False))
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(jsets):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, PICO.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        return sum(jlosses[k] * w for k, w in jcrit.weight_dict().items())

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = grads_from_jax(jax.tree.map(np.asarray, jgrads), PICO)
    return tcrit, tb, targets, matched, float(jtotal), ref


@pytest.mark.parametrize("branch", [None, "cm", "gather"])
def test_train_step_gradients_match_jax_grad_in_each_branch(bridged, train_reference, branch):
    sd = bridged[4]
    tcrit, tb, targets, matched, jtotal, ref = train_reference
    tmodel = ttr.set_force_branch(build_model(PICO, device="cpu", state_dict=sd, train=True),
                                  branch)

    def step():
        total, _ = tcrit(tmodel(tb["images"]), targets, train=True, matched=matched)
        total.backward()
        return total.item()

    total, calls = _spied(step)
    # 2 groups of 10 queries folded into the batch: still the short kernel
    taken = BRANCH_WRAPPER[branch or "sep"]
    assert calls == {"window_attention": 2, "window_attention_bias": 2, "flash_attention_cm": 0,
                     **{n: 2 * int(n == taken) for n in BRANCH_WRAPPER.values()}}
    assert total == pytest.approx(jtotal, abs=1e-4)
    rel = _rel_errors({n: p.grad for n, p in tmodel.named_parameters()}, ref)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    # max abs error relative to the tensor's largest gradient
    assert worst[0][1] <= 1e-3, worst


def test_eval_mode_forward_is_differentiable_and_matches_jax_grad(bridged):
    """`jax.grad` of `apply(train=False)`: one query group, running batch
    statistics, the channel-major sampler (K3's Function, whose backward is
    K8's plain version here) and the short attention without a bias."""
    _, jmodel, params, stats, sd, batch = bridged
    rng = np.random.default_rng(17)
    wl = rng.standard_normal((BATCH, PICO.num_queries, PICO.num_classes)).astype(np.float32)
    wb = rng.standard_normal((BATCH, PICO.num_queries, 4)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                           train=False)
        return (jnp.sum(out["pred_logits"] * wl) + jnp.sum(out["pred_boxes"] * wb)
                + jnp.sum(out["enc_outputs"]["pred_logits"] * wl))

    jtotal, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    ref = grads_from_jax(jax.tree.map(np.asarray, jgrads), PICO)
    tmodel = build_model(PICO, device="cpu", state_dict=sd).requires_grad_(True)
    assert not tmodel.training

    def step():
        out = tmodel(torch.from_numpy(batch["images"]))
        total = ((out["pred_logits"] * torch.from_numpy(wl)).sum()
                 + (out["pred_boxes"] * torch.from_numpy(wb)).sum()
                 + (out["enc_outputs"]["pred_logits"] * torch.from_numpy(wl)).sum())
        total.backward()
        return total.item()

    total, calls = _spied(step)
    assert calls["ms_deform_attn_cm"] == 2 and calls["ms_deform_attn_sep_panels"] == 0
    assert total == pytest.approx(float(jtotal), abs=1e-4)
    # only group 0's heads and queries reach an eval output (the two-stage head
    # through the encoder outputs alone); the others get no gradient
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in tmodel.named_parameters()}
    assert grads["transformer.enc_output.0.weight"].abs().max() > 0
    assert not grads["transformer.enc_output.1.weight"].any()
    rel = _rel_errors(grads, ref)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    assert worst[0][1] <= 1e-3, worst
