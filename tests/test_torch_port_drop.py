"""Stochastic depth, dropout and remat of the port's train step against the
JAX package, on the CPU at a reduced large-shaped size.

The model has the large / xlarge layout at narrow widths: P3 + P5 levels,
three ViT blocks (one window block), 4 cross-attention heads, 4 sampling
points, `drop_path=0.1` and `dropout=0.1`. The drop masks are drawn with numpy
from a seed and fed to both sides: to the port through its mask source
(`models/drop.py`), to the JAX package by patching `jax.random.bernoulli`
inside the test only. Both sides draw in the JAX modules' order (per ViT block
the attention's then the MLP's site; per decoder layer the self-attention
weights, then its output, the cross-attention's output, the two FFN
products), and each fed mask must have the shape of the site it lands on.
Gradients are compared on one matching (the port's), as in
`test_torch_port_train.py`.
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
from lwdetr_tpu.train import engine as jengine
from lwdetr_tpu.train import optim as joptim
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.train import engine, optim
from lwdetr_tpu_torch.weights import grads_from_jax, state_dict_from_jax

CFG = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=3, window_block_indexes=(0,),
    out_feature_indexes=(1, 2), projector_scale=("P3", "P5"), hidden_dim=64,
    dim_feedforward=128, sa_nheads=4, ca_nheads=4, dec_n_points=4, dec_layers=2,
    group_detr=2, num_queries=12, num_select=10, num_classes=7, two_stage=True,
    bbox_reparam=True, lite_refpoint_refine=True, drop_path=0.1, dropout=0.1)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, max_gt=6)
IMG, BATCH = 128, 2
RATES = [float(r) for r in optim.drop_path_rates_for(CFG.drop_path, CFG.vit_encoder_num_layers)]

# f32: the forwards' outputs within 1e-4 (tests/test_torch_port_train.py);
# each parameter's gradient within 1e-3 of its tensor's largest JAX gradient.
# Trap (a): a gradient that is zero in exact arithmetic is rounding noise on
# both sides. Here those are the biases of the P3 taps' transposed
# convolutions (a per-channel constant that the C2f's 1x1 convolution and its
# train-mode BatchNorm remove): about 1e-8 of the largest gradient of all, on
# both sides. A tensor whose largest JAX gradient is under ZERO_FLOOR of the
# largest of all is held to that absolute bound instead.
ATOL = 1e-4
GRAD_RTOL = 1e-3
ZERO_FLOOR = 1e-6


class Recorder:
    """A mask source that draws numpy masks from a seed, in the order and at
    the shapes the sites ask for, and keeps them to feed the JAX side."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def __call__(self, keep, shape, like):
        m = self.rng.random(tuple(shape)) < float(keep)
        self.masks.append(m)
        return torch.from_numpy(m).to(like.dtype)


def _fake_bernoulli(masks):
    """`jax.random.bernoulli` that hands out `masks` in order, checking shapes."""
    fed = iter(masks)

    def bernoulli(key, p, shape):
        m = next(fed)
        assert tuple(shape) == m.shape, (tuple(shape), m.shape)
        return jnp.asarray(m)

    return bernoulli


def _jax_cfgs(mcfg=CFG, tcfg=TCFG):
    return (JaxModelConfig(**dataclasses.asdict(mcfg)), JaxTrainConfig(**dataclasses.asdict(tcfg)))


@pytest.fixture(scope="module")
def bridged():
    jm, _ = _jax_cfgs()
    jmodel = jax_build_model(jm)
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    rng = np.random.default_rng(11)
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    batch = {
        "images": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
        "labels": rng.integers(0, CFG.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [4]]),
    }
    return params, stats, batch


def _targets(batch):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return Targets(tb["labels"], tb["boxes"], tb["valid"])


def _port_grads(params, stats, batch, masks, dtype=torch.float32, remat=False):
    """The port's train forward on fed masks, its matching, losses and
    parameter gradients, with the BatchNorm statistics left as they were."""
    cfg = dataclasses.replace(CFG, grad_checkpointing=remat)
    model = build_model(cfg, device="cpu", dtype=dtype,
                        state_dict=state_dict_from_jax(params, stats, cfg), train=True)
    source = drop.Fed(masks) if masks is not None else Recorder(5)
    picks = []
    select = ttr.select_proposals

    def spy(scores, k):
        picks.append(select(scores, k))
        return picks[-1]

    with mock.patch.object(ttr, "select_proposals", spy):
        out = model(torch.from_numpy(batch["images"]), None, RATES, CFG.dropout, source)
    crit = SetCriterion(cfg, TCFG)
    targets = _targets(batch)
    sets = [out] + out["aux_outputs"] + [out["enc_outputs"]]
    matched = crit.match(torch.stack([s["pred_logits"].detach().float() for s in sets]),
                         torch.stack([s["pred_boxes"].detach() for s in sets]), targets,
                         cfg.group_detr)
    total, _ = crit(out, targets, train=True, matched=matched)
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    used = source.masks if isinstance(source, Recorder) else None
    if isinstance(source, drop.Fed):
        assert source.used == len(source.masks)
    return out, grads, matched, used, [p.numpy() for p in picks]


def _fake_top_k(picks):
    """`jax.lax.top_k` that returns given indices in order (trap (d)'s replay)."""
    fed = iter(picks)

    def top_k(x, k):
        idx = jnp.asarray(next(fed))
        assert idx.shape == x.shape[:-1] + (k,)
        return jnp.take_along_axis(x, idx, axis=-1), idx

    return top_k


def _jax_grads(params, stats, batch, masks, matched, dtype=jnp.float32, picks=None):
    """JAX's output and parameter gradients on the fed masks and the port's
    matching; with `picks`, its two-stage heads take the port's proposals."""
    jm, jt = _jax_cfgs()
    jmodel = jax_build_model(jm, dtype=dtype)
    jcrit = JaxSetCriterion(jm, jt)
    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                              drop_path_rates=RATES, dropout_rate=CFG.dropout, train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        n_valid = jnp.sum(jtargets.valid.astype(jnp.float32))
        num_boxes = jnp.maximum(n_valid * CFG.group_detr, 1.0)
        jsets = [(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
        jsets.append((out["enc_outputs"], "_enc", False))
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(jsets):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, CFG.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        return sum(jlosses[k] * w for k, w in jcrit.weight_dict().items()), out

    top_k = jax.lax.top_k if picks is None else _fake_top_k(picks)
    with mock.patch.object(jax.random, "bernoulli", _fake_bernoulli(masks)), \
            mock.patch.object(jax.lax, "top_k", top_k):
        (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return jout, grads_from_jax(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads), CFG)


@pytest.fixture(scope="module")
def f32_step(bridged):
    params, stats, batch = bridged
    out, grads, matched, masks, _ = _port_grads(params, stats, batch, None)
    jout, jgrads = _jax_grads(params, stats, batch, masks, matched)
    return dict(out=out, grads=grads, matched=matched, masks=masks, jout=jout, jgrads=jgrads)


def test_the_sites_draw_in_the_jax_order_at_the_jax_shapes(f32_step):
    masks = f32_step["masks"]
    B, Bw = BATCH, BATCH * 16
    hw = (IMG // 16 // 4) ** 2
    Q, Qg = CFG.num_queries * CFG.group_detr, CFG.num_queries
    # block 0's rate is 0 on the ramp: it draws nothing, on either side
    vit = [(Bw, 1, 1)] * 2 * (CFG.vit_encoder_num_layers - 1)
    layer = [(B * CFG.group_detr, CFG.sa_nheads, Qg, Qg), (B, Q, CFG.hidden_dim),
             (B, Q, CFG.hidden_dim), (B, Q, CFG.dim_feedforward), (B, Q, CFG.hidden_dim)]
    assert [m.shape for m in masks] == vit + layer * CFG.dec_layers
    assert hw == 4  # a window row is (B * 16, hw) tokens: one mask a window, not an image
    kept = np.mean([m.mean() for m in masks[len(vit):]])
    assert 0.85 < kept < 0.95  # keep = 1 - 0.1


@pytest.mark.parametrize("key", ["pred_logits", "pred_boxes"])
def test_train_forward_with_fed_masks_matches_jax(f32_step, key):
    tout, jout = f32_step["out"], f32_step["jout"]
    pairs = [(tout, jout)] + list(zip(tout["aux_outputs"], jout["aux_outputs"])) \
        + [(tout["enc_outputs"], jout["enc_outputs"])]
    for t, j in pairs:
        np.testing.assert_allclose(t[key].detach().numpy(), np.asarray(j[key]), atol=ATOL)


def _zero_in_exact_arithmetic(ref):
    top = max(g.abs().max().item() for g in ref.values())
    return {n for n, g in ref.items() if g.abs().max().item() < ZERO_FLOOR * top}, top


def _relative_errors(grads, ref, zero=None):
    """max |grad - ref| / max |ref| per tensor, the trap (a) tensors (`zero`,
    default: found in `ref`) left out."""
    if zero is None:
        zero, _ = _zero_in_exact_arithmetic(ref)
    return {n: ((grads[n] - ref[n]).abs().max() / ref[n].abs().max()).item()
            for n in ref if n not in zero}


def test_every_parameter_gradient_with_fed_masks_matches_jax_grad(f32_step):
    grads, ref = f32_step["grads"], f32_step["jgrads"]
    assert set(grads) == set(ref)
    zero, top = _zero_in_exact_arithmetic(ref)
    assert zero == {f"backbone.0.projector.stages_sampling.0.{i}.0.bias"
                    for i in range(len(CFG.out_feature_indexes))}
    for name in zero:
        assert grads[name].abs().max().item() < ZERO_FLOOR * top, name
    errs = _relative_errors(grads, ref)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    print("largest relative gradient errors:", worst)
    assert worst[0][1] <= GRAD_RTOL, worst


def test_remat_gives_the_gradients_without_remat(bridged, f32_step):
    """Each block recomputed in the backward applies the masks it drew before."""
    params, stats, batch = bridged
    _, grads, *_ = _port_grads(params, stats, batch, f32_step["masks"], remat=True)
    for name, g in f32_step["grads"].items():
        torch.testing.assert_close(grads[name], g, rtol=1e-6, atol=1e-9, msg=name)


def test_drop_path_ramp_and_per_step_rates_are_the_jax_packages():
    for depth in (2, 3, 6, 10, 12):
        for rate in (0.0, 0.1, 0.25):
            np.testing.assert_array_equal(
                optim.drop_path_rates_for(rate, depth),
                np.asarray(joptim.drop_path_rates_for(jnp.float32(rate), depth)))
    dp = optim.drop_scheduler(0.1, 3, 4, cutoff_epoch=1, mode="early", schedule="linear")
    do = optim.drop_scheduler(0.1, 2, 4, cutoff_epoch=1, mode="late")
    seen, jseen = [], []

    def step(batch, dp_rate, do_rate):
        seen.append((dp_rate, do_rate))
        return {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)}

    def jstep(state, batch, rng, dp_rate, do_rate):
        jseen.append((float(dp_rate), float(do_rate)))
        return state, {"loss": jnp.float32(1.0), "grad_norm": jnp.float32(1.0)}

    for epoch in (0, 2):  # the second runs past the end of the dropout schedule
        engine.train_one_epoch(step, None, range(4), epoch, 4, logger=lambda s: None,
                               drop_path_sched=dp, dropout_sched=do)
        jengine.train_one_epoch(jstep, None, range(4), epoch, jax.random.PRNGKey(0), dp, do, 4,
                                logger=lambda s: None)
    assert seen == jseen and len(seen) == 8
    assert len({r for r, _ in seen}) > 2 and {r for _, r in seen} == {0.0, np.float32(0.1)}


class Refuse:
    def __call__(self, keep, shape, like):
        raise AssertionError(f"a mask of {tuple(shape)} was drawn")


def test_a_zero_schedule_draws_no_mask(bridged):
    params, stats, batch = bridged
    tcfg = dataclasses.replace(TCFG, use_ema=False)
    state = engine.create_train_state(CFG, tcfg, niter_per_ep=10, device="cpu",
                                      state_dict=state_dict_from_jax(params, stats, CFG))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    step = engine.build_train_step(state, SetCriterion(CFG, tcfg), tcfg,
                                   static_zero_drop_path=True, static_zero_dropout=True)
    # static zeros draw nothing whatever rate arrives, as the JAX flags
    assert torch.isfinite(step(tb, 0.1, 0.1, mask_source=Refuse())["loss"])
    step = engine.build_train_step(state, SetCriterion(CFG, tcfg), tcfg)
    assert torch.isfinite(step(tb, 0.0, 0.0, mask_source=Refuse())["loss"])
    # a rate above 0 draws from a generator seeded by (seed, step): the same
    # step count gives the same masks
    drawn = []
    real = drop.Bernoulli.__call__

    def spy(self, keep, shape, like):
        m = real(self, keep, shape, like)
        drawn.append(m.clone())
        return m

    with mock.patch.object(drop.Bernoulli, "__call__", spy):
        state.step = 7
        step(tb, 0.1, 0.0)
        first = list(drawn)
        drawn.clear()
        state.step = 7
        step(tb, 0.1, 0.0)
    assert len(first) == 2 * (CFG.vit_encoder_num_layers - 1)
    assert all(torch.equal(a, b) for a, b in zip(first, drawn))


# bf16: the port's bf16 train-step gradients against the JAX package's bf16
# gradients on the same fed masks, matching and proposal picks (the port's:
# bf16 scores tie often, and a swapped pick reseeds whole queries, trap (d)),
# per tensor as above, the trap (a) tensors of the f32 step left out (in bf16
# their noise is as large as their values on both sides). The ceiling is the
# drift of the JAX package's own bf16 gradients from its f32 gradients on the
# same masks, matching and picks: the port may sit no farther from JAX's bf16
# than that, in the median tensor and in the worst. Measured: port 0.13 /
# 0.61, JAX's drift 0.18 / 0.79 (median / worst).
def test_bf16_train_step_gradients_match_jax_bf16_within_its_drift(bridged, f32_step):
    params, stats, batch = bridged
    masks = f32_step["masks"]
    out, grads, matched, _, picks = _port_grads(params, stats, batch, masks, dtype=torch.bfloat16)
    assert out["pred_logits"].dtype == torch.bfloat16
    _, jgrads16 = _jax_grads(params, stats, batch, masks, matched, jnp.bfloat16, picks)
    _, jgrads32 = _jax_grads(params, stats, batch, masks, matched, jnp.float32, picks)
    zero, _ = _zero_in_exact_arithmetic(f32_step["jgrads"])
    drift = _relative_errors(jgrads32, jgrads16, zero)  # JAX f32 against JAX bf16
    port = _relative_errors(grads, jgrads16, zero)
    med_drift, max_drift = np.median(list(drift.values())), max(drift.values())
    med_port, max_port = np.median(list(port.values())), max(port.values())
    print(f"median / max relative error: port bf16 vs JAX bf16 {med_port:.3g} / {max_port:.3g}; "
          f"JAX f32 vs JAX bf16 {med_drift:.3g} / {max_drift:.3g}")
    assert all(np.isfinite(list(port.values())))
    assert med_port <= med_drift and max_port <= max_drift
