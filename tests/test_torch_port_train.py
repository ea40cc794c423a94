"""The port's optimizer rules, EMA, schedules and whole train step against the
JAX package, on the CPU in f32 at a reduced size: the JAX model is initialized
from a PRNG key, its variables cross into the port through
`weights.state_dict_from_jax`, gradients come back through
`weights.grads_from_jax`, and the same numpy batch goes through both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.config import get_config as jax_get_config
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.criterion import Targets as JaxTargets
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.train import optim as joptim
from lwdetr_tpu_torch.config import (TRAIN_PRESETS, ModelConfig, TrainConfig, get_config,
                                     get_train_config)
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model
from lwdetr_tpu_torch.train import engine, optim
from lwdetr_tpu_torch.weights import build_mapping, grads_from_jax, state_dict_from_jax

# the widths of tests/test_train.py's reduced model: 2 ViT blocks, hidden 64,
# 3 query groups of 16, 128x128 images, batch 2
NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, use_ema=True, lr=2e-4, lr_encoder=3e-4,
                   lr_component_decay=0.7, max_gt=8)
IMG, BATCH = 128, 2


def _jax_cfgs(mcfg=NANO, tcfg=TCFG):
    return (JaxModelConfig(**dataclasses.asdict(mcfg)), JaxTrainConfig(**dataclasses.asdict(tcfg)))


def test_train_configs_match_jax():
    for name in TRAIN_PRESETS:
        assert dataclasses.asdict(get_train_config(name)) == \
            dataclasses.asdict(jax_get_config(name).train), name
    assert get_train_config("small", max_gt=50).max_gt == 50


def _param_skeleton(cfg):
    """A tree with the JAX model's parameter paths (from the checkpoint mapping)."""
    tree = {}
    for _, coll, path, _ in build_mapping(cfg):
        if coll != "params":
            continue
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = 0.0
    return tree


@pytest.mark.parametrize("preset", ["small", "xlarge"])
def test_per_parameter_lr_and_weight_decay_match_jax(preset):
    mcfg, tcfg = get_config(preset), get_train_config(preset)
    jm, jt = jax_get_config(preset).model, jax_get_config(preset).train
    lr_tree, wd_tree = joptim.lr_wd_trees(_param_skeleton(mcfg), jm, jt)
    with torch.device("meta"):
        names = [n for n, _ in LWDETR(mcfg).named_parameters()]
    mapped = {tk: path for tk, coll, path, _ in build_mapping(mcfg) if coll == "params"}
    assert set(names) == set(mapped)
    seen = set()
    for name in names:
        lr, wd = optim.param_lr_wd(name, mcfg, tcfg)
        ref_lr, ref_wd = lr_tree, wd_tree
        for k in mapped[name]:
            ref_lr, ref_wd = ref_lr[k], ref_wd[k]
        assert lr == pytest.approx(ref_lr, rel=1e-12) and wd == ref_wd, name
        seen.add((lr, wd))
    # three regions, the encoder's split by depth and by the no-decay rule
    assert len(seen) > 2 * mcfg.vit_encoder_num_layers


@pytest.fixture(scope="module")
def bridged():
    """The reduced JAX model (its parameters perturbed, so that no head or
    offset is zero), the same weights in the port in train mode, one batch."""
    jm, jt = _jax_cfgs()
    jmodel = jax_build_model(jm)
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    tmodel = build_model(NANO, device="cpu", state_dict=state_dict_from_jax(params, stats, NANO),
                         train=True)
    batch = {
        "images": rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32),
        "labels": rng.integers(0, NANO.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [5]]),
    }
    return jmodel, params, stats, tmodel, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def train_forward(bridged):
    """One train-mode forward on both sides, the port's matching, and both
    sides' losses and parameter gradients on that matching."""
    jmodel, params, stats, tmodel, batch = bridged
    jm, jt = _jax_cfgs()
    jcrit, tcrit = JaxSetCriterion(jm, jt), SetCriterion(NANO, TCFG)
    tb = _torch_batch(batch)
    targets = Targets(tb["labels"], tb["boxes"], tb["valid"])
    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))

    # the port: forward, the gaps between the ranked proposal scores, losses, gradients
    gaps = []
    select = ttr.select_proposals

    def spy(scores, k):
        ranked = scores.detach().sort(dim=1, descending=True).values[:, :k + 1]
        gaps.append((ranked[:, :-1] - ranked[:, 1:]).min().item())
        return select(scores, k)

    tmodel.zero_grad(set_to_none=True)
    stats_before = {k: v.clone() for k, v in tmodel.state_dict().items() if "running" in k}
    ttr.select_proposals = spy
    try:
        tout = tmodel(tb["images"])
    finally:
        ttr.select_proposals = select
    sets = [tout] + tout["aux_outputs"] + [tout["enc_outputs"]]
    matched = tcrit.match(torch.stack([s["pred_logits"].detach() for s in sets]),
                          torch.stack([s["pred_boxes"].detach() for s in sets]), targets,
                          NANO.group_detr)
    total, losses = tcrit(tout, targets, train=True, matched=matched)
    total.backward()
    tmodel.load_state_dict(stats_before, strict=False)  # one fixture forward leaves no trace

    # the JAX package: the same forward and the criterion's per-set losses on the
    # port's matching (its own device matcher is held against the port's in
    # tests/test_torch_port_criterion.py, and is slow to compile under grad)
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(2)})
        n_valid = jnp.sum(jtargets.valid.astype(jnp.float32))
        num_boxes = jnp.maximum(n_valid * NANO.group_detr, 1.0)
        jsets = [(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
        jsets.append((out["enc_outputs"], "_enc", False))
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(jsets):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, NANO.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        jtotal = sum(jlosses[k] * w for k, w in jcrit.weight_dict().items())
        return jtotal, (jlosses, out)

    (jtotal, (jlosses, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(tout=tout, jout=jout, total=total, losses=losses, jtotal=jtotal, jlosses=jlosses,
                jgrads=jgrads, gaps=gaps, tmodel=tmodel)


def test_no_two_stage_scores_are_near_tied(train_forward):
    # near-tied proposal scores could swap picks between the two sides and
    # reseed whole queries; this seed keeps every ranked gap above 1e-4
    assert len(train_forward["gaps"]) == NANO.group_detr
    assert min(train_forward["gaps"]) > 1e-4


@pytest.mark.parametrize("key", ["pred_logits", "pred_boxes"])
def test_train_forward_matches_jax(train_forward, key):
    tout, jout = train_forward["tout"], train_forward["jout"]
    nq = NANO.num_queries * NANO.group_detr
    assert tout[key].shape[:2] == (BATCH, nq) and tout[key].shape == jout[key].shape
    pairs = [(tout, jout)] + list(zip(tout["aux_outputs"], jout["aux_outputs"])) \
        + [(tout["enc_outputs"], jout["enc_outputs"])]
    assert len(pairs) == NANO.dec_layers + 1
    for t, j in pairs:
        np.testing.assert_allclose(t[key].detach().numpy(), np.asarray(j[key]), atol=1e-4)


def test_train_losses_match_jax(train_forward):
    losses, jlosses = train_forward["losses"], train_forward["jlosses"]
    assert set(losses) == set(jlosses) and len(losses) == 3 * (NANO.dec_layers + 1) + 2
    for k, v in jlosses.items():
        assert losses[k].item() == pytest.approx(float(v), abs=1e-4), k
    assert train_forward["total"].item() == pytest.approx(float(train_forward["jtotal"]), abs=1e-4)


def test_every_parameter_gradient_matches_jax_grad(train_forward):
    ref = grads_from_jax(jax.tree.map(np.asarray, train_forward["jgrads"]), NANO)
    named = dict(train_forward["tmodel"].named_parameters())
    assert set(ref) == set(named)
    top = max(g.abs().max().item() for g in ref.values())
    # the last block's output reaches the loss only through the projector's 1x1
    # convolution and its train-mode BatchNorm, which removes any per-channel
    # constant: the gradient of that block's output bias is zero in exact
    # arithmetic and rounding noise on both sides. It is held to an absolute
    # bound instead, 1e-6 of the largest gradient of all.
    last = f"backbone.0.encoder.blocks.{NANO.vit_encoder_num_layers - 1}.mlp.fc2.bias"
    assert ref[last].abs().max() < 1e-6 * top and named[last].grad.abs().max() < 1e-6 * top
    report = {}
    for name, p in named.items():
        assert p.grad is not None and p.grad.shape == ref[name].shape, name
        report[name] = ((p.grad - ref[name]).abs().max()
                        / ref[name].abs().max().clamp(min=1e-6 * top)).item()
    worst = sorted(report.items(), key=lambda kv: -kv[1])[:5]
    print("largest relative gradient errors:", worst)
    # max abs error relative to the tensor's largest gradient
    assert worst[0][1] <= 1e-3, worst


def test_batch_norm_running_statistics_match_jax_after_two_steps(bridged):
    """Two train-mode forwards on two batches: flax keeps the biased batch
    variance in its running variance, and so does the port."""
    jmodel, params, stats, tmodel, _ = bridged
    rng = np.random.default_rng(5)
    saved = {k: v.clone() for k, v in tmodel.state_dict().items() if ".bn." in k}
    jstats = stats
    try:
        for _ in range(2):
            images = rng.standard_normal((BATCH, IMG, IMG, 3)).astype(np.float32) * 1.5 + 0.3
            _, new = jmodel.apply({"params": params, "batch_stats": jstats}, jnp.asarray(images),
                                  train=True, mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(2)})
            jstats = new["batch_stats"]
            with torch.no_grad():
                tmodel(torch.from_numpy(images))
        ref = state_dict_from_jax(params, jax.tree.map(np.asarray, jstats), NANO)
        sd = tmodel.state_dict()
        keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(keys) == 2 * 8  # C2f: cv1, cv2 and 3 bottlenecks of 2
        for k in keys:
            assert not torch.equal(sd[k], saved[k]), k
            np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
        assert all(int(sd[k]) == int(saved[k]) + 2 for k in sd if k.endswith("num_batches_tracked"))
        # stock PyTorch would have stored the unbiased variance: measurably apart
        n = BATCH * (IMG // 16) ** 2
        k = keys[1]
        assert k.endswith("running_var")
        drift = (sd[k] - saved[k]).abs().max().item() * (n / (n - 1) - 1)
        assert drift > 1e-5
    finally:
        tmodel.load_state_dict(saved, strict=False)


def test_three_optimizer_steps_on_given_gradients_match_optax(bridged):
    """clip -> Adam -> -(s x lr) x (u + wd x p) with StepLR, on the same
    gradients (gradients, not losses: Adam's first update is ~lr x sign(g), so a
    1e-8 difference on a near-zero gradient would flip a whole lr)."""
    _, params, stats, _, _ = bridged
    jm, jt = _jax_cfgs(tcfg=dataclasses.replace(TCFG, lr_drop=2))
    tcfg = dataclasses.replace(TCFG, lr_drop=2)
    tx = joptim.build_optimizer(params, jm, jt, niter_per_ep=1)  # lr drops at the third step
    opt_state = tx.init(params)
    model = build_model(NANO, device="cpu", state_dict=state_dict_from_jax(params, stats, NANO),
                        train=True)
    optimizer, scheduler = optim.build_optimizer(model, NANO, tcfg, niter_per_ep=1)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(9)
    jparams = params
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-4, 1)
                                        ).astype(np.float32), jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in grads_from_jax(grads, NANO).items():
            named[name].grad = g
        norm = torch.nn.utils.clip_grad_norm_(list(named.values()), tcfg.clip_max_norm)
        assert norm.item() == pytest.approx(float(optax.global_norm(grads)), rel=1e-5)
        optimizer.step()
        scheduler.step()
        ref = state_dict_from_jax(jax.tree.map(np.asarray, jparams), stats, NANO)
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=1e-6,
                                       err_msg=f"step {step} {name}")
    assert scheduler.get_last_lr()[0] == pytest.approx(0.1 * optimizer.param_groups[0]["initial_lr"])


def test_step_lr_and_drop_scheduler_match_jax():
    sched = joptim.step_lr_schedule(3, 5)
    lam = optim.step_lr_lambda(3, 5)
    for step in (0, 4, 14, 15, 29, 30, 44):
        assert lam(step) == pytest.approx(float(sched(jnp.asarray(step))), rel=1e-6)
    for kw in (dict(mode="standard"), dict(mode="early", cutoff_epoch=2),
               dict(mode="early", cutoff_epoch=2, schedule="linear"),
               dict(mode="late", cutoff_epoch=1)):
        np.testing.assert_array_equal(optim.drop_scheduler(0.1, 4, 3, **kw),
                                      joptim.drop_scheduler(0.1, 4, 3, **kw))
    with pytest.raises(ValueError):
        optim.drop_scheduler(0.1, 4, 3, mode="sometimes")


def test_ema_matches_jax_and_covers_the_batch_statistics(bridged):
    _, params, stats, _, _ = bridged
    model = build_model(NANO, device="cpu", state_dict=state_dict_from_jax(params, stats, NANO),
                        train=True)
    ema = optim.ema_init(model)
    assert set(ema) == set(model.state_dict())
    rng = np.random.default_rng(13)
    bump = lambda t: jax.tree.map(  # noqa: E731
        lambda l: np.asarray(l) + rng.standard_normal(l.shape).astype(np.float32), t)
    new_params, new_stats = bump(params), bump(stats)
    model.load_state_dict(state_dict_from_jax(new_params, new_stats, NANO))
    optim.ema_update(ema, model, 0.9)
    ref = joptim.ema_update({"params": params, "batch_stats": stats},
                            {"params": new_params, "batch_stats": new_stats}, 0.9)
    ref = state_dict_from_jax(ref["params"], ref["batch_stats"], NANO)
    for k, v in ref.items():
        if v.is_floating_point():
            np.testing.assert_allclose(ema[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    assert not ema["class_embed.weight"].requires_grad


def test_thirty_steps_lower_the_loss_and_move_the_ema(bridged):
    _, params, stats, _, batch = bridged
    tcfg = dataclasses.replace(TCFG, lr=1e-3, lr_encoder=1e-3)  # 30 steps must show
    state = engine.create_train_state(NANO, tcfg, niter_per_ep=100, device="cpu",
                                      state_dict=state_dict_from_jax(params, stats, NANO))
    start = {k: v.clone() for k, v in state.ema.items()}
    step = engine.build_train_step(state, SetCriterion(NANO, tcfg), tcfg)
    losses, logged = [], []

    def counted(b, *rates):
        metrics = step(b, *rates)
        losses.append(float(metrics["loss"]))
        return metrics

    meters = engine.train_one_epoch(counted, state, [_torch_batch(batch)] * 30, epoch=0,
                                    niter_per_ep=30, log_every=10, logger=logged.append)
    assert state.step == 30 and len(logged) == 3 and len(losses) == 30
    assert {"loss", "grad_norm", "loss_ce", "loss_bbox_enc", "class_error", "epoch_time"} <= set(meters)
    assert meters["loss"] == pytest.approx(np.mean(losses), rel=1e-6)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.9 * np.mean(losses[:5]), losses
    moved = max((state.ema[k] - start[k]).abs().max().item() for k in start
                if start[k].is_floating_point())
    lag = (state.ema["class_embed.bias"] - state.model.class_embed.bias).abs().max().item()
    assert moved > 0 and lag > 0  # the EMA follows the parameters and lags behind them


def test_train_one_epoch_aborts_on_a_non_finite_loss_and_honours_should_stop():
    calls = []

    def fake_step(batch, *rates):
        calls.append(batch)
        return {"loss": torch.tensor(float("nan") if batch == 2 else 1.0),
                "grad_norm": torch.tensor(1.0)}

    state = engine.TrainState(None, None, None, None)
    with pytest.raises(FloatingPointError, match="epoch 4 it 2"):
        engine.train_one_epoch(fake_step, state, [0, 1, 2, 3, 4], 4, 5, logger=lambda s: None)
    assert calls == [0, 1, 2, 3]  # metrics are read one step late
    calls.clear()
    meters = engine.train_one_epoch(fake_step, state, [0, 1, 5, 6], 0, 4, logger=lambda s: None,
                                    should_stop=lambda: len(calls) == 2)
    assert calls == [0, 1] and meters["loss"] == 1.0


def test_train_mode_refuses_what_is_not_ported():
    # stochastic depth, dropout and bf16 training are ported (test_torch_port_drop.py);
    # what stays refused: the encoders and decoder variants no release preset uses,
    # and compute dtypes other than float32 / bfloat16
    with pytest.raises(NotImplementedError, match="ViT"):
        LWDETR(dataclasses.replace(NANO, encoder="resnet18"))
    with pytest.raises(NotImplementedError, match="learned"):
        LWDETR(dataclasses.replace(NANO, position_embedding="learned"))
    with pytest.raises(ValueError, match="bfloat16"):
        build_model(NANO, device="cpu", dtype=torch.float16, train=True)
    bf16 = build_model(dataclasses.replace(NANO, drop_path=0.1, dropout=0.1), device="cpu",
                       dtype=torch.bfloat16, train=True)
    assert bf16.training and bf16.compute_dtype == torch.bfloat16
    eval_model = build_model(NANO, device="cpu")
    assert not eval_model.training and not any(p.requires_grad for p in eval_model.parameters())
    train_model = build_model(NANO, device="cpu", train=True)
    assert train_model.training and all(p.requires_grad for p in train_model.parameters())


def test_eval_step_gives_detections_and_losses(bridged):
    _, params, stats, _, batch = bridged
    model = build_model(NANO, device="cpu", state_dict=state_dict_from_jax(params, stats, NANO))
    tb = dict(_torch_batch(batch), orig_size=torch.tensor([[480.0, 640.0]] * BATCH))
    eval_cfg = dataclasses.replace(NANO, num_select=10)
    (scores, labels, boxes), losses = engine.build_eval_step(
        model, eval_cfg.num_select, SetCriterion(NANO, TCFG))(tb)
    assert scores.shape == (BATCH, 10) and boxes.shape == (BATCH, 10, 4)
    assert torch.isfinite(losses["loss"]) and "loss_giou_enc" in losses
    _, none = engine.build_eval_step(model, 10)(tb)
    assert none == {}
