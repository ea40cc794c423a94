"""Padded batches through the port against the JAX package, on the CPU in f32.

Two images of 128x192 and 192x128 padded to 192x192 (the legacy recipe's and
`--per_image_scales`' `pad_mask`, True on padding) go through a reduced model
of the micro fixture's shape: the resized masks, the valid ratios and the
masked proposals, the eval and train-mode forwards in each cross-attention
branch (the port's `set_force_branch`; the JAX model samples through its
gather formulation on the CPU, as `tests/test_model.py::test_masked_forward`
runs it) and the train step's gradients against `jax.grad`. A mask that is
all False gives what no mask gives, bit for bit. The eval CLI on the legacy
recipe (`--square_resize_div_64` not given) gives the JAX package's stats on
`tests/fixtures/micro_map_padded/` (six of the fixture's images, batch 2, one
batch a landscape and a portrait), `golden_stats_padded.json`.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.criterion import Targets as JaxTargets
from lwdetr_tpu.models.lwdetr import _interpolate_mask as jax_interpolate_mask
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.models.transformer import Transformer as JaxTransformer
from lwdetr_tpu.models.transformer import gen_encoder_output_proposals as jax_gen_proposals
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import build_model, interpolate_mask
from lwdetr_tpu_torch.train import engine
from lwdetr_tpu_torch.weights import grads_from_jax, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PADDED_FIXDIR = os.path.join(ROOT, "tests", "fixtures", "micro_map_padded")
GOLDEN_PATH = os.path.join(ROOT, "tests", "fixtures", "micro_map", "golden_stats_padded.json")
GOLDEN_ATOL = 1e-7  # the JAX package's bound on its goldens

NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=2, num_queries=12,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, max_gt=6)
SIDE, BATCH = 192, 2
VALID_HW = ((128, 192), (192, 128))  # each image's unpadded (h, w)
BRANCHES = [None, "cm", "sep", "gather"]


def _pad_mask():
    mask = np.ones((BATCH, SIDE, SIDE), bool)
    for i, (h, w) in enumerate(VALID_HW):
        mask[i, :h, :w] = False
    return mask


@pytest.fixture(scope="module")
def bridged():
    jm = JaxModelConfig(**dataclasses.asdict(NANO))
    jmodel = jax_build_model(jm)
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, SIDE, SIDE, 3), jnp.float32))
    rng = np.random.default_rng(11)
    # no head or offset projection stays zero
    params = jax.tree.map(
        lambda l: np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32),
        variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    mask = _pad_mask()
    # the loader's padding: zeros where the mask is True
    images = rng.standard_normal((BATCH, SIDE, SIDE, 3)).astype(np.float32) * ~mask[..., None]
    batch = {
        "images": images.astype(np.float32),
        "pad_mask": mask,
        "labels": rng.integers(0, NANO.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.6, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.3, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [5]]),
    }
    return jm, jmodel, params, stats, state_dict_from_jax(params, stats, NANO), batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("hw", [(12, 12), (6, 6), (24, 24), (7, 5)])
def test_masks_resize_to_each_level_as_jax(hw):
    mask = _pad_mask()
    ref = jax_interpolate_mask(jnp.asarray(mask), hw)
    out = interpolate_mask(torch.from_numpy(mask), hw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_proposals_and_valid_ratios_match_jax():
    shapes = ((12, 12), (6, 6))
    rng = np.random.default_rng(4)
    masks = [np.asarray(jax_interpolate_mask(jnp.asarray(_pad_mask()), hw)) for hw in shapes]
    flat = np.concatenate([m.reshape(BATCH, -1) for m in masks], axis=1)
    memory = rng.standard_normal((BATCH, flat.shape[1], 16)).astype(np.float32)
    jmem, jprop = jax_gen_proposals(jnp.asarray(memory), jnp.asarray(flat), shapes,
                                    unsigmoid=False)
    tmem, tprop = ttr.gen_encoder_output_proposals(torch.from_numpy(memory), shapes,
                                                   torch.from_numpy(flat))
    np.testing.assert_array_equal(tprop.numpy(), np.asarray(jprop))
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    # image 0 keeps 8 of 12 rows at level 0: its anchors spread over them
    assert tprop[0, 7 * 12, 1].item() == pytest.approx(7.5 / 8)
    for m in masks:
        np.testing.assert_array_equal(ttr.valid_ratio(torch.from_numpy(m.copy())).numpy(),
                                      np.asarray(JaxTransformer._valid_ratio(jnp.asarray(m))))
    assert ttr.valid_ratio(torch.zeros(2, 5, 7, dtype=torch.bool)).eq(1.0).all()


def _jax_forward(jmodel, params, stats, batch, train):
    fn = jax.jit(lambda v, x, m: jmodel.apply(v, x, masks=m, train=train,
                                               rngs={"dropout": jax.random.PRNGKey(2)}
                                               if train else None,
                                               mutable=["batch_stats"] if train else False))
    out = fn({"params": params, "batch_stats": stats}, jnp.asarray(batch["images"]),
             jnp.asarray(batch["pad_mask"]))
    return out[0] if train else out


@pytest.fixture(scope="module")
def jax_outputs(bridged):
    _, jmodel, params, stats, _, batch = bridged
    return {train: _jax_forward(jmodel, params, stats, batch, train) for train in (False, True)}


def _assert_outputs_close(tout, jout):
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(tout[key].detach().numpy(), np.asarray(jout[key]), atol=1e-4)
        np.testing.assert_allclose(tout["enc_outputs"][key].detach().numpy(),
                                   np.asarray(jout["enc_outputs"][key]), atol=1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_padded_forward_matches_jax_in_each_branch(bridged, jax_outputs, branch, train):
    sd, batch = bridged[4], bridged[5]
    tb = _torch_batch(batch)
    model = ttr.set_force_branch(build_model(NANO, device="cpu", state_dict=sd, train=train),
                                 branch)
    with torch.no_grad():
        tout = model(tb["images"], tb["pad_mask"])
        unmasked = model(tb["images"])
    _assert_outputs_close(tout, jax_outputs[train])
    # the mask is read: the padded zeros taken as image give other outputs
    assert (tout["pred_logits"] - unmasked["pred_logits"]).abs().max().item() > 1e-3


@pytest.mark.parametrize("branch", BRANCHES)
def test_an_all_false_mask_is_bit_equal_to_no_mask(bridged, branch):
    sd, batch = bridged[4], bridged[5]
    images = torch.from_numpy(batch["images"])
    none = torch.zeros((BATCH, SIDE, SIDE), dtype=torch.bool)
    for train in (False, True):
        model = ttr.set_force_branch(build_model(NANO, device="cpu", state_dict=sd, train=train),
                                     branch)
        with torch.no_grad():
            a, b = model(images), model(images, none)
        for key in ("pred_logits", "pred_boxes"):
            assert torch.equal(a[key], b[key]), (train, key)
            assert torch.equal(a["enc_outputs"][key], b["enc_outputs"][key]), (train, key)


def _rel_errors(named_grads, ref):
    """Per tensor: max |difference| over the tensor's largest reference
    gradient, floored at 1e-6 of the largest gradient of all (trap (a): a
    gradient that is zero in exact arithmetic is rounding noise on both sides)."""
    assert set(named_grads) == set(ref)
    top = max(g.abs().max().item() for g in ref.values())
    return {n: ((named_grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-6 * top)).item()
            for n, g in ref.items()}


@pytest.fixture(scope="module")
def train_reference(bridged):
    """The port's padded train-mode forward in its default branch, its
    matching, and the JAX package's loss and gradients on that matching."""
    jm, jmodel, params, stats, sd, batch = bridged
    jcrit = JaxSetCriterion(jm, JaxTrainConfig(**dataclasses.asdict(TCFG)))
    tcrit = SetCriterion(NANO, TCFG)
    tb = _torch_batch(batch)
    targets = Targets(tb["labels"], tb["boxes"], tb["valid"])
    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))
    tmodel = build_model(NANO, device="cpu", state_dict=sd, train=True)
    with torch.no_grad():
        tout = tmodel(tb["images"], tb["pad_mask"])
    sets = [tout] + tout["aux_outputs"] + [tout["enc_outputs"]]
    matched = tcrit.match(torch.stack([s["pred_logits"] for s in sets]),
                          torch.stack([s["pred_boxes"] for s in sets]), targets, NANO.group_detr)
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, jnp.asarray(batch["images"]),
                              masks=jnp.asarray(batch["pad_mask"]), train=True,
                              mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
        num_boxes = jnp.maximum(jnp.sum(jtargets.valid.astype(jnp.float32)) * NANO.group_detr,
                                1.0)
        jsets = [(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
        jsets.append((out["enc_outputs"], "_enc", False))
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(jsets):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, NANO.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        return sum(jlosses[k] * w for k, w in jcrit.weight_dict().items())

    jtotal, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref = grads_from_jax(jax.tree.map(np.asarray, jgrads), NANO)
    return tcrit, tb, targets, matched, float(jtotal), ref


@pytest.mark.parametrize("branch", [None, "cm", "gather"])
def test_padded_gradients_match_jax_grad_in_each_branch(bridged, train_reference, branch):
    sd = bridged[4]
    tcrit, tb, targets, matched, jtotal, ref = train_reference
    model = ttr.set_force_branch(build_model(NANO, device="cpu", state_dict=sd, train=True),
                                 branch)
    total, _ = tcrit(model(tb["images"], tb["pad_mask"]), targets, train=True, matched=matched)
    total.backward()
    assert total.item() == pytest.approx(jtotal, abs=1e-4)
    rel = _rel_errors({n: p.grad for n, p in model.named_parameters()}, ref)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    assert worst[0][1] <= 1e-3, worst


def test_both_engine_steps_pass_the_pad_mask(bridged):
    sd, batch = bridged[4], bridged[5]
    tb = _torch_batch(batch)
    tb["orig_size"] = torch.tensor([list(hw) for hw in VALID_HW], dtype=torch.float32)
    model = build_model(NANO, device="cpu", state_dict=sd)
    (scores, _, _), _ = engine.build_eval_step(model, 10)(tb)
    with torch.no_grad():
        out = model(tb["images"], tb["pad_mask"])
    np.testing.assert_array_equal(
        scores.numpy(), torch.topk(out["pred_logits"].reshape(BATCH, -1), 10).values.sigmoid())
    state = engine.create_train_state(NANO, TCFG, niter_per_ep=10, device="cpu", state_dict=sd)
    seen = []
    forward = state.model.forward

    def spy(images, masks=None, *rest):
        seen.append(masks)
        return forward(images, masks, *rest)

    state.model.forward = spy
    metrics = engine.build_train_step(state, SetCriterion(NANO, TCFG), TCFG)(tb)
    assert seen and seen[0] is tb["pad_mask"] and torch.isfinite(metrics["loss"])


def test_the_legacy_recipe_eval_cli_gives_the_jax_stats(tmp_path):
    """`python -m lwdetr_tpu_torch.main --eval` without `--square_resize_div_64`
    (shortest side 800, longest at most 1333, batches padded to a common
    multiple of 64 with their `pad_mask`) on the padded fixture gives the 12
    stats the JAX package's `evaluate` gives on the same images (generated by
    `tests/gen_micro_map_padded_golden.py`) within 1e-7, in f32."""
    from lwdetr_tpu_torch.weights import read_jax_npz

    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    fixdir = os.path.join(ROOT, "tests", "fixtures", "micro_map")
    cfg = _micro_cfg()
    tree = read_jax_npz(os.path.join(fixdir, "weights.npz"))
    sd = state_dict_from_jax(tree["params"], tree.get("batch_stats"), cfg)
    pth = tmp_path / "micro.pth"
    torch.save({"model": sd}, pth)
    cmd = [sys.executable, "-m", "lwdetr_tpu_torch.main", "--eval", "--device", "cpu",
           "--coco_path", PADDED_FIXDIR, *golden["flags"], "--resume", str(pth),
           "--output_dir", str(tmp_path), "--num_workers", "2", "--dont_bench"]
    assert "--square_resize_div_64" not in cmd
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    for k in sorted(golden["stats"]):
        np.testing.assert_allclose(stats[k], golden["stats"][k], atol=GOLDEN_ATOL, rtol=0,
                                   err_msg=f"stat {k}")


def _micro_cfg():
    from lwdetr_tpu_torch import main as cli

    with open(GOLDEN_PATH) as f:
        flags = json.load(f)["flags"]
    return cli.config_from_args(cli.parser().parse_args(
        ["--eval", "--coco_path", PADDED_FIXDIR, *flags])).model
