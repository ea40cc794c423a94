"""The port's encoder and decoder variants against the JAX package, on the CPU.

Every combination of (two_stage, bbox_reparam, lite_refpoint_refine) that the
JAX package builds, with the learned or the sine position embedding and the
final decoder norm or none, at the reduced size of the port's train tests
(ViT-tiny of 2 blocks, hidden 64, 3 groups of 16 queries, 128 x 128): eval
outputs in f32, and train-mode gradients against `jax.grad` on two of the
variants that change the backward (the iterative refinement, boxes as
logits; the other three are in test_torch_port_variant_grads.py). Their
JAX variables are drawn with numpy at the shapes of the JAX init
(`draw_variables`) and cross into the port through `state_dict_from_jax`.
Also: the learned embedding's parameters and its decay after two steps
against optax, the lr / weight-decay groups against `lr_wd_trees`, the JAX
initialisation of the new parameters, a reference checkpoint that holds the
shared box head twice, and the variant eval CLI against its golden. F7's CPU
tests (attention above 256 channels a head) are in test_torch_port_ops.py.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import TrainConfig as JaxTrainConfig
from lwdetr_tpu.models.criterion import SetCriterion as JaxSetCriterion
from lwdetr_tpu.models.criterion import Targets as JaxTargets
from lwdetr_tpu.models.lwdetr import LearnedPositionEncoding as JaxLearnedPositionEncoding
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.models.presnet import ConvNorm as JaxConvNorm
from lwdetr_tpu.train import optim as joptim
from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model
from lwdetr_tpu_torch.train import checkpoint as ckpt
from lwdetr_tpu_torch.train import engine, optim
from lwdetr_tpu_torch.weights import (build_mapping, grads_from_jax, jax_init_state_dict,
                                      jax_initializer, state_dict_from_jax, tensors_from_jax)

NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=64, dim_feedforward=128,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=7, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
TCFG = TrainConfig(ia_bce_loss=True, cls_loss_coef=1.0, use_ema=False, lr=2e-4, lr_encoder=3e-4,
                   lr_component_decay=0.7, weight_decay=1e-2, max_gt=8)
IMG, BATCH = 128, 2
ATOL = 1e-4  # f32 through ~20 layers on both sides, sums in another order
GRAD_RTOL = 1e-3  # per tensor, of its largest gradient (the port's train tests' bound)

# (two_stage, bbox_reparam, lite_refpoint_refine) x the embedding and the final norm:
# every combination once, each embedding and each norm in four of them
VARIANTS = [
    (True, True, True, "learned", "Identity"),
    (True, True, False, "sine", "LN"),
    (True, False, True, "sine", "Identity"),
    (True, False, False, "learned", "LN"),
    (False, True, True, "sine", "LN"),
    (False, True, False, "learned", "Identity"),
    (False, False, True, "learned", "LN"),
    (False, False, False, "sine", "Identity"),
]


def variant(two_stage, bbox_reparam, lite, embedding="sine", norm="LN", base=NANO) -> ModelConfig:
    return dataclasses.replace(base, two_stage=two_stage, bbox_reparam=bbox_reparam,
                               lite_refpoint_refine=lite, position_embedding=embedding,
                               decoder_norm=norm)


def _jax_cfgs(mcfg, tcfg=TCFG):
    return (JaxModelConfig(**dataclasses.asdict(mcfg)), JaxTrainConfig(**dataclasses.asdict(tcfg)))


def draw_variables(jmodel, img: int, seed: int = 0):
    """Random JAX variables at the shapes of `jmodel`'s init (`jax.eval_shape`:
    no initializer runs), drawn with numpy so that every path of the forward
    depends on its inputs: kernels scaled by their fan-in, scales near 1,
    BatchNorm statistics that make no norm an identity, the learned
    embedding in U[0, 1), small reference-box embeddings (boxes near the
    image centre when they are logits)."""
    shapes = jax.eval_shape(lambda r, x: jmodel.init(r, x, train=True),
                            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, img, img, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("kernel", "in_proj_kernel", "qkv_kernel"):
            x = rng.standard_normal(shape) / math.sqrt(math.prod(shape[:-1]))
        elif name in ("scale", "weight"):
            x = rng.uniform(0.8, 1.2, shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, shape)
        elif name in ("gamma_1", "gamma_2"):
            x = rng.uniform(0.05, 0.15, shape)
        elif name in ("row_embed", "col_embed"):
            x = rng.uniform(0.0, 1.0, shape)
        elif name == "query_feat":
            x = rng.standard_normal(shape)
        elif name == "refpoint_embed":
            x = 0.1 * rng.standard_normal(shape)
        elif path[-2].key == "sampling_offsets":
            x = rng.standard_normal(shape) * (1.0 if name == "bias" else 0.1)
        else:  # biases, BatchNorm means, pos_embed
            x = 0.05 * rng.standard_normal(shape)
        return x.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return variables["params"], variables.get("batch_stats", {})


def _images(img=IMG, batch=BATCH, seed=7):
    return np.random.default_rng(seed).standard_normal((batch, img, img, 3)).astype(np.float32)


def bridge(cfg: ModelConfig, img: int = IMG, seed: int = 0):
    """(JAX model, params, stats, the port's eval model on the same weights)."""
    jmodel = jax_build_model(_jax_cfgs(cfg)[0])
    params, bstats = draw_variables(jmodel, img, seed)
    tmodel = build_model(cfg, device="cpu", state_dict=state_dict_from_jax(params, bstats, cfg))
    return jmodel, params, bstats, tmodel


def eval_outputs(cfg: ModelConfig, img: int = IMG):
    """Both sides' eval outputs on the same images."""
    jmodel, params, bstats, tmodel = bridge(cfg, img)
    images = _images(img)
    jout = jax.jit(lambda p, s, x: jmodel.apply({"params": p, "batch_stats": s}, x, train=False))(
        params, bstats, jnp.asarray(images))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    return jout, tout


def _sets(out, two_stage):
    return ([(out, "", True)] + [(a, f"_{i}", False) for i, a in enumerate(out["aux_outputs"])]
            + ([(out["enc_outputs"], "_enc", False)] if two_stage else []))


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {
        "images": _images(seed=seed),
        "labels": rng.integers(0, cfg.num_classes, (BATCH, TCFG.max_gt)).astype(np.int32),
        "boxes": np.concatenate([rng.uniform(0.3, 0.7, (BATCH, TCFG.max_gt, 2)),
                                 rng.uniform(0.1, 0.4, (BATCH, TCFG.max_gt, 2))],
                                -1).astype(np.float32),
        "valid": np.arange(TCFG.max_gt)[None] < np.array([[3], [5]]),
    }


def train_gradients(cfg: ModelConfig, img: int = IMG):
    """One train-mode forward on both sides on the same batch, the port's
    matching of every output set, and both sides' losses and parameter
    gradients on that matching (as `test_torch_port_train.py`'s
    `train_forward`, for any variant): dict of the port's and JAX's outputs,
    total losses, gradients keyed by the port's names, and the port's model."""
    jm, jt = _jax_cfgs(cfg)
    jmodel, params, bstats, _ = bridge(cfg, img)
    tmodel = build_model(cfg, device="cpu", train=True,
                         state_dict=state_dict_from_jax(params, bstats, cfg))
    batch = _batch(cfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    targets = Targets(tb["labels"], tb["boxes"], tb["valid"])
    tcrit, jcrit = SetCriterion(cfg, TCFG), JaxSetCriterion(jm, jt)
    tout = tmodel(tb["images"])
    sets = [s for s, _, _ in _sets(tout, cfg.two_stage)]
    matched = tcrit.match(torch.stack([s["pred_logits"].detach() for s in sets]),
                          torch.stack([s["pred_boxes"].detach() for s in sets]), targets,
                          cfg.group_detr)
    total, _ = tcrit(tout, targets, train=True, matched=matched)
    total.backward()
    optim.zero_missing_grads(tmodel.parameters())

    jtargets = JaxTargets(jnp.asarray(batch["labels"]), jnp.asarray(batch["boxes"]),
                          jnp.asarray(batch["valid"]))
    jmatched = jnp.asarray(matched.numpy().astype(np.int32))

    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": bstats}, jnp.asarray(batch["images"]),
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(2)})
        num_boxes = jnp.maximum(jnp.sum(jtargets.valid.astype(jnp.float32)) * cfg.group_detr, 1.0)
        jlosses = {}
        for i, (o, suffix, diag) in enumerate(_sets(out, cfg.two_stage)):
            jlosses.update(jcrit._loss_set(o, jtargets, num_boxes, cfg.group_detr, suffix=suffix,
                                           with_diag=diag, matched=jmatched[i]))
        return sum(jlosses[k] * w for k, w in jcrit.weight_dict().items()), out

    (jtotal, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return dict(tout=tout, jout=jout, total=total.item(), jtotal=float(jtotal), tmodel=tmodel,
                ref=grads_from_jax(jax.tree.map(np.asarray, jgrads), cfg))


def assert_gradients_match(run, cfg, rtol=GRAD_RTOL):
    """Every parameter's gradient within `rtol` of its tensor's largest, with
    trap (a)'s floor: a gradient zero in exact arithmetic (below 1e-6 of the
    largest gradient of all on JAX's side) is held to that absolute bound."""
    ref, named = run["ref"], dict(run["tmodel"].named_parameters())
    assert set(ref) == set(named)
    top = max(g.abs().max().item() for g in ref.values())
    report = {}
    for name, p in named.items():
        if ref[name].abs().max() < 1e-6 * top:  # e.g. the last ViT block's mlp.fc2.bias
            assert p.grad.abs().max() < 1e-6 * top, name
            continue
        report[name] = ((p.grad - ref[name]).abs().max() / ref[name].abs().max()).item()
    worst = max(report.items(), key=lambda kv: kv[1])
    assert worst[1] <= rtol, worst
    return report


@pytest.mark.parametrize("two_stage,bbox_reparam,lite,embedding,norm", VARIANTS)
def test_every_decoder_variant_matches_jax_in_eval(two_stage, bbox_reparam, lite, embedding,
                                                   norm):
    cfg = variant(two_stage, bbox_reparam, lite, embedding, norm)
    jout, tout = eval_outputs(cfg)
    assert ("enc_outputs" in tout) == ("enc_outputs" in jout) == two_stage
    pairs = [(tout, jout)] + list(zip(tout["aux_outputs"], jout["aux_outputs"]))
    if two_stage:
        pairs.append((tout["enc_outputs"], jout["enc_outputs"]))
    for t, j in pairs:
        for key in ("pred_logits", "pred_boxes"):
            assert t[key].shape == j[key].shape
            np.testing.assert_allclose(t[key].numpy(), np.asarray(j[key]), atol=ATOL, err_msg=key)
    assert np.isfinite(tout["pred_boxes"].numpy()).all()


@pytest.fixture(scope="module", params=[(False, False, False), (True, False, False)],
                ids=["deformable", "two_stage_logits"])
def variant_gradients(request):
    two_stage, reparam, lite = request.param
    cfg = variant(two_stage, reparam, lite, "learned" if not two_stage else "sine")
    return cfg, train_gradients(cfg)


def assert_train_forward_matches(cfg, run):
    """The train-mode outputs of every query group and the total loss."""
    nq = cfg.num_queries * cfg.group_detr
    for key in ("pred_logits", "pred_boxes"):
        t, j = run["tout"][key].detach().numpy(), np.asarray(run["jout"][key])
        assert t.shape[:2] == (BATCH, nq)
        np.testing.assert_allclose(t, j, atol=ATOL)
    assert run["total"] == pytest.approx(run["jtotal"], abs=1e-4)


def assert_train_gradients_match(cfg, run):
    """`assert_gradients_match`, and the box head and the learned embedding
    reached as the variant reaches them."""
    report = assert_gradients_match(run, cfg)
    named = dict(run["tmodel"].named_parameters())
    # the box head decodes every layer's boxes (and, in the iterative
    # refinement, refines them); the learned embedding reaches nothing (a zero
    # gradient)
    assert named["bbox_embed.layers.2.weight"].grad.abs().max() > 0
    if cfg.position_embedding == "learned":
        assert named["backbone.1.row_embed.weight"].grad.abs().max() == 0
    assert len(report) > len(named) - 4


def test_train_forward_and_loss_match_jax(variant_gradients):
    assert_train_forward_matches(*variant_gradients)


def test_train_gradients_match_jax_grad(variant_gradients):
    assert_train_gradients_match(*variant_gradients)


def test_learned_embedding_parameters_and_their_decay_match_optax():
    """The learned embedding is two 50 x hidden / 2 tables under `backbone.1`
    that no forward reads: each train step gives them zero gradients, so AdamW
    decays them by (1 - s lr wd) a step, as the JAX optimizer decays every
    leaf (`scale_by_param_lr_wd`). Two port steps against two optax updates of
    the same leaves with zero gradients."""
    cfg = variant(False, False, False, "learned")
    _, params, bstats, _ = bridge(cfg)
    sd = state_dict_from_jax(params, bstats, cfg)
    model_shape = LWDETR(cfg).backbone[1]
    assert model_shape.row_embed.weight.shape == model_shape.col_embed.weight.shape == (50, 32)
    state = engine.create_train_state(cfg, TCFG, niter_per_ep=10, device="cpu", state_dict=sd)
    step = engine.build_train_step(state, SetCriterion(cfg, TCFG), TCFG, static_zero_drop_path=True,
                                   static_zero_dropout=True)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(cfg).items()}
    for _ in range(2):
        metrics = step(batch)
        assert math.isfinite(float(metrics["loss"]))
    jm, jt = _jax_cfgs(cfg)
    leaves = {"pos_embedding": params["pos_embedding"]}
    tx = joptim.build_optimizer(leaves, jm, jt, niter_per_ep=10)
    opt_state = tx.init(leaves)
    for _ in range(2):
        updates, opt_state = tx.update(jax.tree.map(jnp.zeros_like, leaves), opt_state, leaves)
        leaves = optax.apply_updates(leaves, updates)
    got = dict(state.model.named_parameters())
    for name in ("row_embed", "col_embed"):
        ref = np.asarray(leaves["pos_embedding"][name])
        start = params["pos_embedding"][name]
        assert not np.array_equal(ref, start)
        np.testing.assert_allclose(got[f"backbone.1.{name}.weight"].detach().numpy(), ref,
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("encoder,embedding", [("res18vd", "sine"), ("vit_tiny", "learned")])
def test_lr_and_weight_decay_groups_match_lr_wd_trees(encoder, embedding):
    """PResNet's rule (0.1 x lr, the ViT's no-decay rule on norms and biases)
    and the learned embedding's (base lr and decay) against `lr_wd_trees`."""
    cfg = dataclasses.replace(NANO, encoder=encoder, position_embedding=embedding,
                              lite_refpoint_refine=False)
    tree = {}
    for _, coll, path, _ in build_mapping(cfg):
        if coll == "params":
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = 0.0
    jm, jt = _jax_cfgs(cfg)
    lr_tree, wd_tree = joptim.lr_wd_trees(tree, jm, jt)
    with torch.device("meta"):
        names = [n for n, _ in LWDETR(cfg).named_parameters()]
    mapped = {tk: path for tk, coll, path, _ in build_mapping(cfg) if coll == "params"}
    assert set(names) == set(mapped)
    seen = set()
    for name in names:
        lr, wd = optim.param_lr_wd(name, cfg, TCFG)
        ref_lr, ref_wd = lr_tree, wd_tree
        for k in mapped[name]:
            ref_lr, ref_wd = ref_lr[k], ref_wd[k]
        assert lr == pytest.approx(ref_lr, rel=1e-12) and wd == ref_wd, name
        seen.add((name.split(".")[0], lr, wd))
    if encoder.startswith("res"):
        assert ("backbone", 0.1 * TCFG.lr, 0.0) in seen
        assert ("backbone", 0.1 * TCFG.lr, TCFG.weight_decay) in seen


@functools.lru_cache(maxsize=1)
def _fresh_res18():
    cfg = dataclasses.replace(NANO, encoder="res18vd", position_embedding="learned",
                              two_stage=False, bbox_reparam=False, lite_refpoint_refine=False)
    return cfg, jax_init_state_dict(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("key,cin,cout,k", [("conv1_2", 32, 32, 3), ("res1_0.branch2a", 64, 128, 3),
                                            ("res3_1.branch2b", 512, 512, 3)])
def test_jax_init_of_the_new_parameters(key, cin, cout, k):
    """`jax_init_state_dict` for PResNet (flax Conv's lecun-normal kernels,
    BatchNorm 1 / 0, statistics 0 / 1) and the learned embedding (uniform in
    [0, 1)) against the JAX modules' `init` (one `ConvNorm` of each shape,
    the embedding): constants equal, draws of at least 1000 values by a
    two-sample KS test; every PResNet tensor takes one of those rules."""
    cfg, tsd = _fresh_res18()
    rules = {tk: jax_initializer(fp) for tk, _, fp, _ in build_mapping(cfg)}
    assert {r for t, (r, _) in rules.items()
            if t.startswith("backbone.0.encoder.")} == {"lecun_normal", "ones", "zeros"}
    assert rules["backbone.1.row_embed.weight"] == ("uniform", 1.0)
    conv = JaxConvNorm(cout, k, 1).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, cin)))
    pos = JaxLearnedPositionEncoding(cfg.hidden_dim // 2).init(jax.random.PRNGKey(1), 4, 4)
    t = f"backbone.0.encoder.{key}"
    mapping = [(t + ".conv.weight", "params", ("c", "conv", "kernel"), "conv_w"),
               (t + ".norm.weight", "params", ("c", "norm", "scale"), "raw"),
               (t + ".norm.bias", "params", ("c", "norm", "bias"), "raw"),
               (t + ".norm.running_mean", "batch_stats", ("c", "norm", "mean"), "raw"),
               (t + ".norm.running_var", "batch_stats", ("c", "norm", "var"), "raw"),
               ("backbone.1.row_embed.weight", "params", ("pos", "row_embed"), "raw"),
               ("backbone.1.col_embed.weight", "params", ("pos", "col_embed"), "raw")]
    jsd = tensors_from_jax(mapping, {"c": conv["params"], "pos": pos["params"]},
                           {"c": conv["batch_stats"]})
    for name, (rule, _) in ((n, rules[n]) for n in jsd if n in rules):
        assert tsd[name].shape == jsd[name].shape, name
        if rule in ("zeros", "ones"):
            assert torch.equal(tsd[name], jsd[name]), name
        elif tsd[name].numel() >= 1000:
            p = stats.ks_2samp(tsd[name].flatten().numpy(), jsd[name].flatten().numpy()).pvalue
            assert p >= 1e-3, (name, rule, p)
    w = tsd[t + ".conv.weight"]
    assert w.abs().max() < 2 * math.sqrt(1.0 / (cin * k * k)) / 0.87962566103423978  # flax's cut
    assert 0.0 <= tsd["backbone.1.col_embed.weight"].min() and \
        tsd["backbone.1.col_embed.weight"].max() < 1.0


def test_a_reference_checkpoint_with_the_shared_head_twice_loads():
    """The reference registers the iterative refinement's box head twice
    (`transformer.decoder.bbox_embed` is `bbox_embed`); its `.pth` loads
    strictly by `bbox_embed.*`, as the JAX package's mapping reads it."""
    cfg = variant(True, True, False)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    heads = {k: v for k, v in sd.items() if k.startswith("bbox_embed.")}
    twice = dict(sd, **{"transformer.decoder." + k: v.clone() for k, v in heads.items()})
    fresh = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    ema, _ = ckpt.resume_pth(fresh, "", use_ema=False, ckpt={"model": twice})
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert not any(k.startswith("transformer.decoder.bbox_embed") for k in fresh.state_dict())


def test_the_variant_eval_cli_gives_the_jax_stats(tmp_path):
    """`python -m lwdetr_tpu_torch.main --eval` with the variant decoder's flag
    set (one-stage, logits, the iterative refinement, the learned embedding;
    no preset sets them) on `tests/fixtures/micro_map_variants/` gives the 12
    stats the JAX package's pipeline gives (`gen_micro_map_variants_golden.py`)
    within 1e-7, in f32, with a `.pth` of the fixture's weights."""
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.weights import read_jax_npz

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixdir = os.path.join(root, "tests", "fixtures", "micro_map")
    with open(os.path.join(fixdir, "golden_stats_variants.json")) as f:
        golden = json.load(f)
    coco = os.path.join(root, golden["images"])
    cfg = cli.config_from_args(cli.parser().parse_args(
        ["--eval", "--coco_path", coco, *golden["flags"]])).model
    assert (cfg.two_stage, cfg.bbox_reparam, cfg.lite_refpoint_refine,
            cfg.position_embedding) == (False, False, False, "learned")
    tree = read_jax_npz(os.path.join(fixdir, "weights.npz"))
    sys.path.insert(0, os.path.join(root, "tests"))
    from gen_micro_map_variants_golden import embedding_tables
    row, col = embedding_tables(cfg.hidden_dim // 2)
    params = dict(tree["params"], pos_embedding={"row_embed": row, "col_embed": col})
    pth = tmp_path / "variant.pth"
    torch.save({"model": state_dict_from_jax(params, tree.get("batch_stats"), cfg)}, pth)
    cmd = [sys.executable, "-m", "lwdetr_tpu_torch.main", "--eval", "--device", "cpu",
           "--coco_path", coco, *golden["flags"],
           "--resume", str(pth), "--output_dir", str(tmp_path), "--num_workers", "2",
           "--dont_bench"]
    proc = subprocess.run(cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sum(0.0 < v < 1.0 for v in golden["stats"].values()) >= 8
    for k in sorted(golden["stats"]):
        np.testing.assert_allclose(stats[k], golden["stats"][k], atol=1e-7, rtol=0,
                                   err_msg=f"stat {k}")
