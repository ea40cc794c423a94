"""Parity of the PyTorch port's modules and whole model with the JAX package.

On the CPU, in f32, at a reduced depth and width: the JAX model is
initialized from a PRNG key, its variables cross into the port through
`lwdetr_tpu_torch.weights.state_dict_from_jax` and a strict
`load_state_dict`, and the same images go through both.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import get_config as jax_get_config
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.models.lwdetr import post_process as jax_post_process
from lwdetr_tpu.models.projector import MultiScaleProjector as JaxProjector
from lwdetr_tpu.models.transformer import MSDeformAttnModule as JaxMSDeformAttn
from lwdetr_tpu.models.transformer import gen_encoder_output_proposals as jax_gen_proposals
from lwdetr_tpu_torch.config import ModelConfig, get_config
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model, post_process
from lwdetr_tpu_torch.models import transformer as ttr
from lwdetr_tpu_torch.models.projector import MultiScaleProjector
from lwdetr_tpu_torch.models.transformer import MSDeformAttnModule
from lwdetr_tpu_torch.ops import deform_attn as tda
from lwdetr_tpu_torch.weights import (build_mapping, init_state_dict, projector_mapping,
                                      state_dict_from_jax, tensors_from_jax)

# vit_tiny width with 3 blocks (one window block), hidden 64, 128x128 images
CFG = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=3, window_block_indexes=(0,),
    out_feature_indexes=(1, 2), projector_scale=("P4",), hidden_dim=64,
    dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2,
    group_detr=2, num_queries=12, num_select=10, num_classes=7,
    two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
IMG = 128
# the large / xlarge layout at vit_tiny width: P3 + P5 levels, 4 sampling
# points, cross-attention head_dim 16; at 512x512 the memory holds
# 64 * 64 + 16 * 16 = 4352 >= 4096 positions, so the decoder samples from
# head-major panels
CFG_LARGE = dataclasses.replace(CFG, projector_scale=("P3", "P5"), ca_nheads=4, dec_n_points=4)
IMG_LARGE = 512
# xlarge's projector branch: ViT-base taps (768 > 512 channels) go through the
# 1x1 reduce before the transposed convolution; two blocks, 128x128
CFG_XLARGE = dataclasses.replace(CFG_LARGE, encoder="vit_base", vit_encoder_num_layers=2,
                                 out_feature_indexes=(0, 1))

# f32 through ~20 layers on both sides with sums in another order: agreement
# to 1e-4 absolute on outputs of order 1
ATOL = 1e-4


def _jax_cfg(cfg: ModelConfig) -> JaxModelConfig:
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _jax_variables(cfg: ModelConfig, seed: int = 0):
    model = jax_build_model(_jax_cfg(cfg))
    variables = jax.jit(lambda rngs, x: model.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    # zero-initialized heads and offsets would hide errors in whole paths:
    # perturb every parameter a little, as a trained model's would be
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(l) + 0.02 * rng.standard_normal(l.shape).astype(np.float32)
              for l in leaves]
    params = jax.tree_util.tree_unflatten(treedef, leaves)
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    return model, params, stats


def _bridge(cfg: ModelConfig, img: int, batch: int):
    jmodel, params, stats = _jax_variables(cfg)
    sd = state_dict_from_jax(params, stats, cfg)
    tmodel = build_model(cfg, device="cpu", state_dict=sd)
    images = np.random.default_rng(7).standard_normal((batch, img, img, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    return jmodel, params, stats, tmodel, images, jout, tout


@pytest.fixture(scope="module")
def bridged():
    return _bridge(CFG, IMG, 2)


@pytest.fixture(scope="module")
def bridged_two_level(request):
    """(cfg, sampler calls {name: count}, JAX outputs, port outputs) of a
    reduced two-level model; the JAX model takes its gather branch on the CPU
    (every branch computes one function)."""
    cfg, img = request.param
    spies = {name: mock.Mock(wraps=getattr(tda, name))
             for name in ("ms_deform_attn_cm", "ms_deform_attn_sep_panels")}
    with mock.patch.multiple(tda, **spies):
        *_, jout, tout = _bridge(cfg, img, 1)
    return cfg, {name: spy.call_count for name, spy in spies.items()}, jout, tout


@pytest.mark.parametrize("preset", ["tiny", "small", "medium", "large", "xlarge"])
def test_state_dict_keys_match_reference_mapping(preset):
    cfg = get_config(preset)
    with torch.device("meta"):
        keys = set(LWDETR(cfg).state_dict())
    mapped = {k for k, _, _, _ in build_mapping(cfg)}
    counters = {k for k in keys if k.endswith("num_batches_tracked")}
    assert keys - counters == mapped
    # the port's copy of the mapping is the JAX package's table, entry for entry
    from lwdetr_tpu.train.checkpoint import build_mapping as jax_build_mapping

    assert build_mapping(cfg) == jax_build_mapping(jax_get_config(preset).model)


@pytest.mark.parametrize("variant", [dict(two_stage=False), dict(bbox_reparam=False),
                                     dict(lite_refpoint_refine=False),
                                     dict(position_embedding="learned")])
def test_unported_variants_are_refused(variant):
    with pytest.raises(NotImplementedError, match="not ported"):
        LWDETR(dataclasses.replace(CFG, **variant))


def test_presets_match_jax():
    for name in ("tiny", "small", "medium", "large", "xlarge"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(jax_get_config(name).model), name


def test_backbone_features_match_jax(bridged):
    jmodel, params, stats, tmodel, images, _, _ = bridged
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, method=lambda m, y: m.backbone(y)))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images))
    with torch.no_grad():
        out = tmodel.backbone[0](torch.from_numpy(images))
    assert len(out) == len(ref) == 1
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=ATOL)


@pytest.mark.parametrize("key", ["pred_logits", "pred_boxes"])
def test_eval_forward_matches_jax(bridged, key):
    _, _, _, _, _, jout, tout = bridged
    assert tout[key].shape == jout[key].shape
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=ATOL)
    for i, aux in enumerate(jout["aux_outputs"]):
        np.testing.assert_allclose(tout["aux_outputs"][i][key].numpy(), np.asarray(aux[key]),
                                   atol=ATOL)
    np.testing.assert_allclose(tout["enc_outputs"][key].numpy(),
                               np.asarray(jout["enc_outputs"][key]), atol=ATOL)


def test_post_process_matches_jax(bridged):
    _, _, _, _, _, jout, tout = bridged
    sizes = np.array([[IMG, IMG], [96, 160]], np.float32)
    js, jl, jb = jax_post_process(jout["pred_logits"], jout["pred_boxes"], jnp.asarray(sizes),
                                  num_select=CFG.num_select)
    ts, tl, tb = post_process(tout["pred_logits"], tout["pred_boxes"], torch.from_numpy(sizes),
                              num_select=CFG.num_select)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    # the selections agree as sets of flat (query, label) indices: the order
    # of tied logits may differ between torch.topk and lax.top_k
    flat_j = np.asarray(jout["pred_logits"]).reshape(2, -1)
    flat_t = tout["pred_logits"].reshape(2, -1)
    for b in range(2):
        sel_j = set(np.argsort(-flat_j[b], kind="stable")[:CFG.num_select].tolist())
        sel_t = set(torch.topk(flat_t[b], CFG.num_select).indices.tolist())
        assert sel_t == sel_j
    # these logits hold no ties, so the ranked detections agree one to one
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-2)  # pixels


def _module_against_jax(shapes, B, Q, C, H, P, branch):
    """The port's module (its own dispatch) against the JAX module forced onto
    `branch` with its kernel in interpret mode; returns the port's sampler
    call counts."""
    rng = np.random.default_rng(11)
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    memory = rng.standard_normal((B, sum(h * w for h, w in shapes), C)).astype(np.float32)
    refs = rng.uniform(0.05, 0.95, (B, Q, len(shapes), 4)).astype(np.float32)
    refs[..., 2:] *= 0.5
    jmod = JaxMSDeformAttn(d_model=C, n_levels=len(shapes), n_heads=H, n_points=P,
                           force_branch=branch, kernel_interpret=True)
    # every branch has the same parameter tree; the gather branch inits fastest
    params = JaxMSDeformAttn(d_model=C, n_levels=len(shapes), n_heads=H, n_points=P,
                             force_branch="gather").init(
        jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(refs), jnp.asarray(memory),
        shapes)["params"]
    params = {name: {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in p.items()} for name, p in params.items()}
    ref = jax.jit(lambda v, q, r, m: jmod.apply(v, q, r, m, shapes))(
        {"params": params}, jnp.asarray(query), jnp.asarray(refs), jnp.asarray(memory))

    tmod = MSDeformAttnModule(C, len(shapes), H, P).eval()
    tmod.load_state_dict({f"{name}.{'weight' if k == 'kernel' else k}":
                          torch.from_numpy(np.ascontiguousarray(v.T if k == "kernel" else v))
                          for name, p in params.items() for k, v in p.items()}, strict=True)
    spies = {name: mock.Mock(wraps=getattr(tda, name))
             for name in ("ms_deform_attn_cm", "ms_deform_attn_sep_panels")}
    with torch.no_grad(), mock.patch.multiple(tda, **spies):
        levels = torch.from_numpy(memory).split([h * w for h, w in shapes], dim=1)
        out = tmod(torch.from_numpy(query), torch.from_numpy(refs), torch.from_numpy(memory),
                   shapes, levels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    return {name: spy.call_count for name, spy in spies.items()}


def test_ms_deform_attn_module_matches_jax_cm_branch():
    # 100 positions < 4096: channel-major values
    calls = _module_against_jax(((8, 10), (4, 5)), B=2, Q=9, C=32, H=4, P=2, branch="cm")
    assert calls == {"ms_deform_attn_cm": 1, "ms_deform_attn_sep_panels": 0}


def test_ms_deform_attn_module_matches_jax_panel_branch():
    # 64 * 64 + 16 * 16 = 4352 positions >= 4096: the port takes its panel
    # branch by its own dispatch (head_dim 16, 4 points, as large / xlarge)
    assert sum(h * w for h, w in ((64, 64), (16, 16))) >= ttr.SEP_MIN_LEN_IN
    calls = _module_against_jax(((64, 64), (16, 16)), B=1, Q=9, C=32, H=2, P=4, branch="sep")
    assert calls == {"ms_deform_attn_cm": 0, "ms_deform_attn_sep_panels": 1}


def test_dispatch_threshold_is_the_jax_packages():
    # one constant: in eval a memory of exactly 4096 positions takes the panels,
    # 4095 does not; in train mode every memory does (`train or Len_in >= 4096`)
    assert ttr.SEP_MIN_LEN_IN == 4096
    mod = MSDeformAttnModule(32, 1, 2, 2)
    g = torch.Generator().manual_seed(0)
    query = torch.randn(1, 3, 32, generator=g)
    refs = torch.rand(1, 3, 1, 2, generator=g)
    for train, shape, name in ((False, (64, 64), "ms_deform_attn_sep_panels"),
                               (False, (63, 65), "ms_deform_attn_cm"),
                               (True, (63, 65), "ms_deform_attn_sep_panels"),
                               (True, (4, 5), "ms_deform_attn_sep_panels")):
        mod.train(train)
        memory = torch.randn(1, shape[0] * shape[1], 32, generator=g)
        with torch.no_grad(), mock.patch.object(tda, name, wraps=getattr(tda, name)) as spy:
            mod(query, refs, memory, [shape], [memory])
        assert spy.call_count == 1, (train, shape)


def test_init_state_dict_is_seeded_and_loads_strictly():
    a, b, c = init_state_dict(CFG, 0), init_state_dict(CFG, 0), init_state_dict(CFG, 1)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_feat.weight"], c["query_feat.weight"])
    model = build_model(CFG, device="cpu", state_dict=a)
    with torch.no_grad():
        out = model(torch.randn(1, IMG, IMG, 3, generator=torch.Generator().manual_seed(0)))
    assert out["pred_logits"].shape == (1, CFG.num_queries, CFG.num_classes)
    assert torch.isfinite(out["pred_logits"]).all() and torch.isfinite(out["pred_boxes"]).all()


@pytest.mark.parametrize("bridged_two_level", [(CFG_LARGE, IMG_LARGE), (CFG_XLARGE, IMG)],
                         ids=["large-like-512", "xlarge-like-128"], indirect=True)
@pytest.mark.parametrize("key", ["pred_logits", "pred_boxes"])
def test_two_level_eval_forward_matches_jax(bridged_two_level, key):
    cfg, calls, jout, tout = bridged_two_level
    # the 512x512 memory (4352 positions) is sampled from panels in every
    # decoder layer, the 128x128 one (16 * 16 + 4 * 4) from channel-major values
    panel = cfg is CFG_LARGE
    assert calls == {"ms_deform_attn_sep_panels": cfg.dec_layers * panel,
                     "ms_deform_attn_cm": cfg.dec_layers * (not panel)}
    assert tout[key].shape == jout[key].shape
    np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=ATOL)
    for i, aux in enumerate(jout["aux_outputs"]):
        np.testing.assert_allclose(tout["aux_outputs"][i][key].numpy(), np.asarray(aux[key]),
                                   atol=ATOL)
    np.testing.assert_allclose(tout["enc_outputs"][key].numpy(),
                               np.asarray(jout["enc_outputs"][key]), atol=ATOL)


@pytest.mark.parametrize("scales,in_dim", [((2.0, 0.5), 384), ((2.0, 0.5), 768),
                                           ((4.0, 0.25), 64), ((1.0,), 48)],
                         ids=["P3P5-small-taps", "P3P5-base-taps", "4x-and-P6", "P4"])
def test_projector_matches_jax(scales, in_dim):
    """Every scale the JAX projector has, with weights drawn from a seed (a
    transposed-convolution kernel that is not symmetric shows a missing flip)."""
    taps, out_ch, hw = 2, 32, 6
    rng = np.random.default_rng(13)
    feats = [rng.standard_normal((2, hw, hw, in_dim)).astype(np.float32) for _ in range(taps)]
    jmod = JaxProjector(in_channels=[in_dim] * taps, out_channels=out_ch, scale_factors=scales)
    variables = jmod.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    variables = jax.tree.map(
        lambda v: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32), variables)
    variables["batch_stats"] = jax.tree.map(np.abs, variables["batch_stats"])  # var > 0
    ref = jmod.apply(variables, [jnp.asarray(f) for f in feats])

    tmod = MultiScaleProjector([in_dim] * taps, out_ch, scales).eval()
    sd = tensors_from_jax(projector_mapping("p", (), scales, [in_dim] * taps),
                          variables["params"], variables["batch_stats"])
    tmod.load_state_dict({k[len("p."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        out = tmod([torch.from_numpy(f) for f in feats])
    assert [tuple(o.shape) for o in out] == [tuple(r.shape) for r in ref]
    assert [o.shape[1] for o in out] == [int(hw * s) if s != 0.25 else int(hw * scales[0]) // 2
                                         for s in scales]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)


def test_projector_4x_gelu_follows_the_dtype():
    # erf GELU in f32, tanh GELU in bf16, as the JAX projector's gate
    from lwdetr_tpu_torch.models.projector import GELU

    x = torch.linspace(-3, 3, 64)
    torch.testing.assert_close(GELU()(x), torch.nn.functional.gelu(x))
    torch.testing.assert_close(GELU()(x.bfloat16()),
                               torch.nn.functional.gelu(x.bfloat16(), approximate="tanh"))


def test_encoder_output_proposals_match_jax_on_two_levels():
    shapes = ((8, 8), (2, 2))
    memory = np.random.default_rng(17).standard_normal((2, 68, 16)).astype(np.float32)
    jmem, jprop = jax_gen_proposals(jnp.asarray(memory), None, shapes, unsigmoid=False)
    tmem, tprop = ttr.gen_encoder_output_proposals(torch.from_numpy(memory), shapes)
    np.testing.assert_allclose(tprop.numpy(), np.asarray(jprop), atol=1e-7)
    np.testing.assert_array_equal(tmem.numpy(), np.asarray(jmem))
    # level 1's anchors are twice level 0's
    assert tprop[0, 64 + 1, 2].item() == pytest.approx(0.1) and tprop[0, 9, 2].item() == pytest.approx(0.05)


@pytest.mark.parametrize("preset", ["large", "xlarge"])
def test_init_state_dict_loads_strictly_into_the_two_level_presets(preset):
    cfg = get_config(preset)
    sd = init_state_dict(cfg, seed=0)
    with torch.device("meta"):
        model = LWDETR(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    # every transposed convolution of P3 and every stage norm drew real weights
    ups = [k for k, v in sd.items() if "stages_sampling.0" in k and v.dim() == 4
           and ".conv." not in k]
    assert len(ups) == len(cfg.out_feature_indexes)
    assert all(sd[k].std() > 0 for k in ups)
    assert 0.8 <= sd["backbone.0.projector.stages.1.1.weight"].min() <= 1.2
