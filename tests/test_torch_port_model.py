"""Parity of the PyTorch port's modules and whole model with the JAX package.

On the CPU, in f32, at a reduced depth and width: the JAX model is
initialized from a PRNG key, its variables cross into the port through
`lwdetr_tpu_torch.weights.state_dict_from_jax` and a strict
`load_state_dict`, and the same images go through both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.config import get_config as jax_get_config
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu.models.lwdetr import post_process as jax_post_process
from lwdetr_tpu.models.transformer import MSDeformAttnModule as JaxMSDeformAttn
from lwdetr_tpu_torch.config import ModelConfig, get_config
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model, post_process
from lwdetr_tpu_torch.models.transformer import MSDeformAttnModule
from lwdetr_tpu_torch.weights import build_mapping, init_state_dict, state_dict_from_jax

# vit_tiny width with 3 blocks (one window block), hidden 64, 128x128 images
CFG = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=3, window_block_indexes=(0,),
    out_feature_indexes=(1, 2), projector_scale=("P4",), hidden_dim=64,
    dim_feedforward=128, sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2,
    group_detr=2, num_queries=12, num_select=10, num_classes=7,
    two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
IMG = 128

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


@pytest.fixture(scope="module")
def bridged():
    jmodel, params, stats = _jax_variables(CFG)
    sd = state_dict_from_jax(params, stats, CFG)
    tmodel = build_model(CFG, device="cpu", state_dict=sd)
    images = np.random.default_rng(7).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    jout = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images))
    with torch.no_grad():
        tout = tmodel(torch.from_numpy(images))
    return jmodel, params, stats, tmodel, images, jout, tout


@pytest.mark.parametrize("preset", ["tiny", "small", "medium"])
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


def test_ms_deform_attn_module_matches_jax_cm_branch():
    shapes = ((8, 10), (4, 5))
    B, Q, C, H, P = 2, 9, 32, 4, 2
    rng = np.random.default_rng(11)
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    memory = rng.standard_normal((B, sum(h * w for h, w in shapes), C)).astype(np.float32)
    refs = rng.uniform(0.05, 0.95, (B, Q, len(shapes), 4)).astype(np.float32)
    refs[..., 2:] *= 0.5
    jmod = JaxMSDeformAttn(d_model=C, n_levels=len(shapes), n_heads=H, n_points=P,
                           force_branch="cm", kernel_interpret=True)
    # every branch has the same parameter tree; the gather branch inits fastest
    params = JaxMSDeformAttn(d_model=C, n_levels=len(shapes), n_heads=H, n_points=P,
                             force_branch="gather").init(
        jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(refs), jnp.asarray(memory),
        shapes)["params"]
    params = {name: {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in p.items()} for name, p in params.items()}
    ref = jax.jit(lambda v, q, r, m: jmod.apply(v, q, r, m, shapes))(
        {"params": params}, jnp.asarray(query), jnp.asarray(refs), jnp.asarray(memory))

    tmod = MSDeformAttnModule(C, len(shapes), H, P)
    tmod.load_state_dict({f"{name}.{'weight' if k == 'kernel' else k}":
                          torch.from_numpy(np.ascontiguousarray(v.T if k == "kernel" else v))
                          for name, p in params.items() for k, v in p.items()}, strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(query), torch.from_numpy(refs), torch.from_numpy(memory),
                   shapes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


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
