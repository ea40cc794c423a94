"""A fresh model of the port against the JAX package's `model.init`, on the CPU
in f32, at a reduced size: every constant-initialised tensor equal, every random
tensor of at least 1000 elements drawn from the same distribution (a two-sample
Kolmogorov-Smirnov test against JAX's own draw), the truncated normals inside
flax's cut, and the fresh model scoring at the focal prior, not at 0.5.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lwdetr_tpu.config import ModelConfig as JaxModelConfig
from lwdetr_tpu.models.lwdetr import build_model as jax_build_model
from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models.lwdetr import build_model
from lwdetr_tpu_torch.weights import (PRIOR_BIAS, _flax_shape, build_mapping,
                                      jax_init_state_dict, jax_initializer, state_dict_from_jax)

# the reduced model of the port's train tests, with a ViT wide enough (192) and
# a decoder of 128 channels, so that most random tensors hold over 1000 values
NANO = ModelConfig(
    encoder="vit_tiny", vit_encoder_num_layers=2, window_block_indexes=(0,),
    out_feature_indexes=(0, 1), projector_scale=("P4",), hidden_dim=128, dim_feedforward=256,
    sa_nheads=4, ca_nheads=8, dec_n_points=2, dec_layers=2, group_detr=3, num_queries=16,
    num_classes=91, two_stage=True, bbox_reparam=True, lite_refpoint_refine=True)
IMG = 128
KS_MIN_P = 1e-3
KS_MIN_SIZE = 1000


@pytest.fixture(scope="module")
def drawn():
    jmodel = jax_build_model(JaxModelConfig(**dataclasses.asdict(NANO)))
    variables = jax.jit(lambda rngs, x: jmodel.init(rngs, x, train=True))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, IMG, IMG, 3), jnp.float32))
    params = jax.tree.map(np.asarray, variables["params"])
    batch_stats = jax.tree.map(np.asarray, variables["batch_stats"])
    jsd = state_dict_from_jax(params, batch_stats, NANO)
    tsd = jax_init_state_dict(NANO, torch.Generator().manual_seed(0))
    rules = {tk: jax_initializer(fp) for tk, _, fp, _ in build_mapping(NANO)}
    return jmodel, variables, jsd, tsd, rules


def test_every_tensor_has_the_jax_shape_and_a_rule(drawn):
    _, _, jsd, tsd, rules = drawn
    assert set(tsd) == set(jsd)
    for k, t in tsd.items():
        assert t.shape == jsd[k].shape and t.dtype == jsd[k].dtype, k
    kinds = {rule for rule, _ in rules.values()}
    assert kinds == {"zeros", "ones", "constant", "grid", "normal", "truncated_normal",
                     "lecun_normal", "xavier_uniform"}


def test_constant_initialised_tensors_equal_the_jax_init(drawn):
    _, _, jsd, tsd, rules = drawn
    constants = [k for k, (rule, _) in rules.items()
                 if rule in ("zeros", "ones", "constant", "grid")]
    # the heads' prior, the box heads' zero last layers, the offsets' grid,
    # the ViT's layer scales, the norms and the BatchNorm statistics
    for name in ("class_embed.bias", "transformer.enc_out_class_embed.0.bias",
                 "bbox_embed.layers.2.weight", "refpoint_embed.weight",
                 "transformer.decoder.layers.0.cross_attn.sampling_offsets.bias",
                 "transformer.decoder.layers.0.cross_attn.sampling_offsets.weight",
                 "transformer.decoder.layers.1.cross_attn.attention_weights.weight",
                 "backbone.0.encoder.blocks.0.gamma_1",
                 "backbone.0.projector.stages.0.0.cv1.bn.running_var"):
        assert name in constants, name
    for k in constants:
        assert torch.equal(tsd[k], jsd[k]), k
    assert (tsd["class_embed.bias"] == np.float32(PRIOR_BIAS)).all()


def test_random_tensors_follow_the_jax_distributions(drawn):
    _, _, jsd, tsd, rules = drawn
    kinds = {tk: kind for tk, _, _, kind in build_mapping(NANO)}
    tested = []
    for k, (rule, arg) in rules.items():
        if rule in ("zeros", "ones", "constant", "grid") or tsd[k].numel() < KS_MIN_SIZE:
            continue
        p = stats.ks_2samp(tsd[k].flatten().numpy(), jsd[k].flatten().numpy()).pvalue
        assert p >= KS_MIN_P, (k, rule, p)
        tested.append(rule)
        if rule in ("truncated_normal", "lecun_normal"):
            # flax cuts at 2 standard deviations of the normal it scales
            if rule == "lecun_normal":
                fan_in = math.prod(_flax_shape(tsd[k].shape, kinds[k])[:-1])
                cut = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
            else:
                cut = 2 * arg
            assert tsd[k].abs().max().item() < cut, k
            assert jsd[k].abs().max().item() < cut, k
    assert {"normal", "truncated_normal", "lecun_normal", "xavier_uniform"} <= set(tested)


def test_a_fresh_model_scores_at_the_focal_prior(drawn):
    """F5: a fresh model's class probabilities sit near sigmoid(-4.595) = 0.01,
    as the JAX package's do, not near 0.5 (PyTorch's default initialisation)."""
    jmodel, variables, _, _, _ = drawn
    images = np.random.default_rng(3).standard_normal((2, IMG, IMG, 3)).astype(np.float32)
    model = build_model(NANO, device="cpu", generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        out = model(torch.from_numpy(images))
    jout = jmodel.apply(variables, jnp.asarray(images), train=False)
    prior = 1.0 / (1.0 + math.exp(-PRIOR_BIAS))
    for logits in (out["pred_logits"].numpy(), np.asarray(jout["pred_logits"]),
                   out["enc_outputs"]["pred_logits"].numpy()):
        mean = float(1.0 / (1.0 + np.exp(-logits.astype(np.float64))).mean())
        assert prior / 2 < mean < 3 * prior, mean


def test_the_generator_seeds_the_draw():
    a = build_model(NANO, device="cpu", generator=torch.Generator().manual_seed(1))
    b = build_model(NANO, device="cpu", generator=torch.Generator().manual_seed(1))
    c = build_model(NANO, device="cpu", generator=torch.Generator().manual_seed(2))
    w = "transformer.decoder.layers.0.linear1.weight"
    assert torch.equal(a.state_dict()[w], b.state_dict()[w])
    assert not torch.equal(a.state_dict()[w], c.state_dict()[w])
