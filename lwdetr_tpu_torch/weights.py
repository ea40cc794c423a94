"""Weights for the port: from the JAX package's variables, or drawn from a seed.

The port keeps its own copy of the JAX package's checkpoint mapping
(`lwdetr_tpu/train/checkpoint.py:26-200`): one entry per reference torch
state_dict key, naming the flax collection and path it comes from and the
layout transform between them:

  torch Linear  (out, in)         <- flax Dense kernel (in, out)
  torch Conv2d  (out, in, kh, kw) <- flax Conv kernel (kh, kw, in, out)
  torch ConvT2d (in, out, kh, kw) <- flax ConvTranspose kernel (kh, kw, in, out), flipped
  torch LN/BN weight              <- flax scale
  BN running_mean/var             <- batch_stats mean/var

`state_dict_from_jax` needs numpy only: it takes the JAX variables as nested
dicts of arrays. The map is linear, so `grads_from_jax` carries a JAX gradient
tree into the port's names and layouts the same way. `init_state_dict` draws every weight from a seed with a
`torch.Generator`, for runs that have no JAX.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models.projector import LEVEL2SCALE
from lwdetr_tpu_torch.ops.deform_attn import sampling_offsets_init_bias

# one mapping entry: (torch_key, collection, flax_path, kind)
Entry = Tuple[str, str, Tuple[str, ...], str]


def _dense(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".weight", "params", fp + ("kernel",), "dense_w"),
            (tk + ".bias", "params", fp + ("bias",), "raw")]


def _ln(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".weight", "params", fp + ("scale",), "raw"),
            (tk + ".bias", "params", fp + ("bias",), "raw")]


def _chan_ln(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".weight", "params", fp + ("weight",), "raw"),
            (tk + ".bias", "params", fp + ("bias",), "raw")]


def _bn(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".weight", "params", fp + ("scale",), "raw"),
            (tk + ".bias", "params", fp + ("bias",), "raw"),
            (tk + ".running_mean", "batch_stats", fp + ("mean",), "raw"),
            (tk + ".running_var", "batch_stats", fp + ("var",), "raw")]


def _convx(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".conv.weight", "params", fp + ("conv", "kernel"), "conv_w")] + \
        _bn(tk + ".bn", fp + ("bn",))


def _mlp_head(tk: str, fp: Tuple[str, ...], n: int = 3) -> List[Entry]:
    out = []
    for i in range(n):
        out += _dense(f"{tk}.layers.{i}", fp + (f"layers_{i}",))
    return out


def _c2f(tk: str, fp: Tuple[str, ...], n: int = 3) -> List[Entry]:
    out = _convx(tk + ".cv1", fp + ("cv1",)) + _convx(tk + ".cv2", fp + ("cv2",))
    for i in range(n):
        out += _convx(f"{tk}.m.{i}.cv1", fp + (f"m_{i}", "cv1"))
        out += _convx(f"{tk}.m.{i}.cv2", fp + (f"m_{i}", "cv2"))
    return out


def projector_mapping(proj_t: str, proj_f: Tuple[str, ...], scales, in_dims) -> List[Entry]:
    """The projector's entries: per scale, each tap's resampling layers, then
    the C2f stage and its channel LayerNorm. A scale of 0.25 is a subsample
    without parameters and takes no module index."""
    m: List[Entry] = []
    si = 0
    for scale in scales:
        if scale == 0.25:
            continue
        for j, in_dim in enumerate(in_dims):
            t = f"{proj_t}.stages_sampling.{si}.{j}"
            f = proj_f + (f"sampling_{si}_{j}",)
            if scale == 4.0:
                m.append((t + ".0.weight", "params", f + ("up1", "kernel"), "convT_w"))
                m.append((t + ".0.bias", "params", f + ("up1", "bias"), "raw"))
                m += _chan_ln(t + ".1", f + ("ln",))
                m.append((t + ".3.weight", "params", f + ("up2", "kernel"), "convT_w"))
                m.append((t + ".3.bias", "params", f + ("up2", "bias"), "raw"))
            elif scale == 2.0:
                if in_dim > 512:
                    m += _convx(t + ".0", f + ("reduce",))
                    m.append((t + ".1.weight", "params", f + ("up", "kernel"), "convT_w"))
                    m.append((t + ".1.bias", "params", f + ("up", "bias"), "raw"))
                else:
                    m.append((t + ".0.weight", "params", f + ("up", "kernel"), "convT_w"))
                    m.append((t + ".0.bias", "params", f + ("up", "bias"), "raw"))
            elif scale == 0.5:
                m += _convx(t + ".0", f + ("down",))
        m += _c2f(f"{proj_t}.stages.{si}.0", proj_f + (f"stage_{si}",))
        m += _chan_ln(f"{proj_t}.stages.{si}.1", proj_f + (f"stage_ln_{si}",))
        si += 1
    return m


def build_mapping(cfg: ModelConfig) -> List[Entry]:
    """Every reference state_dict key of `cfg`'s model with its flax source."""
    m: List[Entry] = []
    m += _dense("class_embed", ("class_embed",))
    m += _mlp_head("bbox_embed", ("bbox_embed",))
    m.append(("refpoint_embed.weight", "params", ("refpoint_embed",), "raw"))
    m.append(("query_feat.weight", "params", ("query_feat",), "raw"))
    if cfg.position_embedding == "learned":
        m.append(("backbone.1.row_embed.weight", "params", ("pos_embedding", "row_embed"), "raw"))
        m.append(("backbone.1.col_embed.weight", "params", ("pos_embedding", "col_embed"), "raw"))

    for i in range(cfg.dec_layers):
        t = f"transformer.decoder.layers.{i}"
        f = ("transformer", f"layers_{i}")
        m.append((t + ".self_attn.in_proj_weight", "params",
                  f + ("self_attn", "in_proj_kernel"), "dense_w"))
        m.append((t + ".self_attn.in_proj_bias", "params", f + ("self_attn", "in_proj_bias"), "raw"))
        m += _dense(t + ".self_attn.out_proj", f + ("self_attn", "out_proj"))
        for proj in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            m += _dense(t + f".cross_attn.{proj}", f + ("cross_attn", proj))
        m += _dense(t + ".linear1", f + ("linear1",))
        m += _dense(t + ".linear2", f + ("linear2",))
        for nrm in ("norm1", "norm2", "norm3"):
            m += _ln(t + f".{nrm}", f + (nrm,))
    m += _mlp_head("transformer.decoder.ref_point_head", ("transformer", "ref_point_head"), n=2)
    if cfg.decoder_norm == "LN":
        m += _ln("transformer.decoder.norm", ("transformer", "decoder_norm"))
    if cfg.two_stage:
        for g in range(cfg.group_detr):
            m += _dense(f"transformer.enc_output.{g}", ("transformer", f"enc_output_{g}"))
            m += _ln(f"transformer.enc_output_norm.{g}", ("transformer", f"enc_output_norm_{g}"))
            m += _dense(f"transformer.enc_out_class_embed.{g}",
                        ("transformer", f"enc_out_class_embed_{g}"))
            m += _mlp_head(f"transformer.enc_out_bbox_embed.{g}",
                           ("transformer", f"enc_out_bbox_embed_{g}"))

    enc_t = "backbone.0.encoder"
    enc_f = ("backbone", "encoder")
    if "vit" in cfg.encoder:
        m.append((enc_t + ".pos_embed", "params", enc_f + ("pos_embed",), "raw"))
        m.append((enc_t + ".patch_embed.proj.weight", "params",
                  enc_f + ("patch_embed", "kernel"), "conv_w"))
        m.append((enc_t + ".patch_embed.proj.bias", "params", enc_f + ("patch_embed", "bias"), "raw"))
        for i in range(cfg.vit_encoder_num_layers):
            t = f"{enc_t}.blocks.{i}"
            f = enc_f + (f"blocks_{i}",)
            m += _ln(t + ".norm1", f + ("norm1",))
            m += _ln(t + ".norm2", f + ("norm2",))
            m.append((t + ".attn.qkv.weight", "params", f + ("attn", "qkv_kernel"), "dense_w"))
            m.append((t + ".attn.q_bias", "params", f + ("attn", "q_bias"), "raw"))
            m.append((t + ".attn.v_bias", "params", f + ("attn", "v_bias"), "raw"))
            m += _dense(t + ".attn.proj", f + ("attn", "proj"))
            m.append((t + ".gamma_1", "params", f + ("gamma_1",), "raw"))
            m.append((t + ".gamma_2", "params", f + ("gamma_2",), "raw"))
            m += _dense(t + ".mlp.fc1", f + ("mlp", "fc1"))
            m += _dense(t + ".mlp.fc2", f + ("mlp", "fc2"))

    in_dim = cfg.embed_dim if "vit" in cfg.encoder else 0
    m += projector_mapping("backbone.0.projector", ("backbone", "projector"),
                           [LEVEL2SCALE[s] for s in cfg.projector_scale],
                           [in_dim] * len(cfg.out_feature_indexes))
    return m


def _f2t(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense_w":
        return arr.T
    if kind == "conv_w":
        return arr.transpose(3, 2, 0, 1)
    if kind == "convT_w":
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)
    return arr


def _get_path(tree: dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _bn_counters(keys) -> Dict[str, torch.Tensor]:
    """`num_batches_tracked` of every BatchNorm (torch keeps it in the state_dict)."""
    return {k[:-len("running_mean")] + "num_batches_tracked": torch.tensor(0, dtype=torch.long)
            for k in keys if k.endswith(".bn.running_mean")}


def tensors_from_jax(mapping: List[Entry], params: dict,
                     batch_stats: dict) -> Dict[str, torch.Tensor]:
    """The torch tensors of `mapping`'s entries, read from JAX `params` /
    `batch_stats` trees (nested dicts of arrays), plus the BatchNorm counters."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    sd = {tk: torch.from_numpy(np.ascontiguousarray(_f2t(np.asarray(_get_path(trees[coll], fp)),
                                                         kind)).astype(np.float32))
          for tk, coll, fp, kind in mapping}
    sd.update(_bn_counters(sd))
    return sd


def state_dict_from_jax(params: dict, batch_stats: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX `params` / `batch_stats` trees of `cfg`'s model -> a state_dict
    with the reference's keys that the port loads strictly."""
    return tensors_from_jax(build_mapping(cfg), params, batch_stats)


def grads_from_jax(grads: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree over `params` -> {parameter name: gradient} in the
    port's layouts (the transposes and the ConvTranspose flip of the weights),
    to hold `p.grad` against, key by key."""
    mapping = [e for e in build_mapping(cfg) if e[1] == "params"]
    return {tk: torch.from_numpy(np.ascontiguousarray(_f2t(np.asarray(_get_path(grads, fp)),
                                                           kind)).astype(np.float32))
            for tk, _, fp, kind in mapping}


def init_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights for `cfg`'s model drawn from `seed`, reference keys.

    Every weight is non-trivial (no zero-initialized heads or offsets), so
    every path of the forward depends on its inputs; scales keep the
    activations in the range a trained model's take."""
    from lwdetr_tpu_torch.models.lwdetr import LWDETR

    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).clamp_(-2 * std, 2 * std)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    prior = -math.log((1 - 0.01) / 0.01)
    sd = {}
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in LWDETR(cfg).state_dict().items()}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0, dtype=torch.long)
        elif k.endswith("running_mean"):
            sd[k] = normal(shape, 0.1)
        elif k.endswith("running_var"):
            sd[k] = uniform(shape, 0.5, 1.5)
        elif (".bn." in k or "norm" in k or len(shape) == 1 and
              re.search(r"projector\.stages(_sampling\.\d+)?\.\d+\.1\.weight$", k)):
            sd[k] = uniform(shape, 0.8, 1.2) if k.endswith("weight") else normal(shape, 0.05)
        elif k.endswith(("gamma_1", "gamma_2")):
            sd[k] = uniform(shape, 0.05, 0.15)
        elif k.endswith("query_feat.weight"):
            sd[k] = normal(shape, 1.0)
        elif k.endswith("refpoint_embed.weight"):
            sd[k] = normal(shape, 0.1)
        elif k.endswith("sampling_offsets.bias"):
            sd[k] = sampling_offsets_init_bias(cfg.ca_nheads, cfg.num_feature_levels,
                                               cfg.dec_n_points)
        elif "class_embed." in k and k.endswith(".bias"):
            sd[k] = prior + normal(shape, 0.1)
        elif k.endswith(("bias", "q_bias", "v_bias")):
            sd[k] = normal(shape, 0.02)
        elif k.endswith("pos_embed"):
            sd[k] = normal(shape, 0.02)
        elif len(shape) == 4 and "stages_sampling" in k and ".conv." not in k:
            # transposed conv (in, out, 2, 2), stride 2: one tap per output pixel
            sd[k] = normal(shape, 1.0 / math.sqrt(shape[0]))
        elif len(shape) == 4:  # conv (out, in, kh, kw): fan-in scaled
            sd[k] = normal(shape, 1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
        else:  # linear (out, in): fan-in scaled
            sd[k] = normal(shape, 1.0 / math.sqrt(shape[-1]))
    return sd
