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
tree into the port's names and layouts the same way. `jax_init_state_dict`
draws a fresh model's weights as the JAX package initialises its parameters
(each module's flax initialiser, from a `torch.Generator`): what `build_model`
loads when it is given no state_dict. `init_state_dict` draws every weight
non-trivially from a seed, for tests and benchmarks whose every path must
depend on its inputs. `read_jax_npz` reads a JAX
variable tree saved as `{keystr: array}` (the mAP fixture's `weights.npz`)
into nested dicts, with no JAX. `param_tensors_from_jax` carries any tree
shaped as `params` (the Adam moments of an orbax train state too), and
`jax_tree_mismatch` names the first leaf of a JAX tree that `cfg`'s model
lacks or has at another shape.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models.lwdetr import encoder_channels
from lwdetr_tpu_torch.models.presnet import RESNET_CFG, depth_of
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


def _conv_norm(tk: str, fp: Tuple[str, ...]) -> List[Entry]:
    return [(tk + ".conv.weight", "params", fp + ("conv", "kernel"), "conv_w")] + \
        _bn(tk + ".norm", fp + ("norm",))


def presnet_mapping(enc_t: str, enc_f: Tuple[str, ...], depth: int) -> List[Entry]:
    """PResNet's entries (the JAX table maps the ViT only,
    `lwdetr_tpu/train/checkpoint.py:135`): each `ConvNorm` as a conv kernel
    and a BatchNorm, its statistics from `batch_stats`, in module order; the
    keys are the flax tree's names under `enc_t` (the reference's PResNet
    names are recorded nowhere in the repository)."""
    m = []
    for name in ("conv1_1", "conv1_2", "conv1_3"):
        m += _conv_norm(f"{enc_t}.{name}", enc_f + (name,))
    branches = ("branch2a", "branch2b") + (("branch2c",) if depth >= 50 else ())
    for i, n in enumerate(RESNET_CFG[depth]):
        for b in range(n):
            t, f = f"{enc_t}.res{i}_{b}", enc_f + (f"res{i}_{b}",)
            for br in branches:
                m += _conv_norm(f"{t}.{br}", f + (br,))
            if b == 0:  # the first block's shortcut: variant d's pooled 1x1 at stride 2
                short = "short_conv" if i != 0 else "short"
                m += _conv_norm(f"{t}.{short}", f + (short,))
    return m


def build_mapping(cfg: ModelConfig) -> List[Entry]:
    """Every reference state_dict key of `cfg`'s model with its flax source:
    the JAX package's table (`lwdetr_tpu/train/checkpoint.py::build_mapping`),
    with PResNet's rows and the projector's inputs taken from the encoder
    (PResNet's one concatenated map, where the JAX table assumes one input a
    ViT tap)."""
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
    elif "res" in cfg.encoder:
        m += presnet_mapping(enc_t, enc_f, depth_of(cfg.encoder))

    m += projector_mapping("backbone.0.projector", ("backbone", "projector"),
                           [LEVEL2SCALE[s] for s in cfg.projector_scale], encoder_channels(cfg))
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
            for k in keys if k.endswith(".running_mean")}


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


_KEY_PART = re.compile(r"\['([^']*)'\]")


def read_jax_npz(path: str) -> Dict[str, dict]:
    """A JAX variable tree saved as {`jax.tree_util.keystr(path)`: array}
    (keys such as "['params']['backbone']['encoder']['blocks_0']['attn']['qkv']['kernel']")
    -> {collection: nested dict of float32 arrays}; half-precision entries
    are upcast. Feed `tree["params"]`, `tree.get("batch_stats")` to
    `state_dict_from_jax`."""
    tree: Dict[str, dict] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _KEY_PART.findall(key)
            if not parts or "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"{path}: {key!r} is not a key path of dict keys")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key], np.float32)
    return tree


def state_dict_from_jax(params: dict, batch_stats: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX `params` / `batch_stats` trees of `cfg`'s model -> a state_dict
    with the reference's keys that the port loads strictly."""
    return tensors_from_jax(build_mapping(cfg), params, batch_stats)


# the layout changes of `_f2t`: each only moves elements, so a tree shaped as
# `params` (a gradient, an Adam moment) goes through it as the weights do
REARRANGEMENTS = ("raw", "dense_w", "conv_w", "convT_w")


def param_tensors_from_jax(tree: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A JAX tree shaped as `params` (gradients, Adam's moments) -> {parameter
    name: tensor} in the port's layouts, each entry's layout change applied as
    to its weight (the transposes and the ConvTranspose flip). An entry whose
    change is no pure rearrangement of the elements cannot carry such a tree:
    it is refused, with the others like it."""
    mapping = [e for e in build_mapping(cfg) if e[1] == "params"]
    bad = [tk for tk, _, _, kind in mapping if kind not in REARRANGEMENTS]
    if bad:
        raise ValueError(f"{len(bad)} weights change layout by more than a rearrangement, so "
                         f"a tree over the parameters cannot follow them: {bad}")
    return {tk: torch.from_numpy(np.ascontiguousarray(_f2t(np.asarray(_get_path(tree, fp)),
                                                           kind)).astype(np.float32))
            for tk, _, fp, kind in mapping}


def grads_from_jax(grads: dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree over `params` -> {parameter name: gradient} in the
    port's layouts, to hold `p.grad` against, key by key."""
    return param_tensors_from_jax(grads, cfg)


def model_shapes(cfg: ModelConfig) -> Dict[str, torch.Size]:
    """The shape of each state_dict entry of `cfg`'s model (built on the meta device)."""
    from lwdetr_tpu_torch.models.lwdetr import LWDETR

    with torch.device("meta"):
        return {k: v.shape for k, v in LWDETR(cfg).state_dict().items()}


def jax_tree_mismatch(tree: dict, cfg: ModelConfig, collection: str) -> str:
    """The first leaf of the JAX tree `tree` of `collection` ("params" or
    "batch_stats") that `cfg`'s model lacks, misses or has at another shape,
    named by its path; an empty string when the tree is the model's."""
    shapes = model_shapes(cfg)
    want = {"/".join(fp): _flax_shape(shapes[tk], kind)
            for tk, coll, fp, kind in build_mapping(cfg) if coll == collection}
    have = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            have["/".join(path)] = tuple(np.shape(node))

    walk(tree or {}, ())
    for path in sorted(want):
        if path not in have:
            return f"missing leaf {collection}/{path}"
        if have[path] != tuple(want[path]):
            return (f"leaf {collection}/{path} has shape {have[path]}, the model's is "
                    f"{tuple(want[path])}")
    extra = sorted(set(have) - set(want))
    return f"extra leaf {collection}/{extra[0]}" if extra else ""


_SQRT2 = math.sqrt(2.0)
# the std of a standard normal cut at +-2 (the correction of flax's variance-scaling draws)
_TRUNC2_STD = 0.87962566103423978
PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def truncated_normal(shape, std: float, g: torch.Generator) -> torch.Tensor:
    """`jax.random.truncated_normal(key, -2, 2, shape) * std`: a standard normal
    cut at +-2 by the inverse CDF of a uniform draw between the cut's CDF
    values (the JAX sampler's method), clamped inside the open interval, then
    scaled; float32."""
    lo, hi = math.erf(-2.0 / _SQRT2), math.erf(2.0 / _SQRT2)
    u = torch.rand(shape, generator=g, dtype=torch.float64) * (hi - lo) + lo
    x = (torch.erfinv(u) * _SQRT2).float()
    edge = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    return x.clamp_(-edge, edge) * std


def _xavier_uniform(shape, g: torch.Generator) -> torch.Tensor:
    """flax `xavier_uniform` of a Dense kernel (in, out): uniform in
    +-sqrt(6 / (in + out))."""
    limit = math.sqrt(6.0 / (shape[-2] + shape[-1]))
    return (torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1).float() * limit


def _lecun_normal(shape, g: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal` (the default of nn.Dense, nn.Conv, nn.ConvTranspose)
    of a kernel (..., in, out): truncated normal with std sqrt(1 / fan_in),
    fan_in = in x the receptive field, corrected for the cut."""
    fan_in = math.prod(shape[:-1])
    return truncated_normal(shape, math.sqrt(1.0 / fan_in) / _TRUNC2_STD, g)


def jax_initializer(path: Tuple[str, ...]):
    """The initialiser the JAX package gives the parameter or batch statistic
    at flax `path`: ("zeros" | "ones" | "constant" | "grid" | "normal" |
    "uniform" | "truncated_normal" | "lecun_normal" | "xavier_uniform",
    argument). From `lwdetr_tpu/models/vit.py:87-94, :126, :154, :173,
    :204-205, :246, :290`, `projector.py` and `presnet.py` (flax's defaults:
    lecun-normal kernels, zero biases, unit scales, BatchNorm statistics 0 /
    1), `transformer.py:61-72, :90-92, :119, :137, :301, :309-319, :343, :353,
    :411, :416, :523-540` and `lwdetr.py:98-101` (the learned embedding,
    U[0, 1)), `:136-146`."""
    leaf = path[-1]
    if path[:2] == ("backbone", "encoder") and path[2].startswith(("conv1_", "res")):
        # PResNet: flax Conv's lecun-normal kernels, BatchNorm 1 / 0, statistics 0 / 1
        if leaf == "kernel":
            return ("lecun_normal", None)
        return ("ones", None) if leaf in ("scale", "var") else ("zeros", None)
    if path[0] == "pos_embedding":  # nn.initializers.uniform(1.0): U[0, 1)
        return ("uniform", 1.0)
    if path[:2] == ("backbone", "encoder"):  # the ViT
        if leaf in ("pos_embed", "qkv_kernel") or (leaf == "kernel" and path[2] != "patch_embed"):
            return ("truncated_normal", 0.02)
        if leaf == "kernel":
            return ("lecun_normal", None)
        if leaf in ("gamma_1", "gamma_2"):
            return ("constant", 0.1)
        return ("ones", None) if leaf == "scale" else ("zeros", None)
    if path[:2] == ("backbone", "projector"):
        if leaf == "kernel":
            return ("lecun_normal", None)
        return ("ones", None) if leaf in ("scale", "weight", "var") else ("zeros", None)
    if leaf == "refpoint_embed":
        return ("zeros", None)
    if leaf == "query_feat":
        return ("normal", 1.0)
    owner = path[-2]
    if leaf == "scale":
        return ("ones", None)
    if owner == "class_embed" or owner.startswith("enc_out_class_embed_"):
        return ("lecun_normal", None) if leaf == "kernel" else ("constant", PRIOR_BIAS)
    if owner == "sampling_offsets":
        return ("zeros", None) if leaf == "kernel" else ("grid", None)
    if owner == "attention_weights":
        return ("zeros", None)
    # the box heads' last layer is zero (`zero_init_last`); their other
    # layers, like every other kernel of the decoder, are xavier-uniform
    head = path[-3] if len(path) > 2 else ""
    if leaf in ("kernel", "in_proj_kernel"):
        last = head == "bbox_embed" or head.startswith("enc_out_bbox_embed_")
        if last and owner == "layers_2":
            return ("zeros", None)
        return ("xavier_uniform", None)
    return ("zeros", None)


def _flax_shape(shape, kind: str) -> Tuple[int, ...]:
    """The flax layout of a torch tensor's shape (the inverse of `_f2t`'s transform)."""
    if kind == "dense_w":
        return tuple(shape)[::-1]
    if kind in ("conv_w", "convT_w"):  # (out | in, in | out, kh, kw) -> (kh, kw, in, out)
        a, b, kh, kw = shape
        return (kh, kw, b, a) if kind == "conv_w" else (kh, kw, a, b)
    return tuple(shape)


def jax_init_state_dict(cfg: ModelConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh model's weights as the JAX package initialises them (its
    `model.init`), drawn from `generator` in the order of `build_mapping`
    and laid out as the reference's state_dict: every constant equals JAX's
    exactly (zeros, ones, the layer scales 0.1, the focal prior of the class
    heads, the sampling offsets' grid), every random tensor follows JAX's
    distribution (JAX's own bits come from its PRNG, not these). float32."""
    shapes = model_shapes(cfg)
    sd = {}
    for tk, _, fp, kind in build_mapping(cfg):
        shape = _flax_shape(shapes[tk], kind)
        rule, arg = jax_initializer(fp)
        if rule == "zeros":
            arr = torch.zeros(shape)
        elif rule == "ones":
            arr = torch.ones(shape)
        elif rule == "constant":
            arr = torch.full(shape, float(arg))
        elif rule == "grid":
            arr = sampling_offsets_init_bias(cfg.ca_nheads, cfg.num_feature_levels,
                                             cfg.dec_n_points)
        elif rule == "normal":
            arr = torch.randn(shape, generator=generator) * arg
        elif rule == "uniform":
            arr = torch.rand(shape, generator=generator) * arg
        elif rule == "truncated_normal":
            arr = truncated_normal(shape, arg, generator)
        elif rule == "lecun_normal":
            arr = _lecun_normal(shape, generator)
        else:
            arr = _xavier_uniform(shape, generator)
        sd[tk] = torch.from_numpy(np.ascontiguousarray(_f2t(arr.numpy(), kind)))
    sd.update(_bn_counters(sd))
    return sd


def init_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights for `cfg`'s model drawn from `seed`, reference keys.

    Every weight is non-trivial (no zero-initialized heads or offsets), so
    every path of the forward depends on its inputs; scales keep the
    activations in the range a trained model's take."""
    g = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return (torch.randn(shape, generator=g) * std).clamp_(-2 * std, 2 * std)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=g) * (hi - lo) + lo

    prior = PRIOR_BIAS
    sd = {}
    for k, shape in model_shapes(cfg).items():
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
