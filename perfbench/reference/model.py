"""LW-DETR in plain PyTorch, float32: the benchmark's reference forward.

Written from the published architecture (LW-DETR, arXiv 2406.03459, and the
authors' release scripts `scripts/lwdetr_{size}_coco_train.sh`): a plain ViT
whose blocks attend inside 4 x 4 windows or over the whole map, a
multi-scale projector (transposed / strided convolutions, C2f, channel
LayerNorm), a two-stage deformable DETR decoder with group queries,
reparameterised boxes and the lite reference-point refinement, and the
top-k `post_process`. The parameter names are those of the authors'
checkpoints, so one state dict loads into this module and into the program.

Nothing here calls a kernel of the program: attention is a softmax of
products, the deformable sampling is `F.grid_sample` per level. Every product
goes through `linear`, `matmul` or the convolutions below, which honour the
precision set by `precision(...)`: "f32" (the reference), "tf32" (TF32
products, the control for a float32 program) or "fp8" (each product's
operands and result rounded to float8 e4m3 with a per-tensor scale, where a
bfloat16 program holds them in bfloat16: the control for a bfloat16 program).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_MODE = {"precision": "f32"}
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


@contextlib.contextmanager
def precision(mode: str):
    """Every product inside runs in `mode`: "f32", "tf32" or "fp8"."""
    if mode not in ("f32", "tf32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    old = (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _MODE["precision"] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_MODE["precision"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _q(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale in "fp8" mode; x otherwise."""
    if _MODE["precision"] != "fp8":
        return x
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def linear(x, w, b=None):
    return _q(F.linear(_q(x), _q(w), b))


def matmul(a, b):
    return _q(torch.matmul(_q(a), _q(b)))


class Linear(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return _q(self._conv_forward(_q(x), _q(self.weight), self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return _q(F.conv_transpose2d(_q(x), _q(self.weight), self.bias, self.stride,
                                     self.padding))


def attend(q, k, v, scale: float, budget: int = 0):
    """softmax(q k^T scale) v over (N, H, L, D). With `budget` > 0 (bytes),
    N is taken in pieces whose scores fit the budget, each recomputed in the
    backward, so that no (L, L) score matrix of the whole batch is kept."""
    def core(q, k, v):
        s = matmul(q * scale, k.transpose(-1, -2))
        return matmul(s.softmax(dim=-1), v)

    chunk = max(1, budget // (q.shape[1] * q.shape[2] * k.shape[2] * 4)) if budget > 0 else 0
    if chunk <= 0 or q.shape[0] <= chunk:
        return core(q, k, v)
    outs = []
    for i in range(0, q.shape[0], chunk):
        args = (q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
        outs.append(checkpoint(core, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else core(*args))
    return torch.cat(outs)


def drop_rows(x, mask, keep):
    """Stochastic depth: x * mask / keep, mask one value a leading row."""
    return x if mask is None else x * mask / max(keep, 1e-8)


# --------------------------------------------------------------------------- ViT


class ViTAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim)

    def forward(self, x, budget):
        B, N, C = x.shape
        H = self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = linear(x, self.qkv.weight, bias).reshape(B, N, 3, H, C // H).permute(2, 0, 3, 1, 4)
        out = attend(qkv[0], qkv[1], qkv[2], (C // H) ** -0.5, budget)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x, masks, keep, budget):
        """x (B * 16, hw, C): the tokens of each image's 16 windows in turn."""
        Bw, hw, C = x.shape
        h = self.norm1(x)
        if not self.window:
            h = h.reshape(Bw // 16, 16 * hw, C)
        h = self.attn(h, budget).reshape(Bw, hw, C) * self.gamma_1
        x = x + drop_rows(h, masks[0], keep)
        return x + drop_rows(self.mlp(self.norm2(x)) * self.gamma_2, masks[1], keep)


class PatchEmbed(nn.Module):
    def __init__(self, dim, patch=16):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)


class ViT(nn.Module):
    def __init__(self, dim, depth, window_blocks, taps, heads=12, pretrain_grid=14):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, dim))
        self.patch_embed = PatchEmbed(dim)
        self.taps = sorted(i % depth for i in taps)
        self.blocks = nn.ModuleList(Block(dim, heads, i in window_blocks) for i in range(depth))

    def forward(self, images, drop=None, budget=0):
        """images (B, 3, H, W) -> [(B, C, H / 16, W / 16)] at the taps. `drop`:
        (keep rates, a list of two (B * 16, 1, 1) masks a block) or None."""
        x = self.patch_embed.proj(images)
        B, C, H, W = x.shape
        g = int(math.isqrt(self.pos_embed.shape[1] - 1))
        pos = self.pos_embed[:, 1:].reshape(1, g, g, C).permute(0, 3, 1, 2)
        x = x + F.interpolate(pos, size=(H, W), mode="bicubic", align_corners=False)
        h, w = H // 4, W // 4
        # 4 x 4 windows, window-major: (B * 16, h * w, C)
        x = x.reshape(B, C, 4, h, 4, w).permute(0, 2, 4, 3, 5, 1).reshape(B * 16, h * w, C)
        outs = []
        for i, blk in enumerate(self.blocks):
            masks, keep = ((None, None), 1.0) if drop is None else (drop[1][i], drop[0][i])
            x = blk(x, masks, keep, budget)
            if i in self.taps:
                outs.append(x.reshape(B, 4, 4, h, w, C).permute(0, 5, 1, 3, 2, 4)
                            .reshape(B, C, H, W))
        return outs


# --------------------------------------------------------------------------- projector


class BatchNorm(nn.BatchNorm2d):
    """Batch statistics in training (the running variance kept biased, as the
    JAX release does), running statistics in eval."""

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class ConvX(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, act="relu"):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)
        self.bn = BatchNorm(cout, eps=1e-5, momentum=0.1)
        self.act = F.silu if act == "silu" else F.relu

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.cv1 = ConvX(c, c, 3, act="silu")
        self.cv2 = ConvX(c, c, 3, act="silu")

    def forward(self, x):
        return self.cv2(self.cv1(x))


class C2f(nn.Module):
    def __init__(self, cin, cout, n=3):
        super().__init__()
        self.c = cout // 2
        self.cv1 = ConvX(cin, 2 * self.c, 1, act="silu")
        self.cv2 = ConvX((2 + n) * self.c, cout, 1, act="silu")
        self.m = nn.ModuleList(Bottleneck(self.c) for _ in range(n))

    def forward(self, x):
        parts = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class ChannelNorm(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.permute(0, 2, 3, 1), (x.shape[1],), self.weight, self.bias,
                            self.eps).permute(0, 3, 1, 2)


class GELU(nn.Module):
    def forward(self, x):
        return F.gelu(x)


SCALES = {"P3": 2.0, "P4": 1.0, "P5": 0.5}


def sampling(scale, c):
    if scale == 2.0:
        if c > 512:
            return [ConvX(c, c // 2, 1), ConvTranspose2d(c // 2, c // 4, 2, stride=2)], c // 4
        return [ConvTranspose2d(c, c // 2, 2, stride=2)], c // 2
    if scale == 1.0:
        return [], c
    if scale == 0.5:
        return [ConvX(c, c, 3, stride=2)], c
    raise NotImplementedError(scale)


class Projector(nn.Module):
    def __init__(self, cin, ntaps, cout, levels):
        super().__init__()
        self.stages_sampling = nn.ModuleList()
        self.stages = nn.ModuleList()
        for lvl in levels:
            taps = [sampling(SCALES[lvl], cin) for _ in range(ntaps)]
            self.stages_sampling.append(nn.ModuleList(nn.Sequential(*m) for m, _ in taps))
            self.stages.append(nn.Sequential(C2f(sum(c for _, c in taps), cout), ChannelNorm(cout)))

    def forward(self, feats):
        return [stage(torch.cat([m(f) for m, f in zip(samp, feats)], dim=1))
                for samp, stage in zip(self.stages_sampling, self.stages)]


# --------------------------------------------------------------------------- decoder


class MLP(nn.Module):
    def __init__(self, din, hidden, dout, n):
        super().__init__()
        dims = [din] + [hidden] * (n - 1) + [dout]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class SelfAttention(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, qk, v):
        B, N, C = qk.shape
        H, D = self.heads, C // self.heads
        w, b = self.in_proj_weight, self.in_proj_bias
        q = linear(qk, w[:C], b[:C]).reshape(B, N, H, D).transpose(1, 2)
        k = linear(qk, w[C:2 * C], b[C:2 * C]).reshape(B, N, H, D).transpose(1, 2)
        vv = linear(v, w[2 * C:], b[2 * C:]).reshape(B, N, H, D).transpose(1, 2)
        out = attend(q, k, vv, D ** -0.5)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class DeformAttn(nn.Module):
    def __init__(self, d, levels, heads, points):
        super().__init__()
        self.L, self.H, self.P = levels, heads, points
        self.sampling_offsets = Linear(d, heads * levels * points * 2)
        self.attention_weights = Linear(d, heads * levels * points)
        self.value_proj = Linear(d, d)
        self.output_proj = Linear(d, d)

    def forward(self, query, ref, memory, shapes):
        """query (B, Q, C); ref (B, Q, 4) cxcywh; memory (B, S, C) -> (B, Q, C)."""
        B, Q, C = query.shape
        H, L, P = self.H, self.L, self.P
        D = C // H
        off = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2)
        w = self.attention_weights(query).reshape(B, Q, H, L * P).softmax(-1)
        w = w.reshape(B, Q, H, L, P)
        loc = ref[:, :, None, None, None, :2] + off / P * ref[:, :, None, None, None, 2:] * 0.5
        value = self.value_proj(memory).reshape(B, -1, H, D)
        grids = 2 * loc - 1
        out = 0
        start = 0
        for lvl, (h, wd) in enumerate(shapes):
            v = value[:, start:start + h * wd].permute(0, 2, 3, 1).reshape(B * H, D, h, wd)
            start += h * wd
            g = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
            s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
            wl = w[:, :, :, lvl].transpose(1, 2).reshape(B * H, 1, Q, P)
            out = out + (s * wl).sum(-1)  # (B * H, D, Q)
        out = out.reshape(B, H * D, Q).transpose(1, 2)
        return self.output_proj(out)


class DecoderLayer(nn.Module):
    def __init__(self, d, sa_heads, ca_heads, ffn, levels, points):
        super().__init__()
        self.self_attn = SelfAttention(d, sa_heads)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn = DeformAttn(d, levels, ca_heads, points)
        self.norm2 = nn.LayerNorm(d)
        self.linear1 = Linear(d, ffn)
        self.linear2 = Linear(ffn, d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, tgt, pos, ref, memory, shapes, groups):
        B, Q, C = tgt.shape
        qk = (tgt + pos).reshape(B * groups, Q // groups, C)  # groups never attend across
        tgt = self.norm1(tgt + self.self_attn(qk, tgt.reshape(B * groups, Q // groups, C))
                         .reshape(B, Q, C))
        tgt = self.norm2(tgt + self.cross_attn(tgt + pos, ref, memory, shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


class Decoder(nn.Module):
    def __init__(self, d, sa_heads, ca_heads, ffn, layers, levels, points):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d, sa_heads, ca_heads, ffn, levels, points)
                                    for _ in range(layers))
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.norm = nn.LayerNorm(d)


def sine_embed(boxes, dim):
    """(B, Q, 4) cxcywh -> (B, Q, 4 dim): [y, x, w, h], sin / cos interleaved."""
    i = torch.arange(dim, dtype=torch.float32, device=boxes.device)
    dim_t = 10000.0 ** (2 * torch.div(i, 2, rounding_mode="floor") / dim)

    def emb(c):
        p = c[..., None] * (2 * math.pi) / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()], dim=-1).flatten(-2)

    return torch.cat([emb(boxes[..., 1]), emb(boxes[..., 0]), emb(boxes[..., 2]),
                      emb(boxes[..., 3])], dim=-1)


def reparam(base, delta):
    return torch.cat([delta[..., :2] * base[..., 2:] + base[..., :2],
                      delta[..., 2:].exp() * base[..., 2:]], dim=-1)


class Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, g = cfg["hidden_dim"], cfg["group_detr"]
        self.decoder = Decoder(d, cfg["sa_nheads"], cfg["ca_nheads"], cfg["dim_feedforward"],
                               cfg["dec_layers"], len(cfg["projector_scale"]),
                               cfg["dec_n_points"])
        self.enc_output = nn.ModuleList(Linear(d, d) for _ in range(g))
        self.enc_output_norm = nn.ModuleList(nn.LayerNorm(d) for _ in range(g))
        self.enc_out_class_embed = nn.ModuleList(Linear(d, cfg["num_classes"]) for _ in range(g))
        self.enc_out_bbox_embed = nn.ModuleList(MLP(d, d, 4, 3) for _ in range(g))


class LWDETR(nn.Module):
    """The detector. `forward(images NHWC, train)`: in eval query group 0, in
    training all groups; `drop` as `ViT.forward` takes it."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.cfg = cfg
        dim = {"vit_tiny": 192, "vit_small": 384, "vit_base": 768}[cfg["encoder"]]
        enc = ViT(dim, cfg["vit_encoder_num_layers"], set(cfg["window_block_indexes"]),
                  cfg["out_feature_indexes"])
        proj = Projector(dim, len(cfg["out_feature_indexes"]), cfg["hidden_dim"],
                         cfg["projector_scale"])
        self.backbone = nn.ModuleList([nn.Module()])
        self.backbone[0].encoder, self.backbone[0].projector = enc, proj
        self.transformer = Transformer(cfg)
        d, nq = cfg["hidden_dim"], cfg["num_queries"] * cfg["group_detr"]
        self.class_embed = Linear(d, cfg["num_classes"])
        self.bbox_embed = MLP(d, d, 4, 3)
        self.refpoint_embed = nn.Embedding(nq, 4)
        self.query_feat = nn.Embedding(nq, d)

    def proposals(self, memory, shapes, groups, picks=None):
        """Each group's best proposals (boxes, class logits), and group 0's
        proposal scores (B, S) and picks (B, Q). `picks` (eval: one group)
        takes the given positions in place of the top-k."""
        B = memory.shape[0]
        props = []
        for lvl, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=memory.device),
                                    torch.arange(w, dtype=torch.float32, device=memory.device),
                                    indexing="ij")
            xy = (torch.stack([gx, gy], -1) + 0.5) / torch.tensor([w, h], device=memory.device)
            wh = torch.full_like(xy, 0.05 * 2.0 ** lvl)
            props.append(torch.cat([xy, wh], -1).reshape(1, -1, 4).expand(B, -1, -1))
        props = torch.cat(props, 1)
        bad = ~((props > 0.01) & (props < 0.99)).all(-1, keepdim=True)
        memory = memory.masked_fill(bad, 0.0)
        props = props.masked_fill(bad, 0.0)
        t = self.transformer
        nq = self.cfg["num_queries"]
        mems, boxes, logits, first = [], [], [], None
        for g in range(groups):
            m = t.enc_output_norm[g](t.enc_output[g](memory))
            cls = t.enc_out_class_embed[g](m)
            box = reparam(props, t.enc_out_bbox_embed[g](m))
            scores = cls.max(-1).values
            idx = picks if picks is not None and g == 0 else scores.topk(nq, dim=1).indices
            first = first or (scores, idx)
            mems.append(torch.gather(m, 1, idx[..., None].expand(-1, -1, m.shape[-1])))
            boxes.append(torch.gather(box, 1, idx[..., None].expand(-1, -1, 4)))
            logits.append(t.enc_out_class_embed[g](mems[-1]))
        return torch.cat(boxes, 1), torch.cat(logits, 1), first

    def forward(self, images, train: bool = False, drop=None, budget: int = 0, picks=None):
        cfg = self.cfg
        groups = cfg["group_detr"] if train else 1
        nq = cfg["num_queries"] * groups
        feats = self.backbone[0].encoder(images.permute(0, 3, 1, 2), drop, budget)
        srcs = self.backbone[0].projector(feats)
        shapes = [(s.shape[2], s.shape[3]) for s in srcs]
        B = images.shape[0]
        memory = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        boxes_enc, logits_enc, (scores, picked) = self.proposals(memory, shapes, groups, picks)
        ref = reparam(boxes_enc.detach(), self.refpoint_embed.weight[:nq][None].expand(B, -1, -1))
        dec = self.transformer.decoder
        pos = dec.ref_point_head(sine_embed(ref, cfg["hidden_dim"] // 2))
        out = self.query_feat.weight[:nq][None].expand(B, -1, -1)
        hs = []
        for layer in dec.layers:
            out = layer(out, pos, ref, memory, shapes, groups)
            hs.append(dec.norm(out))
        result = []
        for h in hs:
            result.append({"pred_logits": self.class_embed(h),
                           "pred_boxes": reparam(ref, self.bbox_embed(h))})
        return {**result[-1], "aux_outputs": result[:-1],
                "enc_outputs": {"pred_logits": logits_enc, "pred_boxes": boxes_enc},
                "proposal_scores": scores, "picks": picked}


def query_boxes(boxes, sizes):
    """Each query's box (B, Q, 4) cxcywh normalised, as xyxy in pixels of
    `sizes` (B, 2) as (h, w)."""
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scale = torch.stack([sizes[:, 1], sizes[:, 0], sizes[:, 1], sizes[:, 0]], -1)
    return xyxy * scale[:, None]


def post_process(logits, boxes, sizes, k, index: bool = False):
    """Top-k over (query, class): (scores, labels, boxes xyxy in pixels of
    `sizes` (B, 2) as (h, w)); with `index`, also each detection's query x
    classes + class."""
    B, Q, K = logits.shape
    top, idx = logits.reshape(B, Q * K).topk(k, dim=1)
    picked = torch.gather(query_boxes(boxes, sizes), 1, (idx // K)[..., None].expand(-1, -1, 4))
    out = (top.sigmoid(), idx % K, picked)
    return out + (idx,) if index else out


def build(cfg: Dict, state_dict: Optional[Dict[str, torch.Tensor]] = None, device="cpu",
          train: bool = False) -> LWDETR:
    """The reference on `device` in float32, loaded from `state_dict` if given."""
    with torch.device("meta"):
        model = LWDETR(cfg)
    model.to_empty(device=device)
    if state_dict is not None:
        model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                               if v.is_floating_point() else v.to(device)
                               for k, v in state_dict.items()}, strict=True)
    return model.train(train)


def state_shapes(cfg: Dict) -> List[Sequence]:
    """[(name, shape, dtype)] of every parameter and buffer, in state-dict order."""
    with torch.device("meta"):
        model = LWDETR(cfg)
    return [(k, tuple(v.shape), v.dtype) for k, v in model.state_dict().items()]
