"""DETR decoder with two-stage proposal selection and deformable cross-attention.

Counterpart of `lwdetr_tpu/models/transformer.py`, in each of its variants:
two-stage or one-stage query init, reparameterized boxes or box logits, the
lite or the iterative reference-point refinement (`Transformer`). In eval one
query group runs; in train mode (`module.training`) all `group_detr` groups
run, each with its own two-stage heads, folded into the batch for
self-attention so that groups do not attend across. Self-attention runs channel-major through
`ops/flash_attention.attention_cm` (K2, backward K6; K9 and the no-bias case
of K7 for the 100 queries of the tiny preset). Cross-attention samples
the memory through `ops/deform_attn`: in eval channel-major values and
`ms_deform_attn_cm` (K3) for a short memory (the P4 presets), per-level
head-major value panels and `ms_deform_attn_sep_panels` (K4) from
`SEP_MIN_LEN_IN` positions up (the P3+P5 presets); in train mode the panels
at every memory length (K4, backward K5). `MSDeformAttnModule.force_branch`
takes one of the three value layouts whatever the mode: "cm" (K3, backward
K8), "sep" (K4 / K5) or "gather" (row-major values, K10). In train mode a
dropout rate above 0 drops at the JAX layer's sites (`models/drop.py`): the
self-attention's weights, which takes the self-attention off the kernels onto
the plain einsum form, as the JAX module does, and the outputs of the
self-attention, the cross-attention and both FFN products; a rate of exactly
0 (the release recipes) draws nothing and keeps K2 / K9. A padded batch
brings per-level masks (True on padding): each level's valid ratios scale the
reference points, the proposals are placed on each image's valid extent and
masked, and every cross-attention zeroes the values at padded positions
before its sampler, in each of the three layouts, where the JAX module does;
without masks none of this runs. Module and parameter names follow the
reference's state_dict (`transformer.decoder.layers.{i}...`,
`transformer.enc_output.{g}`, ...).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.cast import LayerNorm, Linear, cast_params, weight_and_bias
from lwdetr_tpu_torch.models.vit import DenseCM, dense_to_cm
from lwdetr_tpu_torch.ops import deform_attn as da
from lwdetr_tpu_torch.ops import flash_attention as fa
from lwdetr_tpu_torch.ops.embeddings import query_sine_embed
from lwdetr_tpu_torch.utils import trace


# In eval, memories at least this long are sampled from head-major panels (K4),
# shorter ones from channel-major values (K3); in train mode every memory is
# sampled from panels (K4 / K5): the JAX package's dispatch, `train or Len_in
# >= 4096`. Its further gate on the panels fitting VMEM is a TPU resource
# check with no counterpart on this card. The device plays no part: on the
# CPU each branch runs with its sampler's plain version.
SEP_MIN_LEN_IN = 4096
BRANCHES = ("sep", "cm", "gather")


class MLPHead(nn.Module):
    """num_layers-deep ReLU MLP."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiheadSelfAttention(nn.Module):
    """Multi-head attention with a fused in-projection, channel-major inside."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = DenseCM(d_model, d_model)

    def forward(self, qk: torch.Tensor, v: torch.Tensor, dropout_rate=0.0,
                mask_source: Optional[drop.MaskSource] = None) -> torch.Tensor:
        """qk (B, N, C) feeds queries and keys, v (B, N, C) values -> (B, N, C).
        With a mask source and a rate above 0 the attention weights are
        dropped, on the einsum form of `lwdetr_tpu/models/transformer.py:
        118-136` (the kernels never see the weights)."""
        B, N, C = qk.shape
        H = self.num_heads
        w, b = cast_params(self, "in_proj", qk.dtype, (self.in_proj_weight, self.in_proj_bias))
        if mask_source is not None and float(dropout_rate) != 0.0:
            D = C // H
            qp = F.linear(qk, w[:C], b[:C]).reshape(B, N, H, D)
            kp = F.linear(qk, w[C:2 * C], b[C:2 * C]).reshape(B, N, H, D)
            vp = F.linear(v, w[2 * C:], b[2 * C:]).reshape(B, N, H, D)
            attn = torch.einsum("bnhd,bmhd->bhnm", qp * D ** -0.5, kp).softmax(dim=-1)
            attn = drop.dropout(attn, dropout_rate, mask_source)
            out = torch.einsum("bhnm,bmhd->bnhd", attn, vp).reshape(B, N, C)
            return F.linear(out, *weight_and_bias(self.out_proj, out.dtype))
        qkv_t = torch.cat([dense_to_cm(qk, w[:2 * C], b[:2 * C]),
                           dense_to_cm(v, w[2 * C:], b[2 * C:])], dim=1)  # (B, 3C, N)
        out_t = fa.attention_cm(qkv_t, H, scale=(C // H) ** -0.5)
        return self.out_proj(out_t)


class MSDeformAttnModule(nn.Module):
    """Projections around the deformable sampler. One set of parameters, three
    value layouts. By default (`force_branch` None): channel-major
    (B, C, Len_in) in eval below `SEP_MIN_LEN_IN` positions ("cm"), per-level
    head-major panels (B, H, H_l, W_l * D) from there up and always in train
    mode ("sep"). `force_branch` (the JAX module's field of the same name)
    takes "cm", "sep" or "gather" (row-major (B, Len_in, H, D), the reference
    CUDA op's layout) whatever the mode and the memory's length."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int, n_points: int,
                 force_branch: Optional[str] = None):
        super().__init__()
        if force_branch is not None and force_branch not in BRANCHES:
            raise ValueError(f"force_branch must be None or one of {BRANCHES}, got {force_branch!r}")
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.force_branch = force_branch
        self.sampling_offsets = Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = DenseCM(d_model, d_model)

    def value_panels(self, memory_levels: Sequence[torch.Tensor],
                     spatial_shapes: Sequence[Tuple[int, int]],
                     padding_mask: Optional[torch.Tensor] = None):
        """One value projection per level with the shared weights, laid out
        head-major: (B, H_l * W_l, C) -> (B, H, H_l * W_l, D), whose regroup to
        (B, H, H_l, W_l * D) is a view. The GEMM writes (B, N, H, D); the move
        to head-major is one copy of the values per level. With a
        `padding_mask` (B, Len_in) the level's padded positions are zeroed
        first (`lwdetr_tpu/models/transformer.py:293-296`). The copy is the
        span "value_panels"."""
        H = self.n_heads
        panels = []
        start = 0
        for (hl, wl), mem_l in zip(spatial_shapes, memory_levels):
            B, n, C = mem_l.shape
            v = self.value_proj(mem_l).reshape(B, n, H, C // H)
            if padding_mask is not None:
                v = v.masked_fill(padding_mask[:, start:start + n, None, None], 0.0)
            start += n
            v = v.permute(0, 2, 1, 3)
            v = trace.call("value_panels", v.contiguous)
            panels.append(v.reshape(B, H, hl, wl * (C // H)))
        return panels

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                memory: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                memory_levels: Sequence[torch.Tensor],
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, L, 2|4) in [0, 1];
        memory (B, Len_in, C); spatial_shapes [(H, W)] * L; memory_levels:
        the per-level (B, H_l * W_l, C) maps `memory` was concatenated from;
        padding_mask (B, Len_in) True on padding, or None -> (B, Q, C). The
        values at padded positions are zeroed before the sampler in every
        layout (`lwdetr_tpu/models/transformer.py:271-272, :293-296,
        :302-303`), so its backward sees the same zeros."""
        B, Q, C = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Q, H, L, P, 2)
        weights = self.attention_weights(query).reshape(B, Q, H, L * P)
        weights = weights.softmax(dim=-1).reshape(B, Q, H, L, P)
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes],
                                      dtype=offsets.dtype, device=offsets.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / normalizer[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")
        branch = self.force_branch
        if branch is None:
            branch = "sep" if self.training or memory.shape[1] >= SEP_MIN_LEN_IN else "cm"
        if branch == "cm":
            value_t = dense_to_cm(memory, *weight_and_bias(self.value_proj, memory.dtype))
            if padding_mask is not None:
                value_t = value_t.masked_fill(padding_mask[:, None, :], 0.0)
            out_t = da.ms_deform_attn_cm(value_t, spatial_shapes, loc, weights, H)  # (B, C, Q)
            return self.output_proj(out_t)
        if branch == "sep":
            panels = self.value_panels(memory_levels, spatial_shapes, padding_mask)
            out = da.ms_deform_attn_sep_panels(panels, spatial_shapes, loc, weights)  # (B, Q, C)
        else:
            value = self.value_proj(memory)
            if padding_mask is not None:
                value = value.masked_fill(padding_mask[..., None], 0.0)
            value = value.reshape(B, -1, H, C // H)
            out = da.ms_deform_attn(value, spatial_shapes, loc, weights)  # (B, Q, C)
        return F.linear(out, *weight_and_bias(self.output_proj, out.dtype))


class DecoderLayer(nn.Module):
    """Self-attention -> deformable cross-attention -> FFN, post-norm."""

    def __init__(self, d_model: int, sa_nheads: int, ca_nheads: int, dim_feedforward: int,
                 n_levels: int, n_points: int, group_detr: int = 1):
        super().__init__()
        self.group_detr = group_detr
        self.self_attn = MultiheadSelfAttention(d_model, sa_nheads)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttnModule(d_model, n_levels, ca_nheads, n_points)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, query_pos, reference_points, spatial_shapes, memory_levels,
                padding_mask=None, dropout_rate=0.0,
                mask_source: Optional[drop.MaskSource] = None):
        B, Q, C = tgt.shape
        qk, v = tgt + query_pos, tgt
        if self.training and self.group_detr > 1:
            # fold the groups into the batch, so that they do not attend across:
            # batch-major (B * g, Q / g, C), a pure reshape, as the queries are
            # already ordered groups-within-image
            qk = qk.reshape(B * self.group_detr, Q // self.group_detr, C)
            v = v.reshape(B * self.group_detr, Q // self.group_detr, C)
        # each module in its stage's span; what runs between them in none
        norms, ffn = "decoder norms", "decoder FFN"
        tgt2 = trace.call("decoder self-attention", self.self_attn, qk, v, dropout_rate,
                          mask_source).reshape(B, Q, C)
        tgt = trace.call(norms, self.norm1, tgt + drop.dropout(tgt2, dropout_rate, mask_source))
        tgt2 = trace.call("decoder cross-attention", self.cross_attn, tgt + query_pos,
                          reference_points, memory, spatial_shapes, memory_levels, padding_mask)
        tgt = trace.call(norms, self.norm2, tgt + drop.dropout(tgt2, dropout_rate, mask_source))
        h = drop.dropout(F.relu(trace.call(ffn, self.linear1, tgt)), dropout_rate, mask_source)
        h = drop.dropout(trace.call(ffn, self.linear2, h), dropout_rate, mask_source)
        return trace.call(norms, self.norm3, tgt + h)


def set_force_branch(model: nn.Module, branch: Optional[str]) -> nn.Module:
    """Set `force_branch` on every `MSDeformAttnModule` of `model` (None: the
    default rule). The parameters are the same in every branch."""
    if branch is not None and branch not in BRANCHES:
        raise ValueError(f"force_branch must be None or one of {BRANCHES}, got {branch!r}")
    for module in model.modules():
        if isinstance(module, MSDeformAttnModule):
            module.force_branch = branch
    return model


def box_reparam_combine(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """cxcy = d_xy * base_wh + base_xy, wh = exp(d_wh) * base_wh."""
    cxcy = delta[..., :2] * base[..., 2:] + base[..., :2]
    wh = torch.exp(delta[..., 2:]) * base[..., 2:]
    return torch.cat([cxcy, wh], dim=-1)


def select_proposals(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, k) of the k best proposal scores (B, S), best first."""
    return torch.topk(scores, k, dim=1).indices


def valid_extent(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) True on padding -> (B, 2) f32 [valid_w, valid_h]: the unpadded
    columns of the first row and rows of the first column, counted on the
    device (`lwdetr_tpu/models/transformer.py:445-446`, `:683-684`)."""
    return torch.stack([(~mask[:, 0, :]).sum(dim=1), (~mask[:, :, 0]).sum(dim=1)],
                       dim=-1).float()


def valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) True on padding -> (B, 2) [w_ratio, h_ratio] (the JAX
    `Transformer._valid_ratio`); exactly 1 on an unpadded map."""
    H, W = mask.shape[1], mask.shape[2]
    extent = valid_extent(mask)
    return torch.stack([extent[:, 0] / W, extent[:, 1] / H], dim=-1)


def gen_encoder_output_proposals(memory: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                                 padding_mask: Optional[torch.Tensor] = None,
                                 unsigmoid: bool = False):
    """Anchor-grid proposals per memory position (`lwdetr_tpu/models/
    transformer.py:431-479`): cxcywh in [0, 1] for the reparameterized boxes,
    or, with `unsigmoid` (no reparameterization), their logits
    log(p / (1 - p)).

    memory (B, S, C); spatial_shapes [(H, W)] * L; padding_mask (B, S) True on
    padding, or None ->
    (output_memory (B, S, C), output_proposals (B, S, 4) f32). A level's grid
    is placed on each image's valid extent ((x + 0.5) / valid_w, ...);
    positions whose proposal leaves (0.01, 0.99), and padded positions, are
    zeroed in the memory and filled in the proposals: with 0, or with +inf
    in logit space."""
    B, dev = memory.shape[0], memory.device
    proposals = []
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        if padding_mask is not None:
            extent = valid_extent(padding_mask[:, start:start + H * W].reshape(B, H, W))
        else:
            extent = torch.stack([torch.full((B,), float(W), device=dev),
                                  torch.full((B,), float(H), device=dev)], dim=-1)
        gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        grid = (torch.stack([gx, gy], dim=-1)[None] + 0.5) / extent[:, None, None, :]
        wh = torch.full_like(grid, 0.05 * (2.0 ** lvl))
        proposals.append(torch.cat([grid, wh], dim=-1).reshape(B, -1, 4))
        start += H * W
    output_proposals = torch.cat(proposals, dim=1)
    invalid = ~((output_proposals > 0.01) & (output_proposals < 0.99)).all(dim=-1, keepdim=True)
    if padding_mask is not None:
        invalid = invalid | padding_mask[..., None]
    fill = 0.0
    if unsigmoid:
        output_proposals = torch.log(output_proposals / (1 - output_proposals))
        fill = float("inf")
    return memory.masked_fill(invalid, 0.0), output_proposals.masked_fill(invalid, fill)


class Decoder(nn.Module):
    """Holds the decoder layers, the query-position head and the final norm
    (the reference's `transformer.decoder` namespace)."""

    def __init__(self, d_model: int, sa_nheads: int, ca_nheads: int, dim_feedforward: int,
                 dec_layers: int, n_levels: int, n_points: int, decoder_norm: str,
                 group_detr: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, sa_nheads, ca_nheads, dim_feedforward, n_levels, n_points,
                         group_detr)
            for _ in range(dec_layers))
        self.ref_point_head = MLPHead(2 * d_model, d_model, d_model, 2)
        self.norm = LayerNorm(d_model, eps=1e-5) if decoder_norm == "LN" else nn.Identity()


class Transformer(nn.Module):
    """Decoder-only transformer (query group 0 in eval, every group in train
    mode), in every variant of the JAX module (`lwdetr_tpu/models/
    transformer.py:482-676`):

    * `two_stage`: the queries' reference boxes start from each group's
      best-scoring proposals (one set of heads a group), combined with
      `refpoint_embed`; one-stage: from `refpoint_embed` itself;
    * `bbox_reparam`: boxes are reparameterized (`box_reparam_combine`, cxcywh
      in [0, 1]); without it they are logits, combined by addition and read
      through a sigmoid, the proposals inverse-sigmoided (+inf where invalid);
    * `lite_refpoint_refine`: the query positions are computed once, from the
      initial boxes; without it (the iterative refinement) each layer takes
      its query positions from the current boxes, and the shared box head
      (`LWDETR.bbox_embed`, passed at call time and not registered here)
      refines them on the layer's un-normed output, detached before the next
      layer."""

    def __init__(self, d_model: int, sa_nheads: int, ca_nheads: int, num_queries: int,
                 dec_layers: int, dim_feedforward: int, group_detr: int,
                 num_feature_levels: int, dec_n_points: int, decoder_norm: str = "LN",
                 num_classes: int = 91, two_stage: bool = True, bbox_reparam: bool = True,
                 lite_refpoint_refine: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_queries = num_queries
        self.group_detr = group_detr
        self.num_feature_levels = num_feature_levels
        self.two_stage, self.bbox_reparam = two_stage, bbox_reparam
        self.lite_refpoint_refine = lite_refpoint_refine
        self.decoder = Decoder(d_model, sa_nheads, ca_nheads, dim_feedforward, dec_layers,
                               num_feature_levels, dec_n_points, decoder_norm, group_detr)
        if two_stage:
            # one set of two-stage heads per query group, as in the reference's
            # checkpoint; eval uses group 0, training all of them
            self.enc_output = nn.ModuleList(Linear(d_model, d_model) for _ in range(group_detr))
            self.enc_output_norm = nn.ModuleList(
                LayerNorm(d_model, eps=1e-5) for _ in range(group_detr))
            self.enc_out_class_embed = nn.ModuleList(
                Linear(d_model, num_classes) for _ in range(group_detr))
            self.enc_out_bbox_embed = nn.ModuleList(
                MLPHead(d_model, d_model, 4, 3) for _ in range(group_detr))

    def proposals(self, memory, spatial_shapes, mask_flat, groups: int):
        """Each group's picked proposals, groups concatenated: (memory_ts
        (B, nq, C), boxes_ts (B, nq, 4) f32, undetached; logits without
        reparameterization)."""
        output_memory, output_proposals = gen_encoder_output_proposals(
            memory, spatial_shapes, mask_flat, unsigmoid=not self.bbox_reparam)
        mem_ts, box_ts = [], []
        for g in range(groups):
            with trace.span("proposals"):
                mem_g = self.enc_output_norm[g](self.enc_output[g](output_memory))
                cls_g = self.enc_out_class_embed[g](mem_g)  # (B, S, K)
                delta_g = self.enc_out_bbox_embed[g](mem_g)
            delta_g = delta_g.float()
            coords_g = (box_reparam_combine(output_proposals, delta_g) if self.bbox_reparam
                        else delta_g + output_proposals)
            topk_idx = select_proposals(cls_g.max(dim=-1).values, self.num_queries)  # (B, Qg)
            box_ts.append(torch.gather(coords_g, 1, topk_idx[..., None].expand(-1, -1, 4)))
            mem_ts.append(torch.gather(mem_g, 1,
                                       topk_idx[..., None].expand(-1, -1, mem_g.shape[-1])))
        return torch.cat(mem_ts, dim=1), torch.cat(box_ts, dim=1)

    def reference(self, refpoints, valid_ratios, dtype):
        """The JAX `_get_reference`: (refpoints_input (B, Q, L, 4) in `dtype`,
        query_pos (B, Q, C)) from the current boxes (through a sigmoid without
        reparameterization), scaled per level by the valid ratios."""
        base = refpoints if self.bbox_reparam else refpoints.sigmoid()
        if valid_ratios is None:
            refpoints_input = base[:, :, None].expand(-1, -1, self.num_feature_levels, -1)
        else:
            refpoints_input = base[:, :, None] * valid_ratios.repeat(1, 1, 2)[:, None]
        qse = query_sine_embed(refpoints_input[:, :, 0], dim=self.d_model // 2).to(dtype)
        return (refpoints_input.to(dtype),
                trace.call("decoder norms", self.decoder.ref_point_head, qse))

    def forward(self, srcs, masks: Optional[Sequence[torch.Tensor]], refpoint_embed: torch.Tensor,
                query_feat: torch.Tensor, dropout_rate=0.0,
                mask_source: Optional[drop.MaskSource] = None,
                bbox_embed: Optional[nn.Module] = None):
        """srcs: list[(B, H, W, C)] projector outputs; masks: list[(B, H, W)]
        bool, True on padding, or None; refpoint_embed (nq, 4); query_feat
        (nq, C) in the compute dtype, nq = num_queries x groups; the reference
        points stay in float32, as in the JAX package; `bbox_embed`: the shared
        box head of the iterative refinement (without `lite_refpoint_refine`).
        Returns hs (L, B, nq, C), references ((1 | L), B, nq, 4: the initial
        boxes, or [initial, refined_0 ... refined_{L-2}] with the iterative
        refinement; logits without reparameterization), and, in two-stage,
        memory_ts (B, nq, C) and boxes_ts (B, nq, 4, cxcywh in [0, 1]): each
        group's picked proposals, groups concatenated (None in one-stage).
        `dropout_rate` and `mask_source` go to every decoder layer."""
        spatial_shapes = [(s.shape[1], s.shape[2]) for s in srcs]
        B = srcs[0].shape[0]
        dtype = srcs[0].dtype
        memory_levels = [s.reshape(B, -1, s.shape[-1]) for s in srcs]
        memory = torch.cat(memory_levels, dim=1)
        groups = self.group_detr if self.training else 1
        nq = self.num_queries * groups
        mask_flat = valid_ratios = None
        if masks is not None:
            mask_flat = torch.cat([m.reshape(B, -1) for m in masks], dim=1)
            valid_ratios = torch.stack([valid_ratio(m) for m in masks], dim=1)  # (B, L, 2)

        refpoints = refpoint_embed[None, :nq].float().expand(B, -1, -1)
        memory_ts = boxes_ts = None
        if self.two_stage:
            memory_ts, boxes_ts = self.proposals(memory, spatial_shapes, mask_flat, groups)
            # the decoder's reference points carry no gradient into the proposal
            # boxes; the encoder outputs (memory_ts, boxes_ts) do
            refpoints = (box_reparam_combine(boxes_ts.detach(), refpoints) if self.bbox_reparam
                         else refpoints + boxes_ts.detach())

        lite = self.lite_refpoint_refine
        if not lite and bbox_embed is None:
            raise ValueError("the iterative refinement (lite_refpoint_refine off) needs the "
                             "shared box head, bbox_embed")
        ref_list = [refpoints]
        if lite:
            refpoints_input, query_pos = self.reference(refpoints, valid_ratios, dtype)
        output = query_feat[None, :nq].expand(B, -1, -1)
        intermediates = []
        layers = self.decoder.layers
        for i, layer in enumerate(layers):
            if not lite:
                refpoints_input, query_pos = self.reference(refpoints, valid_ratios, dtype)
            output = layer(output, memory, query_pos, refpoints_input, spatial_shapes,
                           memory_levels, mask_flat, dropout_rate, mask_source)
            if not lite:
                delta = trace.call("heads", bbox_embed, output).float()  # the un-normed output
                new_ref = (box_reparam_combine(refpoints, delta) if self.bbox_reparam
                           else refpoints + delta)
                if i != len(layers) - 1:
                    ref_list.append(new_ref)
                refpoints = new_ref.detach()
            intermediates.append(trace.call("decoder norms", self.decoder.norm, output))
        references = refpoints[None] if lite else torch.stack(ref_list)
        if self.two_stage and not self.bbox_reparam:
            boxes_ts = boxes_ts.sigmoid()
        return torch.stack(intermediates), references, memory_ts, boxes_ts
