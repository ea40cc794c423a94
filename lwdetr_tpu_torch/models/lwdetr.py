"""LW-DETR top-level model: backbone -> projector -> decoder -> heads.

Counterpart of `lwdetr_tpu/models/lwdetr.py`. Inference uses the first query
group; in train mode (`model.training`) every group of `group_detr` runs and
the outputs hold `num_queries x group_detr` queries. Images are square and
unpadded (the release `square_resize_div_64` recipe), so no padding masks are
built. The decoder never reads per-level position embeddings, so none are
computed. In train mode `forward` takes the step's stochastic-depth rates
(one a ViT block) and dropout rate, and a mask source that draws their masks
(`models/drop.py`), as the JAX model's `drop_path_rates` / `dropout_rate`;
`ModelConfig.grad_checkpointing` recomputes each ViT block in the backward.

Parameters and buffers are float32 in every compute dtype, as in the JAX
package; `compute_dtype` (float32 or bfloat16, set by `build_model`) is the
dtype of the activations, and each layer casts its weights to it where it
uses them (`models/cast.py`). The reference points and so `pred_boxes` stay
float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.cast import Linear, cast_params
from lwdetr_tpu_torch.models.projector import LEVEL2SCALE, MultiScaleProjector
from lwdetr_tpu_torch.models.transformer import MLPHead, Transformer, box_reparam_combine
from lwdetr_tpu_torch.models.vit import ViT
from lwdetr_tpu_torch.ops import box_ops


class Backbone(nn.Module):
    """ViT encoder + projector (the reference's `backbone.0`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if "vit" not in cfg.encoder:
            raise NotImplementedError(f"encoder {cfg.encoder}: only the ViT encoders are ported")
        self.encoder = ViT(cfg.embed_dim, cfg.vit_encoder_num_layers, cfg.num_heads,
                           window_block_indexes=cfg.window_block_indexes,
                           out_feature_indexes=cfg.out_feature_indexes,
                           grad_checkpointing=cfg.grad_checkpointing)
        self.projector = MultiScaleProjector(
            [cfg.embed_dim] * len(cfg.out_feature_indexes), cfg.hidden_dim,
            [LEVEL2SCALE[lvl] for lvl in cfg.projector_scale])

    def forward(self, images: torch.Tensor, drop_path_rates=None, mask_source=None):
        return self.projector(self.encoder(images, drop_path_rates, mask_source))


class LWDETR(nn.Module):
    """Group-DETR detector."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        # what every release preset uses; the JAX package's other variants are not ported
        off = [name for name in ("two_stage", "bbox_reparam", "lite_refpoint_refine")
               if not getattr(cfg, name)]
        if cfg.position_embedding != "sine":
            off.append(f"position_embedding={cfg.position_embedding!r}")
        if off:
            raise NotImplementedError(f"not ported: {off} (the port runs two-stage, "
                                      "bbox_reparam, lite-refine configs with the sine embedding)")
        self.cfg = cfg
        self.backbone = nn.ModuleList([Backbone(cfg)])
        self.transformer = Transformer(
            d_model=cfg.hidden_dim, sa_nheads=cfg.sa_nheads, ca_nheads=cfg.ca_nheads,
            num_queries=cfg.num_queries, dec_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward, group_detr=cfg.group_detr,
            num_feature_levels=cfg.num_feature_levels, dec_n_points=cfg.dec_n_points,
            decoder_norm=cfg.decoder_norm, num_classes=cfg.num_classes)
        self.class_embed = Linear(cfg.hidden_dim, cfg.num_classes)
        self.bbox_embed = MLPHead(cfg.hidden_dim, cfg.hidden_dim, 4, 3)
        nq = cfg.num_queries * cfg.group_detr
        self.refpoint_embed = nn.Embedding(nq, 4)
        self.query_feat = nn.Embedding(nq, cfg.hidden_dim)
        self.compute_dtype = torch.float32

    def forward(self, images: torch.Tensor, drop_path_rates: Optional[Sequence[float]] = None,
                dropout_rate: float = 0.0,
                mask_source: Optional[drop.MaskSource] = None) -> dict:
        """images (B, H, W, 3) normalized, cast to `compute_dtype` ->
        dict(pred_logits (B, Q, K) in `compute_dtype`, pred_boxes (B, Q, 4)
        float32 cxcywh in [0, 1], aux_outputs, enc_outputs).
        drop_path_rates (one a ViT block) and dropout_rate take effect in
        train mode with a `mask_source`; in eval nothing is dropped."""
        cfg = self.cfg
        if not self.training:
            mask_source = None
        groups = cfg.group_detr if self.training else 1
        nq = cfg.num_queries * groups
        feats = self.backbone[0](images.to(self.compute_dtype), drop_path_rates, mask_source)
        query_feat = self.query_feat.weight
        (query_feat,) = cast_params(self, ("query_feat", nq), self.compute_dtype, (query_feat,),
                                    lambda: (query_feat[:nq],))
        hs, ref, hs_enc, ref_enc = self.transformer(
            feats, self.refpoint_embed.weight[:nq], query_feat, dropout_rate, mask_source)
        outputs_coord = box_reparam_combine(ref, self.bbox_embed(hs).float())
        outputs_class = self.class_embed(hs)
        out = {"pred_logits": outputs_class[-1], "pred_boxes": outputs_coord[-1]}
        if cfg.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": outputs_class[i], "pred_boxes": outputs_coord[i]}
                for i in range(cfg.dec_layers - 1)]
        # each group's own class head on its slice of the picked proposals
        heads = self.transformer.enc_out_class_embed
        cls_enc = [heads[g](hs_enc[:, g * cfg.num_queries:(g + 1) * cfg.num_queries])
                   for g in range(groups)]
        out["enc_outputs"] = {"pred_logits": torch.cat(cls_enc, dim=1), "pred_boxes": ref_enc}
        return out


def post_process(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                 target_sizes: torch.Tensor, num_select: int = 300):
    """NMS-free top-k decode.

    pred_logits (B, Q, K); pred_boxes (B, Q, 4) cxcywh normalized;
    target_sizes (B, 2) as (h, w). Returns (scores (B, S), labels (B, S),
    boxes (B, S, 4) xyxy absolute). Selection runs on raw logits: the sigmoid
    is monotonic and is applied to the selected k only."""
    B, Q, K = pred_logits.shape
    top_logits, topk_idx = torch.topk(pred_logits.reshape(B, Q * K), num_select, dim=1)
    scores = top_logits.float().sigmoid()
    topk_boxes = topk_idx // K
    labels = topk_idx % K
    boxes = box_ops.box_cxcywh_to_xyxy(pred_boxes.float())
    boxes = torch.gather(boxes, 1, topk_boxes[..., None].expand(-1, -1, 4))
    img_h, img_w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1).to(boxes.dtype)
    return scores, labels, boxes * scale[:, None, :]


def resolve_device(device=None) -> torch.device:
    """The given device, else CUDA; raises rather than fall back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def build_model(cfg: ModelConfig, device=None, dtype: torch.dtype = torch.float32,
                state_dict: Optional[dict] = None, train: bool = False) -> LWDETR:
    """LW-DETR on `device` (CUDA unless given) computing in `dtype`, with
    float32 parameters and buffers (the JAX package's rule); `state_dict`
    (reference keys) is loaded strictly. By default an eval-mode model with
    its parameters frozen; `train=True` gives a train-mode model whose
    parameters require grad, in either compute dtype (bf16 training keeps
    f32 parameters, as the JAX package's `--bf16`)."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    model = LWDETR(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    model.requires_grad_(train)
    model.compute_dtype = dtype
    return model.to(device=device).train(train)
