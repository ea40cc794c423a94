"""Set-prediction criterion: Hungarian-matched detection losses.

Counterpart of `lwdetr_tpu/models/criterion.py`. Targets are padded to a
fixed `max_gt` per image, and every classification loss is

    a "negative" base term summed over all logits
    + corrections gathered at the matched (image, query, class) positions,

so no dense target tensor is scattered. All four classification variants
reduce to sum(weighted BCE) / num_boxes:

* IA-BCE (the release recipes)
* plain sigmoid focal
* varifocal
* position-supervised

All in f32. `num_boxes` is the batch's count of valid boxes (times the number
of query groups unless `sum_group_losses`); with more than one process, the
global batch's count over the number of processes.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models.matcher import hungarian_match
from lwdetr_tpu_torch.ops import box_ops
from lwdetr_tpu_torch.parallel.dist import all_reduce_sum, world_size


class Targets(NamedTuple):
    """Padded detection targets."""

    labels: torch.Tensor  # (B, T) int; arbitrary where invalid
    boxes: torch.Tensor  # (B, T, 4) f32 normalized cxcywh; a dummy box where invalid
    valid: torch.Tensor  # (B, T) bool


def _gather_matched(x: torch.Tensor, matched_q: torch.Tensor) -> torch.Tensor:
    """x (B, Q, ...) gathered at matched_q (B, G, T) -> (B, G, T, ...)."""
    B, G, T = matched_q.shape
    idx = matched_q.reshape(B, G * T, *(1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return torch.gather(x, 1, idx).reshape(B, G, T, *x.shape[2:])


def _matched_logits(pred_logits: torch.Tensor, matched_q: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """The logit at (matched query, target class): (B, G, T)."""
    B, Q, K = pred_logits.shape
    _, G, T = matched_q.shape
    flat_idx = matched_q * K + labels.long()[:, None, :]
    return torch.gather(pred_logits.reshape(B, Q * K), 1,
                        flat_idx.reshape(B, G * T)).reshape(B, G, T)


def classification_loss(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                        matched_q: torch.Tensor, targets: Targets, num_boxes: torch.Tensor,
                        variant: str, focal_alpha: float = 0.25) -> torch.Tensor:
    """pred_logits (B, Q, K), pred_boxes (B, Q, 4), matched_q (B, G, T) -> scalar."""
    gamma = 2.0
    alpha = focal_alpha
    logits = pred_logits.float()
    log_1p = F.logsigmoid(-logits)  # log(1 - p), stable
    prob = logits.sigmoid()
    valid = targets.valid[:, None, :].float()  # (B, 1 -> G, T)

    # IoU(detached predicted box, target box) at the matched positions
    src_boxes = _gather_matched(pred_boxes.float(), matched_q).detach()  # (B, G, T, 4)
    iou = box_ops.elementwise_box_iou(box_ops.box_cxcywh_to_xyxy(src_boxes),
                                      box_ops.box_cxcywh_to_xyxy(targets.boxes[:, None].float()))
    iou = torch.nan_to_num(iou, nan=0.0).clamp(0.0, 1.0)  # (B, G, T)

    lm = _matched_logits(logits, matched_q, targets.labels)  # (B, G, T)
    pm = lm.sigmoid()
    log_pm = F.logsigmoid(lm)
    log_1pm = F.logsigmoid(-lm)

    if variant == "ia_bce":
        # base: every logit treated as a negative with weight prob ** gamma
        base = ((prob ** gamma) * (-log_1p)).sum()
        t = (pm.pow(alpha) * iou.pow(1 - alpha)).clamp(min=0.01).detach()
        pos_term = -t * log_pm - (1 - t) * log_1pm
        base_at_m = (pm ** gamma) * (-log_1pm)
        corr = (valid * (pos_term - base_at_m)).sum()
        return (base + corr) / num_boxes

    base = ((1 - alpha) * (prob ** gamma) * (-log_1p)).sum()
    base_at_m = (1 - alpha) * (pm ** gamma) * (-log_1pm)
    if variant == "focal":
        pos_at_m = alpha * ((1 - pm) ** gamma) * (-log_pm)
        corr = (valid * (pos_at_m - base_at_m)).sum()
        return (base + corr) / num_boxes

    if variant == "varifocal":
        t = iou
        # focal weight t for t > 0; bce = -t log p - (1 - t) log(1 - p)
        pos_at_m = t * (-t * log_pm - (1 - t) * log_1pm)
    elif variant == "position_supervised":
        t_raw = iou * valid  # (B, G, T)
        t_max = t_raw.reshape(t_raw.shape[0], -1).max(dim=-1).values  # (B,)
        t = t_raw / (t_max[:, None, None] + 1e-8)
        pos_at_m = alpha * ((t - pm).abs() ** gamma) * (-t * log_pm - (1 - t) * log_1pm)
    else:
        raise ValueError(f"unknown classification variant {variant}")
    corr = (valid * torch.where(t > 0, pos_at_m - base_at_m, torch.zeros_like(t))).sum()
    return (base + corr) / num_boxes


def box_losses(pred_boxes: torch.Tensor, matched_q: torch.Tensor, targets: Targets,
               num_boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """L1 and GIoU losses over the matched pairs."""
    src = _gather_matched(pred_boxes.float(), matched_q)  # (B, G, T, 4)
    tgt = targets.boxes[:, None].float()  # (B, 1, T, 4)
    valid = targets.valid[:, None, :].to(src.dtype)
    loss_bbox = ((src - tgt).abs().sum(-1) * valid).sum() / num_boxes
    giou = box_ops.elementwise_generalized_box_iou(box_ops.box_cxcywh_to_xyxy(src),
                                                   box_ops.box_cxcywh_to_xyxy(tgt))
    giou = torch.nan_to_num(giou, nan=0.0)
    loss_giou = ((1.0 - giou) * valid).sum() / num_boxes
    return loss_bbox, loss_giou


@torch.no_grad()
def diagnostics(pred_logits: torch.Tensor, matched_q: torch.Tensor, targets: Targets):
    """class_error (top-1 on the matched queries) and cardinality error."""
    K = pred_logits.shape[-1]
    pred_cls = _gather_matched(pred_logits, matched_q).argmax(dim=-1)  # (B, G, T)
    correct = (pred_cls == targets.labels.long()[:, None, :]).float()
    valid = targets.valid[:, None, :].float().expand_as(correct)
    acc = (correct * valid).sum() / valid.sum().clamp(min=1.0)
    class_error = 100.0 * (1.0 - acc)
    card_pred = (pred_logits.argmax(dim=-1) != K - 1).float().sum(dim=1)
    n_gt = targets.valid.float().sum(dim=1)
    return class_error, (card_pred - n_gt).abs().mean()


class SetCriterion:
    """Callable criterion: a function of (outputs, targets), without parameters."""

    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig):
        self.mcfg = model_cfg
        self.tcfg = train_cfg
        if train_cfg.ia_bce_loss:
            self.variant = "ia_bce"
        elif train_cfg.use_position_supervised_loss:
            self.variant = "position_supervised"
        elif train_cfg.use_varifocal_loss:
            self.variant = "varifocal"
        else:
            self.variant = "focal"

    def weight_dict(self) -> Dict[str, float]:
        t, m = self.tcfg, self.mcfg
        wd = {"loss_ce": t.cls_loss_coef, "loss_bbox": t.bbox_loss_coef,
              "loss_giou": t.giou_loss_coef}
        if m.aux_loss:
            aux = {}
            for i in range(m.dec_layers - 1):
                aux.update({f"{k}_{i}": v for k, v in wd.items()})
            if m.two_stage:
                aux.update({f"{k}_enc": v for k, v in wd.items()})
            wd.update(aux)
        return wd

    def match(self, logits: torch.Tensor, boxes: torch.Tensor, targets: Targets,
              group_detr: int) -> torch.Tensor:
        """(..., B, Q, K), (..., B, Q, 4) -> matched_q (..., B, G, T)."""
        t = self.tcfg
        return hungarian_match(logits, boxes, targets.labels, targets.boxes, targets.valid,
                               group_detr=group_detr, cost_class=t.set_cost_class,
                               cost_bbox=t.set_cost_bbox, cost_giou=t.set_cost_giou,
                               focal_alpha=t.focal_alpha)

    def loss_set(self, out, targets: Targets, num_boxes, matched: torch.Tensor,
                 suffix: str = "", with_diag: bool = False) -> Dict[str, torch.Tensor]:
        losses = {"loss_ce" + suffix: classification_loss(
            out["pred_logits"], out["pred_boxes"], matched, targets, num_boxes, self.variant,
            self.tcfg.focal_alpha)}
        losses["loss_bbox" + suffix], losses["loss_giou" + suffix] = box_losses(
            out["pred_boxes"], matched, targets, num_boxes)
        if with_diag:
            losses["class_error"], losses["cardinality_error"] = diagnostics(
                out["pred_logits"], matched, targets)
        return losses

    def __call__(self, outputs: Dict, targets: Targets, train: bool = True,
                 matched: Optional[torch.Tensor] = None):
        """Returns (total weighted loss, dict of unweighted components).
        `matched` (S, B, G, T), if given, replaces the matching of the S
        output sets (last, auxiliary in order, encoder)."""
        group_detr = self.mcfg.group_detr if train else 1
        n_valid = targets.valid.float().sum()
        num_boxes = n_valid if self.tcfg.sum_group_losses else n_valid * group_detr
        # the global count (the JAX package's), over the world size: DDP
        # averages the processes' gradients, so each divides its share of the
        # global sums by count / world (the reference's lwdetr.py:416-423), and
        # the mean of their losses is the global loss
        num_boxes = all_reduce_sum(num_boxes).clamp(min=1.0) / world_size()

        sets = [(outputs, "", True)]
        sets += [(aux, f"_{i}", False) for i, aux in enumerate(outputs.get("aux_outputs", []))]
        if "enc_outputs" in outputs:
            sets.append((outputs["enc_outputs"], "_enc", False))
        if matched is None:
            # one matching launch (M1) for every output set, with no wait on the device
            matched = self.match(torch.stack([s[0]["pred_logits"].detach() for s in sets]),
                                 torch.stack([s[0]["pred_boxes"].detach() for s in sets]),
                                 targets, group_detr)
        losses = {}
        for i, (out, suffix, diag) in enumerate(sets):
            losses.update(self.loss_set(out, targets, num_boxes, matched[i], suffix, diag))
        wd = self.weight_dict()
        total = sum(losses[k] * w for k, w in wd.items() if k in losses)
        return total, losses
