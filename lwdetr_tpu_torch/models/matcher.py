"""Hungarian matching of predictions to targets.

Counterpart of `lwdetr_tpu/models/matcher.py`: the same function, a
minimum-cost assignment of each image's valid targets to distinct queries of
each query group, on the same cost (focal class cost + L1 + GIoU). The cost
matrices of every (output set, image, group) are built on the device in one
tensor. The assignment itself is solved on the host with
`scipy.optimize.linear_sum_assignment` over the valid target rows only: the
JAX package's solver is a `lax.while_loop` formulation made for a TPU, not a
function to copy. Per step the host waits once for the device (the validity
mask and the valid cost rows come over in two copies) and sends one index
tensor back. Everything here runs under `torch.no_grad()`.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from lwdetr_tpu_torch.ops import box_ops


def match_cost_matrix(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                      tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor,
                      tgt_valid: torch.Tensor, cost_class: float = 2.0, cost_bbox: float = 5.0,
                      cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """pred_logits (..., B, Q, K), pred_boxes (..., B, Q, 4) cxcywh; tgt_labels
    (B, T) int, tgt_boxes (B, T, 4) cxcywh (a valid dummy box where padded),
    tgt_valid (B, T) bool -> cost (..., B, T, Q) f32; padded rows are 0."""
    gamma = 2.0
    prob = pred_logits.float().sigmoid()  # (..., B, Q, K)
    idx = tgt_labels.long()[:, None, :].expand(*prob.shape[:-1], tgt_labels.shape[1])
    p_t = torch.gather(prob, -1, idx)  # (..., B, Q, T)
    neg = (1 - focal_alpha) * (p_t ** gamma) * (-torch.log(1 - p_t + 1e-8))
    pos = focal_alpha * ((1 - p_t) ** gamma) * (-torch.log(p_t + 1e-8))
    pred_boxes = pred_boxes.float()
    tgt_boxes = tgt_boxes.float()
    c_bbox = (pred_boxes[..., :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou(box_ops.box_cxcywh_to_xyxy(pred_boxes),
                                       box_ops.box_cxcywh_to_xyxy(tgt_boxes))
    cost = cost_bbox * c_bbox + cost_class * (pos - neg) - cost_giou * giou
    cost = cost.masked_fill(~tgt_valid[:, None, :], 0.0)
    return cost.transpose(-1, -2)


@torch.no_grad()
def hungarian_match(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                    tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                    group_detr: int = 1, cost_class: float = 2.0, cost_bbox: float = 5.0,
                    cost_giou: float = 2.0, focal_alpha: float = 0.25) -> torch.Tensor:
    """Optimal assignment per (image, group), for any leading dims (e.g. a
    stack of output sets): pred_logits (..., B, G * Qg, K), pred_boxes
    (..., B, G * Qg, 4) -> matched_q (..., B, G, T) int64 on the inputs'
    device: the query index, global into G * Qg, assigned to each target slot.
    Meaningful only where tgt_valid; padded slots hold 0."""
    lead = pred_logits.shape[:-3]
    B, Qt, _ = pred_logits.shape[-3:]
    T = tgt_labels.shape[1]
    G = group_detr
    Qg = Qt // G
    cost = match_cost_matrix(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                             cost_class, cost_bbox, cost_giou, focal_alpha)
    cost = cost.reshape(-1, B, T, Qt)  # (S, B, T, Qt)
    S = cost.shape[0]
    # the host needs only the valid rows: which they are, then those rows
    valid = tgt_valid.cpu().numpy()
    b_idx, t_idx = np.nonzero(valid)
    rows = cost[:, torch.from_numpy(b_idx).to(cost.device),
                torch.from_numpy(t_idx).to(cost.device)].cpu().numpy()  # (S, n_valid, Qt)
    matched = np.zeros((S, B, G, T), np.int64)
    start = 0
    for b in range(B):
        slots = t_idx[start:start + int(valid[b].sum())]
        if not len(slots):
            continue
        block = rows[:, start:start + len(slots)]
        start += len(slots)
        for s in range(S):
            for g in range(G):
                r, c = linear_sum_assignment(block[s, :, g * Qg:(g + 1) * Qg])
                matched[s, b, g, slots[r]] = c + g * Qg
    return torch.from_numpy(matched).reshape(*lead, B, G, T).to(pred_logits.device)
