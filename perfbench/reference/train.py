"""The release recipe's train step in plain PyTorch: the benchmark's reference.

Written from the published recipe (LW-DETR, arXiv 2406.03459; the authors'
`scripts/lwdetr_{size}_coco_train.sh` and their criterion): Hungarian
matching of every query group, on its own, for the last decoder layer, each
auxiliary layer and the two-stage encoder outputs (focal class cost + L1 +
GIoU, solved by `scipy.optimize.linear_sum_assignment` on the host); the
IA-BCE classification loss, L1 and GIoU, normalised by the number of boxes
times the groups; backward; the global gradient norm clipped; AdamW with the
recipe's learning rates (the ViT's layer decay, the component decay) and
weight decays; the EMA of the whole state dict.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from perfbench.reference.model import LWDETR

GAMMA = 2.0


def cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def giou_pairwise(a, b):
    """GIoU of xyxy boxes a (N, 4) against b (M, 4) -> (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    lt_c = torch.min(a[:, None, :2], b[None, :, :2])
    rb_c = torch.max(a[:, None, 2:], b[None, :, 2:])
    area_c = (rb_c - lt_c).clamp(min=0).prod(-1)
    return inter / union - (area_c - union) / area_c


def iou_aligned(a, b):
    lt = torch.max(a[:, :2], b[:, :2])
    rb = torch.min(a[:, 2:], b[:, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a + area_b - inter)


@torch.no_grad()
def match(logits, boxes, targets, groups, tcfg):
    """[(query indices, target indices)] an image, over all groups (the
    queries of group g are g Q .. (g + 1) Q - 1)."""
    B, NQ, _ = logits.shape
    Q = NQ // groups
    alpha = tcfg["focal_alpha"]
    out = []
    for i in range(B):
        labels, tboxes = targets[i]["labels"], targets[i]["boxes"]
        if len(labels) == 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.int64)))
            continue
        prob = logits[i].float().sigmoid()[:, labels]  # (NQ, T)
        neg = (1 - alpha) * prob ** GAMMA * -(1 - prob + 1e-8).log()
        pos = alpha * (1 - prob) ** GAMMA * -(prob + 1e-8).log()
        c_bbox = torch.cdist(boxes[i].float(), tboxes.float(), p=1)
        c_giou = -giou_pairwise(cxcywh_to_xyxy(boxes[i].float()), cxcywh_to_xyxy(tboxes.float()))
        cost = (tcfg["set_cost_bbox"] * c_bbox + tcfg["set_cost_class"] * (pos - neg)
                + tcfg["set_cost_giou"] * c_giou).cpu().double().numpy()
        qs, ts = [], []
        for g in range(groups):
            r, c = linear_sum_assignment(cost[g * Q:(g + 1) * Q])
            qs.append(r + g * Q)
            ts.append(c)
        out.append((np.concatenate(qs), np.concatenate(ts)))
    return out


def set_losses(out, targets, matched, num_boxes, alpha):
    """(IA-BCE, L1, GIoU) of one output set."""
    logits, boxes = out["pred_logits"].float(), out["pred_boxes"].float()
    dev = logits.device
    bi = torch.cat([torch.full((len(q),), i, dtype=torch.long) for i, (q, _) in
                    enumerate(matched)]).to(dev)
    qi = torch.cat([torch.as_tensor(q, dtype=torch.long) for q, _ in matched]).to(dev)
    tl = torch.cat([targets[i]["labels"][torch.as_tensor(t, dtype=torch.long, device=dev)]
                    for i, (_, t) in enumerate(matched)])
    tb = torch.cat([targets[i]["boxes"][torch.as_tensor(t, dtype=torch.long, device=dev)]
                    for i, (_, t) in enumerate(matched)]).float()
    src = boxes[bi, qi]
    prob = logits.sigmoid()
    ious = iou_aligned(cxcywh_to_xyxy(src.detach()), cxcywh_to_xyxy(tb))
    ious = torch.nan_to_num(ious, nan=0.0).clamp(0, 1)
    pos_w = torch.zeros_like(logits)
    neg_w = prob ** GAMMA
    t = (prob[bi, qi, tl].pow(alpha) * ious.pow(1 - alpha)).clamp(min=0.01).detach()
    pos_w = pos_w.index_put((bi, qi, tl), t)
    neg_w = neg_w.index_put((bi, qi, tl), 1 - t)
    loss_ce = (-pos_w * F.logsigmoid(logits) - neg_w * F.logsigmoid(-logits)).sum() / num_boxes
    loss_bbox = (src - tb).abs().sum() / num_boxes
    giou = torch.diagonal(giou_pairwise(cxcywh_to_xyxy(src), cxcywh_to_xyxy(tb)))
    loss_giou = (1 - torch.nan_to_num(giou, nan=0.0)).sum() / num_boxes
    return loss_ce, loss_bbox, loss_giou


def criterion(outputs, targets, groups, tcfg):
    """The weighted sum over the last, auxiliary and encoder output sets."""
    n = sum(len(t["labels"]) for t in targets)
    num_boxes = max(float(n * groups), 1.0)
    sets = [outputs] + list(outputs["aux_outputs"]) + [outputs["enc_outputs"]]
    total = 0.0
    for s in sets:
        matched = match(s["pred_logits"].detach(), s["pred_boxes"].detach(), targets, groups, tcfg)
        ce, l1, gi = set_losses(s, targets, matched, num_boxes, tcfg["focal_alpha"])
        total = total + tcfg["cls_loss_coef"] * ce + tcfg["bbox_loss_coef"] * l1 \
            + tcfg["giou_loss_coef"] * gi
    return total


def lr_wd(name: str, mcfg, tcfg):
    """The recipe's (lr, weight decay) of a parameter."""
    if name.startswith("backbone.0.encoder."):
        depth = mcfg["vit_encoder_num_layers"]
        if "pos_embed" in name or "patch_embed" in name:
            layer = 0
        elif ".blocks." in name:
            layer = int(name.split(".blocks.")[1].split(".")[0]) + 1
        else:
            layer = depth + 1
        lr = (tcfg["lr_encoder"] * tcfg["lr_vit_layer_decay"] ** (depth + 1 - layer)
              * tcfg["lr_component_decay"] ** 2)
        leaf = name.rsplit(".", 1)[-1]
        no_wd = ("gamma" in name or "pos_embed" in name or "bias" in leaf
                 or "norm" in name.lower())
        return lr, 0.0 if no_wd else tcfg["weight_decay"]
    if name.startswith("transformer.decoder."):
        return tcfg["lr"] * tcfg["lr_component_decay"], tcfg["weight_decay"]
    return tcfg["lr"], tcfg["weight_decay"]


class Trainer:
    """The model, AdamW's moments and the EMA; `step(images, targets,
    drop)` runs one step of the recipe and returns the loss."""

    def __init__(self, model: LWDETR, mcfg, tcfg):
        self.model, self.mcfg, self.tcfg = model, mcfg, tcfg
        self.params = [(n, p) for n, p in model.named_parameters()]
        self.hyper = {n: lr_wd(n, mcfg, tcfg) for n, _ in self.params}
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.t = 0
        # in float64, so that its rounding is nought beside the program's
        self.ema = {k: v.detach().double() if v.is_floating_point() else v.detach().clone()
                    for k, v in model.state_dict().items()}
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None

    def step(self, images, targets: List[Dict], drop=None, budget: int = 0) -> float:
        model, tcfg = self.model, self.tcfg
        model.train()
        for _, p in self.params:
            p.grad = None
        out = model(images, train=True, drop=drop, budget=budget)
        loss = criterion(out, targets, self.mcfg["group_detr"], tcfg)
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.params}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        coef = min(1.0, tcfg["clip_max_norm"] / (float(norm) + 1e-6))
        grads = {n: g * coef for n, g in grads.items()}
        if self.first_grads is None:
            self.first_grads = {n: g.detach().clone() for n, g in grads.items()}
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        with torch.no_grad():
            for n, p in self.params:
                lr, wd = self.hyper[n]
                g = grads[n]
                p.mul_(1 - lr * wd)
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[n] / (1 - b1 ** self.t)
                v_hat = self.v[n] / (1 - b2 ** self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
            d = tcfg["ema_decay"]
            for k, v in model.state_dict().items():
                if v.is_floating_point():
                    self.ema[k].mul_(d).add_(v.double(), alpha=1 - d)
                else:
                    self.ema[k].copy_(v)
        return float(loss.detach())


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              ref_grads: Dict[str, torch.Tensor], floor: float = 1e-3, worst: bool = True):
    """The worst leaf's | |program| - |reference| | over max(|reference|, the
    median leaf's |reference|), over the leaves whose reference gradient
    norm is at least `floor` times the median leaf's (a leaf whose gradient
    is nought to rounding moves under Adam by round-off alone). Returns
    (worst gap, its leaf, the number of leaves compared, the leaves left out);
    with `worst` False, the median leaf's gap in place of the worst."""
    gnorm = {k: float(ref_grads[k].double().norm()) for k in reference}
    med_g = float(np.median(list(gnorm.values())))
    keep = [k for k in reference if gnorm[k] >= floor * med_g]
    rn = {k: float(reference[k].double().norm()) for k in keep}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    gaps = {}
    for k in keep:
        pn = float(program[k].double().norm())
        gap = abs(pn - rn[k]) / max(rn[k], med, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    left_out = sorted(set(reference) - set(keep))
    if not gaps:
        return math.inf, None, 0, left_out
    if not worst:
        return float(np.median(list(gaps.values()))), None, len(keep), left_out
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, len(keep), left_out


def above_resolution(change: Dict[str, torch.Tensor], value: Dict[str, torch.Tensor],
                     ulps: float = 8.0) -> List[str]:
    """The leaves whose change is at least `ulps` float32 ulps of their
    values, in norm: the others (an EMA over three steps of a leaf near 1)
    move by rounding alone in a float32 program."""
    keep = []
    for k, d in change.items():
        v = value[k].float().abs()
        ulp = torch.nextafter(v, torch.full_like(v, math.inf)) - v
        if float(d.double().norm()) >= ulps * float(ulp.double().norm()):
            keep.append(k)
    return keep
