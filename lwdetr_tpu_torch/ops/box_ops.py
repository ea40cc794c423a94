"""Box utilities on the trailing dim of 4 (counterpart of lwdetr_tpu/ops/box_ops.py)."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes; trailing dim 4 -> scalar."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes: (..., N, 4), (..., M, 4) -> iou, union (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: (..., N, 4), (..., M, 4) -> (..., N, M)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def elementwise_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between aligned boxes (..., 4) vs (..., 4) -> (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (box_area(boxes1) + box_area(boxes2) - inter)


def elementwise_generalized_box_iou(boxes1: torch.Tensor,
                                    boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU between aligned boxes (..., 4) vs (..., 4) -> (...)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    lt_c = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb_c = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh_c = (rb_c - lt_c).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return inter / union - (area_c - union) / area_c
