"""COCO-format detection dataset (pure json + PIL; no torchvision/pycocotools).

The port's own copy of `lwdetr_tpu/data/coco.py`: the reference's
CocoDetection + ConvertCoco target preparation (its `datasets/coco.py:27-83`):
xywh->xyxy, clamp to image, drop crowd and degenerate boxes, keep
area/iscrowd/orig_size. Also the minimal COCO-index API that the evaluator
(`data/coco_eval.py`) consumes.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image


class CocoIndex:
    """Minimal pycocotools.COCO equivalent over an annotation json."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            d = json.load(f)
        self.dataset = d
        self.imgs = {img["id"]: img for img in d.get("images", [])}
        self.cats = {c["id"]: c for c in d.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in d.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])


def convert_coco_target(anno: List[dict], w: int, h: int, image_id: int) -> dict:
    """ConvertCoco (reference datasets/coco.py:43-83)."""
    anno = [o for o in anno if o.get("iscrowd", 0) == 0]
    boxes = np.asarray([o["bbox"] for o in anno], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    classes = np.asarray([o["category_id"] for o in anno], np.int64)
    area = np.asarray([o["area"] for o in anno], np.float32)
    iscrowd = np.asarray([o.get("iscrowd", 0) for o in anno], np.int64)

    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    return {
        "boxes": boxes[keep],
        "labels": classes[keep],
        "area": area[keep],
        "iscrowd": iscrowd[keep],
        "image_id": np.asarray([image_id]),
        "orig_size": np.asarray([h, w]),
        "size": np.asarray([h, w]),
    }


class CocoDetection:
    """Detection dataset over (image dir, annotation json)."""

    def __init__(self, img_folder: str, ann_file: str, transform=None):
        self.img_folder = img_folder
        self.coco = CocoIndex(ann_file)
        self.ids = self.coco.get_img_ids()
        self.transform = transform

    def __len__(self):
        return len(self.ids)

    def load_raw(self, idx: int):
        """(PIL image, prepared target) before augmentation."""
        img_id = self.ids[idx]
        info = self.coco.imgs[img_id]
        path = os.path.join(self.img_folder, info["file_name"])
        image = Image.open(path).convert("RGB")
        target = convert_coco_target(
            self.coco.load_anns(img_id), image.width, image.height, img_id)
        return image, target

    def __getitem__(self, idx: int):
        image, target = self.load_raw(idx)
        if self.transform is not None:
            image, target = self.transform(image, target)
        return image, target


def build_dataset(image_set: str, data_cfg, transform=None) -> CocoDetection:
    """Dataset registry (reference datasets/__init__.py:28-33 + o365.py).

    o365 uses the same COCO-format json layout with different file names
    (reference datasets/o365.py:18-50).
    """
    root = data_cfg.coco_path
    if data_cfg.dataset_file == "coco":
        paths = {
            "train": ("train2017", "annotations/instances_train2017.json"),
            "val": ("val2017", "annotations/instances_val2017.json"),
        }
    elif data_cfg.dataset_file == "o365":
        paths = {
            "train": ("train", "objects365_train.json"),
            "val": ("val", "objects365_minival5k.json"),
        }
    else:
        raise ValueError(data_cfg.dataset_file)
    sub, ann = paths[image_set.split("_")[0]]
    return CocoDetection(os.path.join(root, sub), os.path.join(root, ann), transform)
