"""Box-aware image transforms (numpy/PIL, host-side).

The port's own copy of `lwdetr_tpu/data/transforms.py`, the functional
re-design of the reference's `datasets/transforms.py` without torchvision:
the same numpy `Generator` draws and PIL calls, so the same seed gives the
same arrays.  Targets are dicts of numpy arrays with keys
``boxes`` (N, 4) xyxy absolute, ``labels`` (N,), ``area`` (N,),
``iscrowd`` (N,), ``orig_size`` (2,) [h, w], ``size`` (2,) [h, w].

Randomness is explicit: every random op takes a ``numpy.random.Generator``,
so the pipeline is reproducible and shardable across hosts.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

Target = Dict[str, np.ndarray]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _filter(target: Target, keep: np.ndarray) -> Target:
    out = dict(target)
    for f in ("boxes", "labels", "area", "iscrowd"):
        if f in out:
            out[f] = out[f][keep]
    return out


def crop(image: Image.Image, target: Target, region: Tuple[int, int, int, int]):
    """region = (top, left, height, width) — reference transforms.py:34-74."""
    i, j, h, w = region
    image = image.crop((j, i, j + w, i + h))
    target = dict(target)
    target["size"] = np.array([h, w])
    if "boxes" in target:
        boxes = target["boxes"] - np.array([j, i, j, i], np.float32)
        boxes = np.minimum(
            boxes.reshape(-1, 2, 2), np.array([w, h], np.float32))
        boxes = np.clip(boxes, 0, None)
        target["area"] = (boxes[:, 1] - boxes[:, 0]).prod(axis=1)
        target["boxes"] = boxes.reshape(-1, 4)
        keep = np.all(boxes[:, 1] > boxes[:, 0], axis=1)
        target = _filter(target, keep)
    return image, target


def hflip(image: Image.Image, target: Target):
    w = image.width
    image = image.transpose(Image.FLIP_LEFT_RIGHT)
    target = dict(target)
    if "boxes" in target:
        b = target["boxes"][:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1], np.float32)
        target["boxes"] = b + np.array([w, 0, w, 0], np.float32)
    return image, target


def _size_with_aspect_ratio(image_size, size, max_size=None):
    w, h = image_size
    if max_size is not None:
        min_o, max_o = float(min(w, h)), float(max(w, h))
        if max_o / min_o * size > max_size:
            size = int(round(max_size * min_o / max_o))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def _rescale_target(target: Target, old_wh, new_wh) -> Target:
    rw = new_wh[0] / old_wh[0]
    rh = new_wh[1] / old_wh[1]
    target = dict(target)
    if "boxes" in target:
        target["boxes"] = target["boxes"] * np.array([rw, rh, rw, rh], np.float32)
    if "area" in target:
        target["area"] = target["area"] * (rw * rh)
    target["size"] = np.array([new_wh[1], new_wh[0]])
    return target


def resize(image: Image.Image, target: Optional[Target], size,
           max_size: Optional[int] = None):
    """size: scalar shorter-side (aspect preserved, capped at max_size) or
    (h, w) tuple — reference transforms.py:95-150."""
    if isinstance(size, (list, tuple)):
        oh, ow = size
    else:
        oh, ow = _size_with_aspect_ratio(image.size, size, max_size)
    old_wh = image.size
    image = image.resize((ow, oh), Image.BILINEAR)
    if target is None:
        return image, None
    return image, _rescale_target(target, old_wh, (ow, oh))


def square_resize(image: Image.Image, target: Optional[Target], size: int):
    """Resize to exactly (size, size) — reference transforms.py:222-252."""
    return resize(image, target, (size, size))


def normalize(image: Image.Image, target: Optional[Target],
              mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """to float [0,1], imagenet-normalize; boxes -> normalized cxcywh
    (reference transforms.py:437-453). Returns (np float32 HWC, target)."""
    arr = np.asarray(image.convert("RGB"), np.float32) / 255.0
    arr = (arr - mean) / std
    if target is None:
        return arr, None
    target = dict(target)
    h, w = arr.shape[:2]
    if "boxes" in target and len(target["boxes"]):
        b = target["boxes"]
        cxcywh = np.stack([
            (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
            b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=-1)
        target["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
    elif "boxes" in target:
        target["boxes"] = target["boxes"].reshape(0, 4)
    return arr, target


# ---- random recipe steps ----

def random_horizontal_flip(rng: np.random.Generator, image, target, p=0.5):
    if rng.random() < p:
        return hflip(image, target)
    return image, target


def random_resize(rng: np.random.Generator, image, target,
                  sizes: Sequence[int], max_size: Optional[int] = None):
    size = int(sizes[rng.integers(len(sizes))])
    return resize(image, target, size, max_size)


def random_square_resize(rng: np.random.Generator, image, target,
                         sizes: Sequence[int], fixed_size: Optional[int] = None):
    size = int(fixed_size if fixed_size is not None else sizes[rng.integers(len(sizes))])
    return square_resize(image, target, size)


def random_size_crop(rng: np.random.Generator, image, target,
                     min_size: int, max_size: int):
    w = int(rng.integers(min_size, min(image.width, max_size) + 1))
    h = int(rng.integers(min_size, min(image.height, max_size) + 1))
    # torchvision RandomCrop.get_params
    if image.width == w and image.height == h:
        region = (0, 0, h, w)
    else:
        i = int(rng.integers(0, max(image.height - h, 0) + 1))
        j = int(rng.integers(0, max(image.width - w, 0) + 1))
        region = (i, j, h, w)
    return crop(image, target, region)


# ---- recipes (reference datasets/coco.py:86-160) ----

SCALES_DEFAULT = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
SCALES_SQUARE = (448, 512, 576, 640, 704, 768, 832, 896)


def train_transform_square_div_64(
    rng: np.random.Generator, image, target,
    batch_size_hint: Optional[int] = None,
):
    """Release train recipe (make_coco_transforms_square_div_64, coco.py:123-147).

    `batch_size_hint` pins the final square size (the loader picks one
    size per batch to keep shapes static; the reference randomizes per image
    and pads — see data/loader.py for the divergence note).
    """
    image, target = random_horizontal_flip(rng, image, target)
    if rng.random() < 0.5:
        image, target = random_square_resize(
            rng, image, target, SCALES_SQUARE, fixed_size=batch_size_hint)
    else:
        image, target = random_resize(rng, image, target, (400, 500, 600))
        image, target = random_size_crop(rng, image, target, 384, 600)
        image, target = random_square_resize(
            rng, image, target, SCALES_SQUARE, fixed_size=batch_size_hint)
    return normalize(image, target)


def train_transform_default(rng: np.random.Generator, image, target):
    """Legacy multi-scale recipe (make_coco_transforms, coco.py:86-107)."""
    image, target = random_horizontal_flip(rng, image, target)
    if rng.random() < 0.5:
        image, target = random_resize(rng, image, target, SCALES_DEFAULT, 1333)
    else:
        image, target = random_resize(rng, image, target, (400, 500, 600))
        image, target = random_size_crop(rng, image, target, 384, 600)
        image, target = random_resize(rng, image, target, SCALES_DEFAULT, 1333)
    return normalize(image, target)


def val_transform_square(image, target, size: int = 640):
    image, target = square_resize(image, target, size)
    return normalize(image, target)


def val_transform_default(image, target, size: int = 640, max_size: int = 1333):
    image, target = resize(image, target, size, max_size)
    return normalize(image, target)
