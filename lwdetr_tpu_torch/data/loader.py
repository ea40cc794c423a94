"""Batched, prefetching data loader with static shapes.

Counterpart of `lwdetr_tpu/data/loader.py`, and the reference's torch
DataLoader + DistributedSampler + NestedTensor collate in the same design:

* targets are padded to a static `max_gt` per image (labels/boxes/valid);
* train batches use ONE square size per batch drawn from the recipe's scale
  set, so every image in the batch shares a shape and no padding mask is
  needed (`per_image_scales` draws a size per image and pads, as the
  reference does);
* per-process sharding: each process iterates its `process_index`-strided
  subset (the DistributedSampler equivalent), and every process as many
  images as the others (train drops the remainder, eval repeats a process's
  own last image, which `evaluate` skips as a duplicate), so that no
  collective of a step waits on a process that has run out;
* a background thread prepares and collates the next batches while the
  device computes; an error there is raised to the caller at that batch.

Batches are dicts of numpy arrays on the host, equal bit for bit to the JAX
loader's for the same dataset and seed. The one exception is
`image_dtype=torch.bfloat16`: numpy has no bfloat16, so `images` is then a
host torch tensor, cast with PyTorch's round to nearest even (the rounding
`ml_dtypes` applies in the JAX loader). `to_device` makes the move to the
card explicit.
"""
from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from PIL import Image

from lwdetr_tpu_torch.data import native
from lwdetr_tpu_torch.data import transforms as T
from lwdetr_tpu_torch.data.coco import convert_coco_target
from lwdetr_tpu_torch.utils import trace


def pad_targets(target: dict, max_gt: int) -> Dict[str, np.ndarray]:
    """Pad one image's prepared+normalized target to static shapes."""
    n = len(target["boxes"])
    n_keep = min(n, max_gt)
    labels = np.zeros((max_gt,), np.int32)
    boxes = np.tile(np.array([0.5, 0.5, 1.0, 1.0], np.float32), (max_gt, 1))
    valid = np.zeros((max_gt,), bool)
    if n_keep:
        labels[:n_keep] = target["labels"][:n_keep]
        boxes[:n_keep] = target["boxes"][:n_keep]
        valid[:n_keep] = True
    return {"labels": labels, "boxes": boxes, "valid": valid}


def collate(samples, max_gt: int) -> Dict[str, np.ndarray]:
    """samples: list of (image HWC float32, target). All images same shape."""
    images = np.stack([s[0] for s in samples])
    padded = [pad_targets(s[1], max_gt) for s in samples]
    out = {
        "images": images,
        "labels": np.stack([p["labels"] for p in padded]),
        "boxes": np.stack([p["boxes"] for p in padded]),
        "valid": np.stack([p["valid"] for p in padded]),
        "image_id": np.array([int(s[1]["image_id"][0]) for s in samples], np.int64),
        "orig_size": np.stack([s[1]["orig_size"] for s in samples]).astype(np.float32),
    }
    if "pad_mask" in samples[0][1]:
        out["pad_mask"] = np.stack([s[1]["pad_mask"] for s in samples])
    return out


@trace.spanned("to_device")
def to_device(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A host batch -> torch tensors on `device`. For a CUDA device each
    array is pinned and copied with `non_blocking=True`, so the copy runs
    on the current stream behind the work already queued; `image_id` stays
    a host array (the evaluator reads it on the host). The span "to_device"."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "image_id":
            out[k] = v
            continue
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DetectionLoader:
    """Iterates fixed-shape batches over a CocoDetection dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        train: bool,
        max_gt: int = 100,
        seed: int = 42,
        square_div_64: bool = True,
        eval_size: int = 640,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        drop_last: Optional[bool] = None,
        use_native: bool = True,
        per_image_scales: bool = False,
        num_workers: int = 1,
        image_dtype: Optional[torch.dtype] = None,
    ):
        if image_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"image_dtype must be None, float32 or bfloat16, got {image_dtype}")
        self.ds = dataset
        self.batch_size = batch_size
        self.train = train
        self.max_gt = max_gt
        self.seed = seed
        self.square_div_64 = square_div_64
        self.eval_size = eval_size
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = max(1, prefetch)
        self.drop_last = train if drop_last is None else drop_last
        self.use_native = use_native
        self.per_image_scales = per_image_scales
        # the reference's DataLoader workers: a thread pool over the per-image
        # decode + transform (PIL and the C preprocessing release the GIL);
        # per-image rngs are spawned in index order, so batches are identical
        # for any worker count
        self.num_workers = max(1, num_workers)
        self.image_dtype = image_dtype
        self._pool = None
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch (DistributedSampler.set_epoch equivalent)."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.ds)
        if self.train:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        idx = order[self.process_index::self.process_count]
        if self.process_count > 1:
            per = n // self.process_count if self.train else -(-n // self.process_count)
            idx = np.concatenate([idx, np.repeat(idx[-1:], max(per - len(idx), 0))])[:per]
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _map_samples(self, fn, args):
        if self.num_workers > 1 and len(args) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return list(self._pool.map(fn, args))
        return [fn(a) for a in args]

    def _make_batch(self, idxs, rng: np.random.Generator):
        if self.train:
            # per-batch size keeps one mask-free shape per step; with
            # per_image_scales each image samples its own size (hint=None,
            # the reference recipe) and the batch pads to its max + pad_mask
            size = None
            if self.square_div_64 and not self.per_image_scales:
                size = int(T.SCALES_SQUARE[rng.integers(len(T.SCALES_SQUARE))])
            # one spawned rng per image, in index order: batches are
            # bit-identical for any num_workers
            child_rngs = rng.spawn(len(idxs))

            def load_train(arg):
                i, crng = arg
                img, tgt = self.ds.load_raw(int(i))
                if self.square_div_64:
                    return T.train_transform_square_div_64(
                        crng, img, tgt, batch_size_hint=size)
                return T.train_transform_default(crng, img, tgt)

            samples = self._map_samples(load_train, list(zip(idxs, child_rngs)))
            if not self.square_div_64 or self.per_image_scales:
                samples = _pad_to_common(samples)
        else:
            def load_eval(i):
                if not self.square_div_64:
                    # legacy recipe evals at shortest-side 800 / max 1333
                    # (reference coco.py default val transform)
                    img, tgt = self.ds.load_raw(int(i))
                    return T.val_transform_default(img, tgt, 800, 1333)
                sample = self._eval_sample_native(int(i)) if self.use_native else None
                if sample is None:
                    img, tgt = self.ds.load_raw(int(i))
                    img, tgt = T.val_transform_square(img, tgt, self.eval_size)
                    sample = (img, tgt)
                return sample

            samples = self._map_samples(load_eval, list(idxs))
            if not self.square_div_64:
                samples = _pad_to_common(samples)
        batch = collate(samples, self.max_gt)
        if self.image_dtype == torch.bfloat16:
            batch["images"] = torch.from_numpy(batch["images"]).to(torch.bfloat16)
        return batch

    def _eval_sample_native(self, idx: int):
        """Fused decode + resize + normalize (`data/native.py`); targets
        prepared from the annotations without decoding through PIL's
        transforms. None when the dataset has no COCO index or the file is
        not a JPEG that libjpeg decodes to RGB."""
        ds = self.ds
        if not hasattr(ds, "coco"):
            return None
        img_id = ds.ids[idx]
        info = ds.coco.imgs[img_id]
        out = native.load_image_fast(os.path.join(ds.img_folder, info["file_name"]),
                                     self.eval_size)
        if out is None:
            return None
        arr, h, w = out
        tgt = convert_coco_target(ds.coco.load_anns(img_id), w, h, img_id)
        # square resize scales boxes by (size/w, size/h); then normalize cxcywh
        sx, sy = self.eval_size / w, self.eval_size / h
        tgt["boxes"] = tgt["boxes"] * np.array([sx, sy, sx, sy], np.float32)
        tgt["size"] = np.array([self.eval_size, self.eval_size])
        dummy = Image.new("RGB", (self.eval_size, self.eval_size))
        _, tgt = T.normalize(dummy, tgt)
        return arr, tgt

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idxs = self._indices()
        if self.drop_last:
            n_batches = len(idxs) // self.batch_size
            idxs = idxs[: n_batches * self.batch_size]
        batches = [idxs[i:i + self.batch_size] for i in range(0, len(idxs), self.batch_size)]
        # pad the final short eval batch by repeating the last sample; callers
        # use image_id uniqueness to drop duplicates in the evaluator
        if batches and len(batches[-1]) < self.batch_size:
            pad = self.batch_size - len(batches[-1])
            batches[-1] = np.concatenate([batches[-1], np.repeat(batches[-1][-1:], pad)])

        rng = np.random.default_rng(
            (self.seed + self.epoch) * 100003 + self.process_index)
        # one thread makes the batches in order (the rng is drawn from in
        # batch order), up to `prefetch` ahead of the caller; `result()`
        # raises an error of the thread at the batch it arose in
        with ThreadPoolExecutor(max_workers=1) as producer:
            pending = deque()
            todo = iter(batches)
            for b in todo:
                pending.append(producer.submit(self._make_batch, b, rng))
                if len(pending) == self.prefetch:
                    break
            while pending:
                batch = pending.popleft().result()
                for b in todo:
                    pending.append(producer.submit(self._make_batch, b, rng))
                    break
                yield batch


def _pad_to_common(samples):
    """Pad images in a batch to the max H, W (legacy multi-scale recipe).

    Returns samples with a shared shape; padded area is encoded by the
    `pad_mask` entry added to each target (True on padding). The padded
    extent rounds up to a multiple of 64: the window-major ViT needs
    64-divisible inputs (16-pixel patches x 4 windows per side).
    """
    max_h = -(-max(s[0].shape[0] for s in samples) // 64) * 64
    max_w = -(-max(s[0].shape[1] for s in samples) // 64) * 64
    out = []
    for img, tgt in samples:
        h, w = img.shape[:2]
        padded = np.zeros((max_h, max_w, 3), img.dtype)
        padded[:h, :w] = img
        mask = np.ones((max_h, max_w), bool)
        mask[:h, :w] = False
        tgt = dict(tgt)
        tgt["pad_mask"] = mask
        out.append((padded, tgt))
    return out
