"""Deployment benchmark: latency and COCO stats of an exported artifact.

    python -m lwdetr_tpu_torch.deploy.benchmark --path output/lwdetr_export.pt2 \\
        [--coco_path DIR] [--repeats 10] [--limit N] [--device cuda|cpu]

Counterpart of `lwdetr_tpu/deploy/benchmark.py`: loads an artifact of
`deploy/export.py`, times it (`measure`) and, with `--coco_path`, evaluates
it on a COCO-format val set (`evaluate_coco`) with the square recipe's PIL
resize (`val_transform_square`), as the JAX package's does; the eval
loader's own decode and resize are not used. Prints one JSON line; on the
card the card's name and power limit are in it. `--device` (default cuda)
must be the device the artifact was exported on: an artifact of the card
raises without one, and nothing runs on another device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lwdetr_tpu_torch.models.lwdetr import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(call, input_hw, batch: int = 1, repeats: int = 10, warmup: int = 5,
            device=None) -> dict:
    """Latency of `call` on (batch, *input_hw, 3) f32 images made once from
    seed 0 on `device` (default: the card): each of `repeats` timed calls on
    the host clock ends in `torch.cuda.synchronize()` (mean and median ms,
    img/s from the median); then `repeats` calls enqueued back to back and
    synchronized once (pipelined ms, and the dispatch overhead: median -
    pipelined). `warmup` calls run first, untimed."""
    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((batch, *input_hw, 3), generator=g, device=device)
    for _ in range(warmup + 1):
        call(images)
    _sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        call(images)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    for _ in range(repeats):
        call(images)
    _sync(device)
    pipelined = (time.perf_counter() - t0) * 1e3 / repeats
    median = float(np.median(times))
    return {"mean_ms": float(np.mean(times)), "median_ms": median,
            "pipelined_ms": pipelined, "dispatch_overhead_ms": median - pipelined,
            "imgs_per_s": 1000.0 * batch / median, "samples_ms": times,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def evaluate_coco(call, coco_path: str, input_hw=(640, 640), batch: int = 1, limit: int = 0,
                  device=None) -> dict:
    """The 12 COCO stats of `call` over `coco_path`'s val set (its first
    `limit` images with `limit` > 0): each image resized to `input_hw` with
    PIL and normalized (`val_transform_square`), `batch` images a call on
    `device` (default: the card), the last batch filled with copies of its
    last image, the boxes scaled from the input size to the image's own."""
    from lwdetr_tpu_torch.config import DataConfig
    from lwdetr_tpu_torch.data import transforms as T
    from lwdetr_tpu_torch.data.coco import build_dataset
    from lwdetr_tpu_torch.data.coco_eval import CocoEvaluator

    device = resolve_device(device)
    ds = build_dataset("val", DataConfig(coco_path=coco_path))
    evaluator = CocoEvaluator(ds.coco)
    n = len(ds) if not limit else min(limit, len(ds))
    buf_img, buf_meta = [], []

    def flush():
        if not buf_img:
            return
        while len(buf_img) < batch:  # fill the last batch
            buf_img.append(buf_img[-1])
            buf_meta.append((None, None))
        images = torch.from_numpy(np.stack(buf_img)).to(device)
        scores, labels, boxes = (t.cpu().numpy() for t in call(images))
        for i, (img_id, scale) in enumerate(buf_meta):
            if img_id is None:
                continue
            evaluator.update({img_id: {"scores": scores[i], "labels": labels[i],
                                       "boxes": boxes[i] * scale}})
        buf_img.clear()
        buf_meta.clear()

    for idx in range(n):
        image, target = ds.load_raw(idx)
        oh, ow = int(target["orig_size"][0]), int(target["orig_size"][1])
        arr, _ = T.val_transform_square(image, None, input_hw[0])
        # the artifact's boxes are in pixels of the input size: to the image's
        scale = np.array([ow / input_hw[1], oh / input_hw[0]] * 2, np.float32)
        buf_img.append(arr)
        buf_meta.append((int(target["image_id"][0]), scale))
        if len(buf_img) == batch:
            flush()
    flush()
    return evaluator.summarize()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("deploy benchmark")
    p.add_argument("--path", required=True, help="an artifact of deploy/export.py (.pt2)")
    p.add_argument("--coco_path", default=None)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu: the artifact's")
    return p


def main(argv=None) -> dict:
    from lwdetr_tpu_torch.deploy.export import load_serialized

    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    call, meta = load_serialized(args.path)
    if meta["device"] != device.type:
        raise ValueError(f"{args.path} was exported on {meta['device']}; "
                         f"pass --device {meta['device']}")
    result = {"artifact": meta,
              "latency": measure(call, meta["input_hw"], meta["batch"], args.repeats,
                                 device=device)}
    if device.type == "cuda":
        from lwdetr_tpu_torch.utils.device import card_line

        result["card"] = card_line()
    if args.coco_path:
        result["coco"] = evaluate_coco(call, args.coco_path, meta["input_hw"], meta["batch"],
                                       args.limit, device=device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
