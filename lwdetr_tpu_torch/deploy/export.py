"""Deployment export: `torch.export` of the eval forward + `post_process`.

Counterpart of `lwdetr_tpu/deploy/export.py`, which serializes a `jax.export`
StableHLO module beside its weights. Here the artifact is a `torch.export`
program written by `torch.export.save` (`.pt2`): the eval forward without a
mask (the first query group) and the NMS-free top-k decode, at one fixed
batch and input size, returning (scores, labels, boxes) with the boxes in
pixels of the input size. The kernels are operators of the `lwdetr`
namespace (`ops/flash_attention.py`, `ops/deform_attn.py`), so the graph
holds one node a kernel launch, and the loaded program launches them. The
artifact carries the float32 weights; a bf16 model casts them in the graph
where it uses them (`models/cast.py`), as the JAX artifact does. Its input
size, batch, `num_select`, compute dtype and device ride in its
`extra_files` as JSON (`META`). An artifact exported on the card holds its
weights there and runs only there.

    python -m lwdetr_tpu_torch.main --preset small export_model [--shape 640 640]
        [--infer_dir IMAGE] [--resume X.pth] [--device cpu]
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Tuple

import numpy as np
import torch
from torch import nn

from lwdetr_tpu_torch.models.lwdetr import build_model, post_process, resolve_device

META = "lwdetr_meta.json"
ARTIFACT = "lwdetr_export.pt2"


class ExportFn(nn.Module):
    """images (batch, h, w, 3) f32, normalized -> (scores (batch, S), labels
    (batch, S), boxes (batch, S, 4) xyxy in pixels of (h, w)): the model's
    eval forward, then `post_process` at `num_select` with (h, w) as every
    image's size (the JAX `make_export_fn`)."""

    def __init__(self, model: nn.Module, num_select: int, input_hw, batch: int = 1):
        super().__init__()
        self.model = model
        self.num_select = int(num_select)
        self.input_hw = tuple(int(x) for x in input_hw)
        self.batch = int(batch)

    def forward(self, images: torch.Tensor):
        out = self.model(images)
        h, w = self.input_hw
        b = images.shape[0]
        sizes = torch.stack([images.new_full((b,), float(h), dtype=torch.float32),
                             images.new_full((b,), float(w), dtype=torch.float32)], dim=1)
        return post_process(out["pred_logits"], out["pred_boxes"], sizes, self.num_select)


def make_export_fn(model: nn.Module, num_select: int, input_hw, batch: int = 1) -> ExportFn:
    return ExportFn(model, num_select, input_hw, batch).eval()


def export_serialized(model: nn.Module, out_path: str, input_hw=(640, 640), batch: int = 1,
                      num_select: int = 300) -> str:
    """`torch.export` of `make_export_fn(model, ...)` at (batch, *input_hw, 3)
    f32 images on the model's device, saved to `out_path` with its weights
    and `META`. Returns the path."""
    fn = make_export_fn(model, num_select, input_hw, batch)
    device = next(model.parameters()).device
    images = torch.zeros((batch, *fn.input_hw, 3), dtype=torch.float32, device=device)
    program = torch.export.export(fn, (images,))
    meta = {"input_hw": list(fn.input_hw), "batch": fn.batch, "num_select": fn.num_select,
            "dtype": str(model.compute_dtype).split(".")[-1], "device": device.type}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path, extra_files={META: json.dumps(meta)})
    return out_path


def read_meta(path: str) -> dict:
    """An artifact's `META`, read without loading its program or weights."""
    with zipfile.ZipFile(path) as archive:
        name = next((n for n in archive.namelist() if n.endswith(f"/extra/{META}")), None)
        if name is None:
            raise ValueError(f"{path}: no {META}; not an artifact of export_serialized")
        return json.loads(archive.read(name))


def load_serialized(path: str):
    """(callable, meta) of an exported artifact: the loaded program's module,
    which takes the images tensor on the artifact's device. The `lwdetr`
    operators are registered first. An artifact exported on the card raises
    when no card is present: nothing moves it to the CPU."""
    from lwdetr_tpu_torch.ops import deform_attn, flash_attention  # noqa: F401 (the operators)

    meta = read_meta(path)
    resolve_device(meta["device"])
    return torch.export.load(path).module(), meta


def export_main(args, cfg) -> str:
    """The CLI's `export_model` (the JAX `export_main`): the model in bf16
    (float32 parameters) on `--device`, the weights of `--resume`'s `.pth`,
    else the JAX initialisation (seed 0), exported at `--shape` and
    `--batch` with the config's `num_select` to
    `<output_dir>/lwdetr_export.pt2`; with `--infer_dir` (an image file) the
    artifact runs on it and its top 5 are printed."""
    from lwdetr_tpu_torch.train.checkpoint import load_pth

    state_dict = load_pth(args.resume) if getattr(args, "resume", "") else None
    model = build_model(cfg.model, device=resolve_device(args.device), dtype=torch.bfloat16,
                        state_dict=state_dict)
    out = os.path.join(args.output_dir or "output", ARTIFACT)
    path = export_serialized(model, out, input_hw=tuple(args.shape), batch=args.batch,
                             num_select=cfg.model.num_select)
    print(f"exported to {path}")
    if getattr(args, "infer_dir", None):
        scores, labels, _ = run_artifact_on_image(path, args.infer_dir, tuple(args.shape))
        top = np.argsort(-scores[0], kind="stable")[:5]
        print("artifact smoke inference (top-5):",
              [(int(labels[0][i]), round(float(scores[0][i]), 4)) for i in top])
    return path


def run_artifact_on_image(path: str, image_path: str, input_hw=(640, 640)
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an artifact and run it on one image file, resized with PIL
    bilinear to `input_hw` and normalized. Returns (scores, labels, boxes)
    numpy arrays (batch 1; an artifact of a larger batch takes the image in
    every slot)."""
    from PIL import Image

    from lwdetr_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    call, meta = load_serialized(path)
    img = Image.open(image_path).convert("RGB").resize((input_hw[1], input_hw[0]),
                                                       Image.BILINEAR)
    arr = (np.asarray(img, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    images = torch.from_numpy(np.ascontiguousarray(arr)).to(meta["device"])
    out = call(images[None].expand(meta["batch"], -1, -1, -1).contiguous())
    return tuple(o[:1].cpu().numpy() for o in out)
