"""Single-image inference demo of the PyTorch/CUDA port.

    python -m lwdetr_tpu_torch.demo --preset tiny --image path.jpg --checkpoint ckpt.pth \\
        --output out.jpg --threshold 0.3 [--device cpu]
    python -m lwdetr_tpu_torch.demo --image path.jpg --checkpoint out/ckpt --ema
    python -m lwdetr_tpu_torch.demo --preset small --image path.jpg --checkpoint jax_out/ckpt --ema

Counterpart of the root `demo.py`, with the same flags and `--device`
(`cuda` by default; raises without a card). `--checkpoint` is a reference or
port `.pth`, a port checkpoint directory (its latest file), or the JAX CLI's
orbax directory (`<output_dir>/ckpt/` or one `<step>/` of it: its latest step,
read without JAX); `--ema` takes its EMA weights. A port checkpoint carries the
run's flags, and its model is built from them (else from `--preset`, as for an
orbax directory). The image goes through
`val_transform_square` -> forward -> `post_process` on the device; the boxes
above `--threshold` are drawn and counted. Without a checkpoint it warns and
uses seeded weights (`weights.init_state_dict(seed=0)`).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image, ImageDraw

COCO_NAMES = {
    1: "person", 2: "bicycle", 3: "car", 4: "motorcycle", 5: "airplane",
    6: "bus", 7: "train", 8: "truck", 9: "boat", 10: "traffic light",
    11: "fire hydrant", 13: "stop sign", 14: "parking meter", 15: "bench",
    16: "bird", 17: "cat", 18: "dog", 19: "horse", 20: "sheep", 21: "cow",
    22: "elephant", 23: "bear", 24: "zebra", 25: "giraffe", 27: "backpack",
    28: "umbrella", 31: "handbag", 32: "tie", 33: "suitcase", 34: "frisbee",
    35: "skis", 36: "snowboard", 37: "sports ball", 38: "kite",
    39: "baseball bat", 40: "baseball glove", 41: "skateboard",
    42: "surfboard", 43: "tennis racket", 44: "bottle", 46: "wine glass",
    47: "cup", 48: "fork", 49: "knife", 50: "spoon", 51: "bowl", 52: "banana",
    53: "apple", 54: "sandwich", 55: "orange", 56: "broccoli", 57: "carrot",
    58: "hot dog", 59: "pizza", 60: "donut", 61: "cake", 62: "chair",
    63: "couch", 64: "potted plant", 65: "bed", 67: "dining table",
    70: "toilet", 72: "tv", 73: "laptop", 74: "mouse", 75: "remote",
    76: "keyboard", 77: "cell phone", 78: "microwave", 79: "oven",
    80: "toaster", 81: "sink", 82: "refrigerator", 84: "book", 85: "clock",
    86: "vase", 87: "scissors", 88: "teddy bear", 89: "hair drier",
    90: "toothbrush",
}


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("LW-DETR PyTorch/CUDA demo")
    p.add_argument("--preset", default="tiny")
    p.add_argument("--image", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a reference or port .pth, a port checkpoint directory, or the JAX "
                        "CLI's orbax checkpoint directory")
    p.add_argument("--output", default="demo_out.jpg")
    p.add_argument("--threshold", type=float, default=0.3)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--ema", action="store_true",
                   help="use the EMA weights of a port or orbax checkpoint")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def load_demo_model(args, device):
    """(model in eval mode, its ModelConfig) from `args.checkpoint`, or seeded weights."""
    from lwdetr_tpu_torch import main as cli
    from lwdetr_tpu_torch.config import get_config
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import checkpoint as ckpt
    from lwdetr_tpu_torch.weights import init_state_dict

    cfg = get_config(args.preset)
    if not args.checkpoint:
        print("WARNING: random weights (no checkpoint given)")
        return build_model(cfg, device=device, state_dict=init_state_dict(cfg, seed=0)), cfg
    raw = ckpt.read_checkpoint(args.checkpoint)
    if ckpt.is_orbax_tree(raw):  # the JAX CLI's orbax directory (root demo.py:66-69)
        if args.ema and not raw.get("ema"):
            print("WARNING: the checkpoint holds no EMA weights; using its model")
        sd = ckpt.load_orbax_variables(args.checkpoint, cfg, use_ema=args.ema, tree=raw)
        return build_model(cfg, device=device, state_dict=sd), cfg
    if isinstance(raw, dict) and isinstance(raw.get("args"), dict):
        run = argparse.Namespace(**dict(vars(cli.parser().parse_args([])), **raw["args"]))
        cfg = cli.config_from_args(run).model
    key = "ema_model" if args.ema and isinstance(raw, dict) and "ema_model" in raw else "model"
    if args.ema and key != "ema_model":
        print("WARNING: the checkpoint holds no EMA weights; using its model")
    return build_model(cfg, device=device, state_dict=ckpt.state_dict_of(raw, key)), cfg


@torch.no_grad()
def main(argv=None) -> dict:
    """Runs the demo; returns {"scores", "labels", "boxes"} (host arrays over
    the `num_select` picks) and "kept", the count above the threshold."""
    from lwdetr_tpu_torch.data import transforms as T
    from lwdetr_tpu_torch.models.lwdetr import post_process, resolve_device

    args = get_args_parser().parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, cfg = load_demo_model(args, device)

    image = Image.open(args.image).convert("RGB")
    arr, _ = T.val_transform_square(image, None, args.size)
    images = torch.from_numpy(np.ascontiguousarray(arr))[None].to(device)
    out = model(images)
    sizes = torch.tensor([[image.height, image.width]], dtype=torch.float32, device=device)
    scores, labels, boxes = (t[0].cpu().numpy() for t in post_process(
        out["pred_logits"], out["pred_boxes"], sizes, num_select=cfg.num_select))

    draw = ImageDraw.Draw(image)
    kept = 0
    for s, lab, b in zip(scores, labels, boxes):
        if s < args.threshold:
            continue
        kept += 1
        x0, y0, x1, y1 = b.tolist()
        draw.rectangle([x0, y0, x1, y1], outline="red", width=3)
        name = COCO_NAMES.get(int(lab), str(int(lab)))
        draw.text((x0 + 2, max(y0 - 12, 0)), f"{name} {s:.2f}", fill="red")
    image.save(args.output)
    print(f"{kept} detections >= {args.threshold} -> {args.output}")
    return {"scores": scores, "labels": labels, "boxes": boxes, "kept": kept}


if __name__ == "__main__":
    main()
