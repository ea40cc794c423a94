"""The reference's FLOPs an image, counted once on the meta device.

`python3 -m perfbench.lib.flops <config file>` prints the `flops_per_image`
that the configuration's file stores: `torch.utils.flop_counter` over the
plain reference at batch 1, the forward in eval mode ("infer") at the eval
size, the forward in training mode over every query group and the backward
of the sum of its outputs ("train") at each train size. Products, attention
and convolutions count; element-wise work, sampling and the criterion do
not, so the count is a floor of the work a faithful implementation does.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, Iterable

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import model as ref


def count(model_cfg: dict, mode: str, size: int) -> int:
    with torch.device("meta"):
        net = ref.LWDETR(model_cfg)
    train = mode == "train"
    net.train(train)
    net.requires_grad_(train)
    images = torch.zeros((1, size, size, 3), device="meta")
    with FlopCounterMode(display=False) as counter, torch.set_grad_enabled(train):
        out = net(images, train=train)
        if train:
            leaves = [out["pred_logits"], out["pred_boxes"], out["enc_outputs"]["pred_logits"],
                      out["enc_outputs"]["pred_boxes"]]
            leaves += [t for a in out["aux_outputs"] for t in a.values()]
            sum(t.sum() for t in leaves).backward()
    return int(counter.get_total_flops())


def flops_per_image(model_cfg: dict, infer_sizes: Iterable[int],
                    train_sizes: Iterable[int]) -> Dict[str, Dict[str, int]]:
    return {"infer": {str(s): count(model_cfg, "infer", s) for s in infer_sizes},
            "train": {str(s): count(model_cfg, "train", s) for s in train_sizes}}


if __name__ == "__main__":
    conf = json.load(open(sys.argv[1]))
    print(json.dumps(flops_per_image(conf["model"], conf["sizes"]["infer"],
                                     conf["sizes"]["train"])))
