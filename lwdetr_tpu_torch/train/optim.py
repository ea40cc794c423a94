"""Optimizer: AdamW with per-parameter lr / wd, StepLR, EMA, drop schedules
and the stochastic-depth ramp over the ViT blocks.

Counterpart of `lwdetr_tpu/train/optim.py`, with the reference's three
parameter regions, keyed on the reference's state_dict names (which the
port's modules carry):

* ViT encoder (`backbone.0.encoder.`): lr = lr_encoder x
  layer_decay^(L + 1 - layer_id) x component_decay^2, weight decay zeroed for
  gamma, pos_embed, bias and norm parameters;
* decoder (`transformer.decoder.`: the layers, ref_point_head, the final
  norm): lr = lr x component_decay;
* everything else: the base lr.

`torch.optim.AdamW` with one parameter group per distinct (lr, wd): decoupled
weight decay times the group's lr, gradient clipping before Adam, and StepLR
(x 0.1 every `lr_drop` epochs) as a step-indexed `LambdaLR`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig

ENCODER = "backbone.0.encoder."
DECODER = "transformer.decoder."


def _vit_layer_id(name: str, num_layers: int) -> int:
    if "pos_embed" in name or "patch_embed" in name:
        return 0
    if ".blocks." in name:
        return int(name.split(".blocks.")[1].split(".")[0]) + 1
    return num_layers + 1


def _vit_wd_rate(name: str) -> float:
    leaf = name.rsplit(".", 1)[-1]
    if ("gamma" in name or "pos_embed" in name or "rel_pos" in name or "bias" in leaf
            or "norm" in name.lower()):
        return 0.0
    return 1.0


def param_lr_wd(name: str, mcfg: ModelConfig, tcfg: TrainConfig) -> Tuple[float, float]:
    """(lr, weight decay) of the parameter with the reference name `name`."""
    if name.startswith(ENCODER):
        L = mcfg.vit_encoder_num_layers
        lr = (tcfg.lr_encoder * tcfg.lr_vit_layer_decay ** (L + 1 - _vit_layer_id(name, L))
              * tcfg.lr_component_decay ** 2)
        return lr, tcfg.weight_decay * _vit_wd_rate(name)
    if name.startswith(DECODER):
        return tcfg.lr * tcfg.lr_component_decay, tcfg.weight_decay
    return tcfg.lr, tcfg.weight_decay


def step_lr_lambda(lr_drop_epochs: int, niter_per_ep: int, gamma: float = 0.1):
    """torch StepLR by epoch, indexed by optimizer step: gamma^(epoch // lr_drop)."""

    def sched(step: int) -> float:
        return gamma ** ((step // max(niter_per_ep, 1)) // lr_drop_epochs)

    return sched


def build_optimizer(model: nn.Module, mcfg: ModelConfig, tcfg: TrainConfig, niter_per_ep: int):
    """(AdamW over the parameters that require grad, its step-indexed LambdaLR)."""
    groups: Dict[Tuple[float, float], list] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups.setdefault(param_lr_wd(name, mcfg, tcfg), []).append(p)
    optimizer = torch.optim.AdamW(
        [{"params": ps, "lr": lr, "weight_decay": wd} for (lr, wd), ps in groups.items()],
        betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, step_lr_lambda(tcfg.lr_drop, niter_per_ep))
    return optimizer, scheduler


def ema_tensors(model: nn.Module):
    """What the EMA tracks: every parameter and buffer (the BatchNorm running
    statistics too), as the reference's EMA of the whole state_dict."""
    return dict(model.state_dict(keep_vars=True))


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in ema_tensors(model).items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- decay x ema + (1 - decay) x model, in place; integer buffers
    (BatchNorm's step counter) are copied."""
    new = ema_tensors(model)
    floats = [k for k, v in ema.items() if v.is_floating_point()]
    torch._foreach_lerp_([ema[k] for k in floats], [new[k].detach() for k in floats], 1.0 - decay)
    for k, v in ema.items():
        if not v.is_floating_point():
            v.copy_(new[k])


def drop_scheduler(drop_rate: float, epochs: int, niter_per_ep: int, cutoff_epoch: int = 0,
                   mode: str = "standard", schedule: str = "constant") -> np.ndarray:
    """Per-iteration drop rates (drop-path or dropout) over a whole run."""
    if mode not in ("standard", "early", "late"):
        raise ValueError(f"unknown drop mode {mode}")
    total = epochs * niter_per_ep
    if mode == "standard":
        return np.full(total, drop_rate, np.float32)
    early_iters = cutoff_epoch * niter_per_ep
    late_iters = total - early_iters
    if mode == "early":
        if schedule not in ("constant", "linear"):
            raise ValueError(f"unknown drop schedule {schedule}")
        early = (np.full(early_iters, drop_rate, np.float32) if schedule == "constant"
                 else np.linspace(drop_rate, 0, early_iters, dtype=np.float32))
        return np.concatenate([early, np.zeros(late_iters, np.float32)])
    if schedule != "constant":
        raise ValueError("the late drop mode takes the constant schedule only")
    return np.concatenate([np.zeros(early_iters, np.float32),
                           np.full(late_iters, drop_rate, np.float32)])


def drop_path_rates_for(rate, depth: int) -> np.ndarray:
    """The per-block stochastic-depth rates, the linear ramp linspace(0, 1,
    depth) x rate in float32 (`lwdetr_tpu/train/optim.py:151-155`), the ramp
    formed as XLA forms jnp.linspace: i x (1 / (depth - 1)) in float32, then 1."""
    if depth < 2:
        ramp = np.zeros(depth, np.float32)
    else:
        step = np.float32(1.0) / np.float32(depth - 1)
        ramp = np.append(np.arange(depth - 1, dtype=np.float32) * step, np.float32(1.0))
    return ramp * np.float32(rate)


def scheduled(sched, step: int) -> float:
    """The rate a per-iteration schedule gives step `step`: its last entry
    past its end, 0 without a schedule (`lwdetr_tpu/train/engine.py:181-184`)."""
    if sched is None or len(sched) == 0:
        return 0.0
    return float(sched[min(step, len(sched) - 1)])
