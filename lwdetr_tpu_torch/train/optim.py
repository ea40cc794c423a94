"""Optimizer: AdamW with per-parameter lr / wd, StepLR, EMA, drop schedules
and the stochastic-depth ramp over the ViT blocks.

Counterpart of `lwdetr_tpu/train/optim.py`, with the reference's three
parameter regions, keyed on the reference's state_dict names (which the
port's modules carry):

* ViT encoder (`backbone.0.encoder.`): lr = lr_encoder x
  layer_decay^(L + 1 - layer_id) x component_decay^2, weight decay zeroed for
  gamma, pos_embed, bias and norm parameters; a PResNet encoder: lr = 0.1 x
  lr, with the same weight-decay rule (`lwdetr_tpu/train/optim.py:63-65`);
* decoder (`transformer.decoder.`: the layers, ref_point_head, the final
  norm): lr = lr x component_decay;
* everything else: the base lr.

`torch.optim.AdamW` with one parameter group per distinct (lr, wd): decoupled
weight decay times the group's lr, gradient clipping before Adam, and StepLR
(x 0.1 every `lr_drop` epochs) as a step-indexed `LambdaLR`. The JAX
optimizer updates every leaf, so a parameter the forward does not read (the
learned position embedding) decays by (1 - s lr wd) a step; AdamW skips a
parameter without a gradient, so the train step gives those zero gradients
(`zero_missing_grads`).

ZeRO-1 (`--shard_opt_state` with more than one process): for each leaf of
`parallel/mesh.py::zero1_plan` each process keeps and updates only its slice
of the AdamW moments (`ShardedAdamW`) and of the EMA (`ema_shard`), and the
updated parameter slices are all-gathered. The gradients arrive all-reduced
by DDP (the clip reads their global norm), and each process reads its slice
of them: all-reduce plus a slice on every backend, not a reduce-scatter
(gloo has none, and the clip would need the norm's partial sums gathered).
The per-group lr / wd and the step-indexed schedule are untouched; the
sharded state reads and writes the unsharded layout (`state_dict`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.parallel import mesh
from lwdetr_tpu_torch.parallel.dist import all_gather_into

# {reference key: (start, stop, full shape)}: this process's slice of each
# planned leaf's flattened elements under ZeRO-1
Shards = Dict[str, Tuple[int, int, Tuple[int, ...]]]

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
    if name.startswith(ENCODER) and "vit" not in mcfg.encoder:  # PResNet
        return 0.1 * tcfg.lr, tcfg.weight_decay * _vit_wd_rate(name)
    if name.startswith(ENCODER):
        L = mcfg.vit_encoder_num_layers
        lr = (tcfg.lr_encoder * tcfg.lr_vit_layer_decay ** (L + 1 - _vit_layer_id(name, L))
              * tcfg.lr_component_decay ** 2)
        return lr, tcfg.weight_decay * _vit_wd_rate(name)
    if name.startswith(DECODER):
        return tcfg.lr * tcfg.lr_component_decay, tcfg.weight_decay
    return tcfg.lr, tcfg.weight_decay


def zero_missing_grads(params) -> None:
    """A zero gradient for each parameter the backward left without one, as
    `jax.grad` gives a leaf the loss does not read: AdamW then decays it by
    its weight decay, as the JAX optimizer does. Enqueued on the device, no
    host wait."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def step_lr_lambda(lr_drop_epochs: int, niter_per_ep: int, gamma: float = 0.1):
    """torch StepLR by epoch, indexed by optimizer step: gamma^(epoch // lr_drop)."""

    def sched(step: int) -> float:
        return gamma ** ((step // max(niter_per_ep, 1)) // lr_drop_epochs)

    return sched


def zero1_shards(model: nn.Module, mcfg: ModelConfig, world: int, rank: int) -> Shards:
    """This process's slices of the ZeRO-1 plan over the model's parameters
    and buffers (what the optimizer and the EMA hold)."""
    named = model.state_dict()
    plan = mesh.zero1_plan(named, world, mesh.jax_dim0(mcfg))
    return {k: (*mesh.shard_range(n, world, rank), tuple(named[k].shape))
            for k, n in plan.items()}


class ShardedAdamW(torch.optim.AdamW):
    """AdamW that keeps, for each leaf of `shards`, the state of this
    process's slice only: it optimizes a view of that slice of the parameter
    (the same elementwise update as the unsharded AdamW), then all-gathers
    the updated slices into the whole parameter. `state_dict` gathers the
    sliced moments into the unsharded layout and `load_state_dict` takes this
    process's slices of it, so checkpoints move between the two."""

    def __init__(self, groups, shards: Shards, **kwargs):
        self._sharded: List[Tuple[torch.Tensor, torch.Tensor, int]] = []  # (p, slice, start)
        self._all: List[torch.Tensor] = []
        param_groups = []
        for (lr, wd), named in groups.items():
            tensors = []
            for name, p in named:
                self._all.append(p)
                if name in shards:
                    start, stop, _ = shards[name]
                    view = p.detach().view(-1)[start:stop]
                    self._sharded.append((p, view, start))
                    tensors.append(view)
                else:
                    tensors.append(p)
            param_groups.append({"params": tensors, "lr": lr, "weight_decay": wd})
        super().__init__(param_groups, **kwargs)

    def _index(self) -> Dict[int, int]:
        flat = [t for g in self.param_groups for t in g["params"]]
        return {id(t): i for i, t in enumerate(flat)}

    @torch.no_grad()
    def step(self, closure=None):
        for p, view, start in self._sharded:
            view.grad = (None if p.grad is None
                         else p.grad.reshape(-1)[start:start + view.numel()])
        loss = super().step(closure)
        for p, view, _ in self._sharded:
            all_gather_into(p.detach().view(-1), view)
        return loss

    def zero_grad(self, set_to_none: bool = True):
        super().zero_grad(set_to_none)
        for p in self._all:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def state_dict(self):
        sd = super().state_dict()
        index, state = self._index(), dict(sd["state"])
        for p, view, _ in self._sharded:
            i = index[id(view)]
            if i in state:
                entry = dict(state[i])
                for k in ("exp_avg", "exp_avg_sq"):
                    full = entry[k].new_empty(p.numel())
                    all_gather_into(full, entry[k])
                    entry[k] = full.view(p.shape)
                state[i] = entry
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict):
        index, state = self._index(), dict(state_dict["state"])
        for _, view, start in self._sharded:
            i = index[id(view)]
            if i in state:
                entry = dict(state[i])
                for k in ("exp_avg", "exp_avg_sq"):
                    entry[k] = entry[k].reshape(-1)[start:start + view.numel()].clone()
                state[i] = entry
        super().load_state_dict({"state": state, "param_groups": state_dict["param_groups"]})


def build_optimizer(model: nn.Module, mcfg: ModelConfig, tcfg: TrainConfig, niter_per_ep: int,
                    shards: Optional[Shards] = None):
    """(AdamW over the parameters that require grad, its step-indexed
    LambdaLR); with `shards`, the ZeRO-1 `ShardedAdamW`."""
    groups: Dict[Tuple[float, float], list] = {}
    for name, p in model.named_parameters():
        if p.requires_grad:
            groups.setdefault(param_lr_wd(name, mcfg, tcfg), []).append((name, p))
    if shards:
        optimizer = ShardedAdamW(groups, shards, betas=(0.9, 0.999), eps=1e-8)
    else:
        optimizer = torch.optim.AdamW(
            [{"params": [p for _, p in ps], "lr": lr, "weight_decay": wd}
             for (lr, wd), ps in groups.items()], betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, step_lr_lambda(tcfg.lr_drop, niter_per_ep))
    return optimizer, scheduler


def optimizer_param_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> List[str]:
    """The parameter name of each index of `optimizer.state_dict()["state"]`
    (the order of its groups), a ZeRO-1 slice named as its parameter."""
    owner = {id(p): name for name, p in model.named_parameters()}
    for p, view, _ in getattr(optimizer, "_sharded", ()):
        owner[id(view)] = owner[id(p)]
    return [owner[id(t)] for g in optimizer.param_groups for t in g["params"]]


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer state this process holds."""
    return sum(v.numel() * v.element_size() for st in optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))


def ema_tensors(model: nn.Module):
    """What the EMA tracks: every parameter and buffer (the BatchNorm running
    statistics too), as the reference's EMA of the whole state_dict."""
    return dict(model.state_dict(keep_vars=True))


def _slice(t: torch.Tensor, shard) -> torch.Tensor:
    start, stop, _ = shard
    return t.detach().reshape(-1)[start:stop]


def ema_shard(ema: Optional[Dict[str, torch.Tensor]], shards: Optional[Shards]):
    """An EMA state_dict with each planned leaf cut to this process's slice
    (the EMA itself without `shards`)."""
    if ema is None or not shards:
        return ema
    return {k: _slice(v, shards[k]).clone() if k in shards else v for k, v in ema.items()}


def ema_full(ema: Dict[str, torch.Tensor], shards: Optional[Shards]) -> Dict[str, torch.Tensor]:
    """The whole EMA state_dict: each planned leaf's slices all-gathered (every
    process takes part)."""
    if not shards:
        return ema
    out = dict(ema)
    for k, (_, _, shape) in shards.items():
        full = ema[k].new_empty(int(np.prod(shape)))
        all_gather_into(full, ema[k])
        out[k] = full.view(shape)
    return out


def ema_init(model: nn.Module, shards: Optional[Shards] = None) -> Dict[str, torch.Tensor]:
    return ema_shard({k: v.detach().clone() for k, v in ema_tensors(model).items()}, shards)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float,
               shards: Optional[Shards] = None) -> None:
    """ema <- decay x ema + (1 - decay) x model, in place; integer buffers
    (BatchNorm's step counter) are copied. With `shards`, a planned leaf's
    EMA is this process's slice, updated from the model's same slice."""
    new = ema_tensors(model)
    if shards:
        new = {k: _slice(v, shards[k]) if k in shards else v for k, v in new.items()}
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
