"""Training and evaluation engine.

Counterpart of `lwdetr_tpu/train/engine.py`. The JAX package compiles the
whole step into one function; here a step is plain Python over the device:
zero_grad -> forward (train mode, the step's stochastic-depth and dropout
rates) -> criterion (one host matching) -> backward -> clip -> AdamW -> LR
schedule -> EMA. The drop masks come from a generator on the model's device
seeded from (seed, step); a rate whose whole schedule is zero draws none.
Metrics stay on the device as 0-dim tensors and are fetched one step late,
so the host does not wait on the device for them. `evaluate` needs the COCO
evaluator of the data slice and is not ported.
"""
from __future__ import annotations

import math
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model, post_process
from lwdetr_tpu_torch.train import optim


@dataclass
class TrainState:
    model: LWDETR
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    ema: Optional[Dict[str, torch.Tensor]]  # EMA of parameters and buffers, or None
    step: int = 0


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig, niter_per_ep: int, device=None,
                       state_dict: Optional[dict] = None,
                       dtype: torch.dtype = torch.float32) -> TrainState:
    """A train-mode model computing in `dtype` (float32 or bfloat16; the
    parameters are float32 either way) on `device` (CUDA unless given; raises
    when there is no card), its optimizer and schedule, and the EMA copy if
    configured."""
    model = build_model(mcfg, device=device, dtype=dtype, state_dict=state_dict, train=True)
    optimizer, scheduler = optim.build_optimizer(model, mcfg, tcfg, niter_per_ep)
    ema = optim.ema_init(model) if tcfg.use_ema else None
    return TrainState(model, optimizer, scheduler, ema)


def _targets(batch) -> Targets:
    return Targets(batch["labels"], batch["boxes"], batch["valid"])


def build_train_step(state: TrainState, criterion: SetCriterion, tcfg: TrainConfig,
                     static_zero_drop_path: bool = False, static_zero_dropout: bool = False,
                     seed: Optional[int] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(batch, drop_path_rate=0.0, dropout_rate=0.0,
    mask_source=None) -> metrics. `batch` holds `images` (B, H, W, 3),
    `labels` (B, T), `boxes` (B, T, 4) and `valid` (B, T) on the model's
    device. The rates are the step's (`train_one_epoch` reads them from the
    schedules); the ViT blocks take the linear ramp of `drop_path_rate`. The
    masks are drawn with a generator seeded from (`seed`, default
    `tcfg.seed`, and the step count), or by `mask_source` when one is given.
    `static_zero_drop_path` / `static_zero_dropout`: the whole schedule is
    zero, so no mask of that kind is drawn at all (the JAX package's flags of
    the same names). The step updates `state` in place; the metrics (every
    loss component, `loss`, and `grad_norm` before clipping) are 0-dim
    tensors on the device."""
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    depth = model.cfg.vit_encoder_num_layers
    seed = tcfg.seed if seed is None else seed
    device = next(model.parameters()).device

    def train_step(batch, drop_path_rate=0.0, dropout_rate=0.0,
                   mask_source: Optional[drop.MaskSource] = None) -> Dict[str, torch.Tensor]:
        model.train()
        dp_rates = None if static_zero_drop_path else optim.drop_path_rates_for(
            drop_path_rate, depth)
        do_rate = 0.0 if static_zero_dropout else dropout_rate
        drawn = (dp_rates is not None and float(drop_path_rate) != 0.0) or float(do_rate) != 0.0
        if mask_source is None and drawn:
            mask_source = drop.Bernoulli(drop.step_generator(device, seed, state.step))
        state.optimizer.zero_grad(set_to_none=True)
        out = model(batch["images"], dp_rates, do_rate, mask_source)
        total, losses = criterion(out, _targets(batch), train=True)
        total.backward()
        # clips in place; returns the global norm before clipping
        grad_norm = torch.nn.utils.clip_grad_norm_(params, tcfg.clip_max_norm)
        state.optimizer.step()
        state.scheduler.step()
        if state.ema is not None:
            optim.ema_update(state.ema, model, tcfg.ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def build_eval_step(model: LWDETR, num_select: int, criterion: Optional[SetCriterion] = None):
    """Returns eval_step(batch) -> ((scores, labels, boxes_xyxy_abs), losses)
    at the original image scale (`batch["orig_size"]`, (B, 2) as (h, w)). With
    `criterion` the eval losses are computed on the same forward; losses is
    {} otherwise."""

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out = model(batch["images"])
        losses = {}
        if criterion is not None:
            total, losses = criterion(out, _targets(batch), train=False)
            losses = dict(losses, loss=total)
        dets = post_process(out["pred_logits"], out["pred_boxes"], batch["orig_size"],
                            num_select=num_select)
        return dets, losses

    return eval_step


class MetricLogger:
    """Running global averages of named scalars."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.total[k] += float(v)
            self.count[k] += 1

    def global_avg(self) -> Dict[str, float]:
        return {k: self.total[k] / self.count[k] for k in self.total}


def train_one_epoch(train_step, state: TrainState, loader, epoch: int, niter_per_ep: int,
                    put_fn=None, log_every: int = 50, logger=print, should_stop=None,
                    drop_path_sched=None, dropout_sched=None):
    """One epoch over `loader`. Step `it` is global step epoch x niter_per_ep
    + it, and runs train_step(batch, drop-path rate, dropout rate) with each
    rate read from its per-iteration schedule (the last entry past its end,
    0 without one). Every step's loss is checked for finiteness;
    step N's metrics are fetched after step N + 1 has been enqueued, so the
    host does not stall the device for them, and a NaN aborts one step late,
    naming the step it arose in. `should_stop()` is polled once per step: the
    loop finishes the step in flight and returns, so the caller can
    checkpoint. Returns the meters' global averages and `epoch_time`."""
    t0 = time.time()
    mlog = MetricLogger()
    pending = None  # (iteration, metrics still on the device)

    def consume(it, dev_metrics):
        metrics = {k: float(v) for k, v in dev_metrics.items()}
        loss = metrics["loss"]
        if not math.isfinite(loss):
            logger(f"Loss is {loss}, stopping training. Components: {metrics}")
            raise FloatingPointError(f"Loss is {loss} at epoch {epoch} it {it}")
        mlog.update(**metrics)
        if it % log_every == 0:
            logger(f"epoch {epoch} it {it}/{niter_per_ep} loss {loss:.4f} "
                   f"grad_norm {metrics['grad_norm']:.2f} "
                   f"({(time.time() - t0) / max(it + 1, 1):.2f}s/it)")

    for it, batch in enumerate(loader):
        gstep = epoch * niter_per_ep + it
        if put_fn is not None:
            batch = put_fn(batch)
        metrics = train_step(batch, optim.scheduled(drop_path_sched, gstep),
                             optim.scheduled(dropout_sched, gstep))
        if pending is not None:
            consume(*pending)
        pending = (it, metrics)
        if should_stop is not None and should_stop():
            logger(f"stop requested at epoch {epoch} it {it}: draining")
            break
    if pending is not None:
        consume(*pending)
    meters = mlog.global_avg()
    meters["epoch_time"] = time.time() - t0
    return meters
