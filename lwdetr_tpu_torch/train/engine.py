"""Training and evaluation engine.

Counterpart of `lwdetr_tpu/train/engine.py`. The JAX package compiles the
whole step into one function; here a step is plain Python over the device:
zero_grad -> forward (train mode, the step's stochastic-depth and dropout
rates) -> criterion (one host matching) -> backward -> clip -> AdamW -> LR
schedule -> EMA. The drop masks come from a generator on the model's device
seeded from (seed, step); a rate whose whole schedule is zero draws none.
Metrics stay on the device as 0-dim tensors and are fetched one step late,
so the host does not wait on the device for them. `evaluate` runs an eval
step over a loader into the COCO evaluator (`data/coco_eval.py`). With more
than one process (`parallel/`) the forward runs under DDP, the drop masks
are this process's rows of a draw at the global batch's shape, ZeRO-1 shards
the optimizer and the EMA when the state was built so, and `evaluate` merges
the processes' detections before it summarizes.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from lwdetr_tpu_torch.config import ModelConfig, TrainConfig
from lwdetr_tpu_torch.models import drop
from lwdetr_tpu_torch.models.criterion import SetCriterion, Targets
from lwdetr_tpu_torch.models.lwdetr import LWDETR, build_model, post_process
from lwdetr_tpu_torch.parallel import mesh
from lwdetr_tpu_torch.parallel.dist import merge_evaluators, rank, world_size
from lwdetr_tpu_torch.train import optim
from lwdetr_tpu_torch.utils.logging import MetricLogger


@dataclass
class TrainState:
    model: LWDETR
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    ema: Optional[Dict[str, torch.Tensor]]  # EMA of parameters and buffers, or None
    step: int = 0
    shards: Optional[optim.Shards] = None  # this process's ZeRO-1 slices, or None
    ddp: Optional[torch.nn.Module] = None  # the model under DDP (more than one process)


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig, niter_per_ep: int, device=None,
                       state_dict: Optional[dict] = None,
                       dtype: torch.dtype = torch.float32,
                       shard_opt_state: bool = False) -> TrainState:
    """A train-mode model computing in `dtype` (float32 or bfloat16; the
    parameters are float32 either way) on `device` (CUDA unless given; raises
    when there is no card), its optimizer and schedule, and the EMA copy if
    configured. Without `state_dict` the weights are the JAX package's
    initialisation drawn from `tcfg.seed`. `shard_opt_state` with more than
    one process: ZeRO-1 (`optim.ShardedAdamW`, a sharded EMA)."""
    model = build_model(mcfg, device=device, dtype=dtype, state_dict=state_dict, train=True,
                        generator=torch.Generator().manual_seed(tcfg.seed))
    shards = (optim.zero1_shards(model, mcfg, world_size(), rank())
              if shard_opt_state and world_size() > 1 else None)
    optimizer, scheduler = optim.build_optimizer(model, mcfg, tcfg, niter_per_ep, shards)
    ema = optim.ema_init(model, shards) if tcfg.use_ema else None
    return TrainState(model, optimizer, scheduler, ema, shards=shards)


def _targets(batch) -> Targets:
    return Targets(batch["labels"], batch["boxes"], batch["valid"])


def build_train_step(state: TrainState, criterion: SetCriterion, tcfg: TrainConfig,
                     static_zero_drop_path: bool = False, static_zero_dropout: bool = False,
                     seed: Optional[int] = None) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(batch, drop_path_rate=0.0, dropout_rate=0.0,
    mask_source=None) -> metrics. `batch` holds `images` (B, H, W, 3), `labels` (B,
    T), `boxes` (B, T, 4) and `valid` (B, T) on the model's device, and `pad_mask`
    (B, H, W) when the loader padded the batch to a common size (the JAX step's
    `masks=batch.get("pad_mask")`). The rates are the step's (`train_one_epoch`
    reads them from the schedules); the ViT blocks take the linear ramp of
    `drop_path_rate`. The masks are drawn with a generator seeded from (`seed`,
    default `tcfg.seed`, and the step count), or by `mask_source` when one is given.
    `static_zero_drop_path` / `static_zero_dropout`: the whole schedule is zero, so
    no mask of that kind is drawn at all (the JAX package's flags of the same
    names). The step updates `state` in place; the metrics (every loss component,
    `loss`, and `grad_norm` before clipping) are 0-dim tensors on the device.
    With more than one process the forward runs on `state.ddp` (made here if
    the state has none) and each process draws its rows of the global masks
    (`drop.RankRows`); a given `mask_source` is used as it is."""
    model = state.model
    params = [p for p in model.parameters() if p.requires_grad]
    depth = model.cfg.vit_encoder_num_layers
    seed = tcfg.seed if seed is None else seed
    device = next(model.parameters()).device
    world = world_size()
    if world > 1 and state.ddp is None:
        state.ddp = mesh.wrap_ddp(model, device)
    net = model if state.ddp is None else state.ddp

    def train_step(batch, drop_path_rate=0.0, dropout_rate=0.0,
                   mask_source: Optional[drop.MaskSource] = None) -> Dict[str, torch.Tensor]:
        model.train()
        dp_rates = None if static_zero_drop_path else optim.drop_path_rates_for(
            drop_path_rate, depth)
        do_rate = 0.0 if static_zero_dropout else dropout_rate
        drawn = (dp_rates is not None and float(drop_path_rate) != 0.0) or float(do_rate) != 0.0
        if mask_source is None and drawn:
            mask_source = drop.RankRows(
                drop.Bernoulli(drop.step_generator(device, seed, state.step)), rank(), world)
        state.optimizer.zero_grad(set_to_none=True)
        out = net(batch["images"], batch.get("pad_mask"), dp_rates, do_rate, mask_source)
        total, losses = criterion(out, _targets(batch), train=True)
        total.backward()
        optim.zero_missing_grads(params)  # a parameter the forward does not read still decays
        # clips in place; returns the global norm before clipping
        grad_norm = torch.nn.utils.clip_grad_norm_(params, tcfg.clip_max_norm)
        state.optimizer.step()
        state.scheduler.step()
        if state.ema is not None:
            optim.ema_update(state.ema, model, tcfg.ema_decay, state.shards)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def build_eval_step(model: LWDETR, num_select: int, criterion: Optional[SetCriterion] = None):
    """Returns eval_step(batch) -> ((scores, labels, boxes_xyxy_abs), losses) at the
    original image scale (`batch["orig_size"]`, (B, 2) as (h, w)); a padded batch's
    `pad_mask` goes to the model. With `criterion` the eval losses are computed on
    the same forward; losses is {} otherwise."""

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        out = model(batch["images"], batch.get("pad_mask"))
        losses = {}
        if criterion is not None:
            total, losses = criterion(out, _targets(batch), train=False)
            losses = dict(losses, loss=total)
        dets = post_process(out["pred_logits"], out["pred_boxes"], batch["orig_size"],
                            num_select=num_select)
        return dets, losses

    return eval_step


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
    mlog.synchronize_between_processes()
    meters = {k: m.global_avg for k, m in mlog.meters.items()}
    meters["epoch_time"] = time.time() - t0
    return meters


def _fetch(tensors):
    """Device tensors -> host numpy arrays, with one wait on the device."""
    host = [t.detach().to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.current_stream().synchronize()
    return [h.float().numpy() if h.dtype == torch.bfloat16 else h.numpy() for h in host]


def evaluate(eval_step, loader, evaluator, put_fn=None, logger=print):
    """Eval loop: forward + `post_process` on the device, COCO accumulation on
    the host (the reference's engine.py:93-164; `lwdetr_tpu/train/engine.py:207`).
    `eval_step(batch) -> ((scores, labels, boxes), losses)` is
    `build_eval_step`'s; `put_fn` moves a host batch to the step's device
    (`data.loader.to_device`). Each batch's detections and losses are fetched
    in one wait; the padded duplicates of the last batch are skipped by image
    id. When the step was built with a criterion, the loss components are
    metered and returned alongside the 12 AP/AR stats. With more than one
    process each evaluates its loader's share, and the detections are merged
    (`parallel/dist.py::merge_evaluators`) and the meters averaged over all
    of them before every process summarizes."""
    t0 = time.time()
    seen = set()
    mlog = MetricLogger()
    for batch in loader:
        dev_batch = put_fn(batch) if put_fn is not None else batch
        (scores, labels, boxes), losses = eval_step(dev_batch)
        names = list(losses)
        scores, labels, boxes, *values = _fetch([scores, labels, boxes]
                                                + [losses[k] for k in names])
        if names:
            mlog.update(**{k: float(v) for k, v in zip(names, values)})
        results = {}
        for i, img_id in enumerate(batch["image_id"].tolist()):
            if img_id in seen:
                continue  # padded duplicate in the final batch
            seen.add(img_id)
            results[img_id] = {"scores": scores[i], "labels": labels[i], "boxes": boxes[i]}
        evaluator.update(results)
    logger(f"eval forward done in {time.time() - t0:.1f}s ({len(seen)} images)")
    evaluator = merge_evaluators(evaluator)
    mlog.synchronize_between_processes()
    stats = {k: m.global_avg for k, m in mlog.meters.items()}
    stats.update(evaluator.summarize())
    return stats
