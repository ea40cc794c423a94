"""LW-DETR train / eval CLI of the PyTorch/CUDA port.

    python -m lwdetr_tpu_torch.main --preset small --coco_path /data/coco \\
        --output_dir out [--epochs N] [--bf16] [--resume out/ckpt]
    python -m lwdetr_tpu_torch.main --eval --preset small --coco_path /data/coco \\
        --resume LWDETR_small_coco.pth [--bf16] [--use_ema]
    python -m lwdetr_tpu_torch.main --eval --preset small --coco_path /data/coco \\
        --resume jax_out/ckpt --use_ema        (the JAX CLI's orbax directory)
    python -m lwdetr_tpu_torch.main --device cpu --coco_path DIR ... (model flags)
    python -m lwdetr_tpu_torch.main --preset small export_model [--shape 640 640] \
        [--infer_dir IMAGE] [--resume X.pth]

Counterpart of the root `main.py` (`get_args_parser`, `config_from_args`, its
`--eval` branch and its train loop without the mesh): the same flags with the
same meanings. Training: COCO-format dir -> `CocoDetection` ->
`DetectionLoader` (reshuffled each epoch) -> `train_one_epoch` on the card
(the port's kernels, the matcher M1) with the drop-path and dropout
schedules; after each epoch the train state is saved (`ckpt/` by global
step, keep 3; `ckpt_epochs/` at `lr_drop` and every `checkpoint_interval`
epochs, keep all), evaluated (and its EMA), the precision / recall arrays
dumped to `eval/latest.npz`, the best regular and EMA states saved
(`ckpt_best_regular/`, `ckpt_best_ema/`, keep 1) and one JSON record with the
JAX CLI's keys appended to `log.txt`. SIGTERM finishes the step in flight,
saves and exits. `--resume` takes a reference `.pth` (weights, EMA, epoch) or
the port's own checkpoint file or directory (the whole train state; the start
epoch is step // steps an epoch), or the JAX CLI's orbax directory
(`<output_dir>/ckpt/` or one `<step>/` of it; read by `train/orbax_read.py`
without JAX: for `--eval` its weights and, with `--use_ema`, its EMA's; for
training its whole train state, AdamW's moments and the schedule included). `--eval` runs `evaluate` -> `CocoEvaluator`
and prints the 12 AP/AR stats (and the eval losses) as one JSON line. With a
`--preset`, the train flags given on the command line (`--epochs`,
`--batch_size`, `--use_ema`, ...) override the preset's recipe. `--device`
defaults to `cuda` and raises when there is no card; `--device cpu` runs the
plain versions. `export_model` writes the deploy artifact: the eval forward
and `post_process` through `torch.export`, in bf16 with float32 weights
(`deploy/export.py`; `--dry-run` prints what it would do). f32 keeps TF32
off, so f32 means f32. A multi-process launch (torchrun's or SLURM's variables,
or COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) runs one process a card
(`parallel/`): `--batch_size` per process, DDP, the statistics and `num_boxes`
of the global batch, `--shard_opt_state` as ZeRO-1, the detections merged for
the eval, and rank 0 alone printing and writing. Rank 0 runs the startup
self-benchmark (`utils/benchmark.py`) unless `--dont_bench`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch


def get_args_parser():
    p = argparse.ArgumentParser("LW-DETR PyTorch/CUDA", add_help=False)
    p.add_argument("--preset", default=None,
                   choices=("tiny", "small", "medium", "large", "xlarge"),
                   help="release preset; individual flags override")
    # optimization (reference main.py:41-66)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr_encoder", default=1.5e-4, type=float)
    p.add_argument("--batch_size", default=2, type=int,
                   help="batch of the loader, per process (the global batch is this x the "
                        "number of processes)")
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--epochs", default=12, type=int)
    p.add_argument("--lr_drop", default=11, type=int)
    p.add_argument("--clip_max_norm", default=0.1, type=float)
    p.add_argument("--lr_vit_layer_decay", default=0.8, type=float)
    p.add_argument("--lr_component_decay", default=1.0, type=float)
    p.add_argument("--dropout", default=0, type=float)
    p.add_argument("--drop_path", default=0, type=float)
    p.add_argument("--drop_mode", default="standard", choices=("standard", "early", "late"))
    p.add_argument("--drop_schedule", default="constant", choices=("constant", "linear"))
    p.add_argument("--cutoff_epoch", default=0, type=int)
    # model loading
    p.add_argument("--pretrained_encoder", default=None, type=str)
    p.add_argument("--pretrain_weights", default=None, type=str)
    p.add_argument("--pretrain_exclude_keys", default=None, type=str, nargs="+")
    p.add_argument("--pretrain_keys_modify_to_load", default=None, type=str, nargs="+")
    # backbone
    p.add_argument("--encoder", default="vit_tiny", type=str)
    p.add_argument("--vit_encoder_num_layers", default=12, type=int)
    p.add_argument("--window_block_indexes", default=None, type=int, nargs="+")
    p.add_argument("--position_embedding", default="sine", choices=("sine", "learned"))
    p.add_argument("--grad_checkpointing", action="store_true",
                   help="recompute encoder blocks in the backward")
    p.add_argument("--shard_opt_state", action="store_true",
                   help="ZeRO-1 with more than one process: the AdamW moments and the EMA of "
                        "each large leaf are kept as one slice a process")
    p.add_argument("--out_feature_indexes", default=[-1], type=int, nargs="+")
    # transformer
    p.add_argument("--dec_layers", default=3, type=int)
    p.add_argument("--dim_feedforward", default=2048, type=int)
    p.add_argument("--hidden_dim", default=256, type=int)
    p.add_argument("--sa_nheads", default=8, type=int)
    p.add_argument("--ca_nheads", default=8, type=int)
    p.add_argument("--num_queries", default=300, type=int)
    p.add_argument("--group_detr", default=13, type=int)
    p.add_argument("--two_stage", action="store_true")
    p.add_argument("--projector_scale", default=["P4"], type=str, nargs="+",
                   choices=("P3", "P4", "P5", "P6"))
    p.add_argument("--lite_refpoint_refine", action="store_true")
    p.add_argument("--num_select", default=100, type=int)
    p.add_argument("--dec_n_points", default=4, type=int)
    p.add_argument("--decoder_norm", default="LN", type=str)
    p.add_argument("--bbox_reparam", action="store_true")
    # matcher / losses
    p.add_argument("--set_cost_class", default=2, type=float)
    p.add_argument("--set_cost_bbox", default=5, type=float)
    p.add_argument("--set_cost_giou", default=2, type=float)
    p.add_argument("--cls_loss_coef", default=2, type=float)
    p.add_argument("--bbox_loss_coef", default=5, type=float)
    p.add_argument("--giou_loss_coef", default=2, type=float)
    p.add_argument("--focal_alpha", default=0.25, type=float)
    p.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    p.add_argument("--sum_group_losses", action="store_true")
    p.add_argument("--use_varifocal_loss", action="store_true")
    p.add_argument("--use_position_supervised_loss", action="store_true")
    p.add_argument("--ia_bce_loss", action="store_true")
    # data
    p.add_argument("--dataset_file", default="coco")
    p.add_argument("--coco_path", type=str)
    p.add_argument("--square_resize_div_64", action="store_true")
    p.add_argument("--per_image_scales", action="store_true",
                   help="sample the square train size per image and pad the batch to its max "
                        "with a mask (the reference recipe)")
    # run control
    p.add_argument("--output_dir", default="output")
    p.add_argument("--checkpoint_interval", default=10, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--resume", default="", type=str,
                   help="a reference .pth, the port's checkpoint file or directory, or the JAX "
                        "CLI's orbax checkpoint directory (<output_dir>/ckpt or one step of it)")
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--fp16_eval", action="store_true",
                   help="half-precision eval: bfloat16 compute, float32 parameters (the "
                        "reference's engine.py:96-97 runs model.half())")
    p.add_argument("--sync_bn", action="store_true",
                   help="accepted for the JAX CLI's flag set (reference main.py:207-208): the "
                        "projector's train-mode BatchNorm statistics always span the global "
                        "batch, so this is always on")
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--ema_decay", default=0.9997, type=float)
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    p.add_argument("--max_gt", default=100, type=int)
    p.add_argument("--dont_bench", action="store_true",
                   help="skip the startup self-benchmark (parameters, GFLOPs by class and "
                        "stage, latency at 640 and batch 1; utils/benchmark.py), which rank 0 "
                        "runs by default")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--world_size", default=1, type=int,
                   help="accepted for the JAX CLI's flag set: the process count comes from the "
                        "launch's environment (WORLD_SIZE / SLURM_NTASKS / NUM_PROCESSES)")
    p.add_argument("--dist_url", default="env://", type=str,
                   help="accepted for the JAX CLI's flag set: the rendezvous comes from the "
                        "launch's environment (MASTER_ADDR / MASTER_PORT or "
                        "COORDINATOR_ADDRESS)")
    # subcommands
    sub = p.add_subparsers(title="sub-commands", dest="subcommand")
    pe = sub.add_parser("export_model", help="export the bf16 eval forward + post_process "
                        "with torch.export (deploy/export.py)")
    pe.add_argument("--shape", type=int, nargs=2, default=(640, 640))
    pe.add_argument("--infer_dir", type=str, default=None)
    pe.add_argument("--batch", type=int, default=1)
    pe.add_argument("--dry-run", "--test", "-t", dest="dry_run", action="store_true")
    return p


def config_from_args(args):
    from lwdetr_tpu_torch.config import (Config, DataConfig, ModelConfig, TrainConfig,
                                         release_config)

    if args.preset:
        cfg = release_config(args.preset)
        # CLI data flags still apply, and the train flags given on the command line
        flags = set(getattr(args, "flags_given", ()))
        given = {f.name: getattr(args, f.name) for f in dataclasses.fields(TrainConfig)
                 if f.name in flags}
        cfg = dataclasses.replace(cfg, output_dir=args.output_dir,
                                  train=dataclasses.replace(cfg.train, **given),
                                  data=dataclasses.replace(
            cfg.data, coco_path=args.coco_path or "", dataset_file=args.dataset_file,
            num_workers=args.num_workers))
        # presets encode COCO's 91 classes; o365 needs the 366-way head
        if args.dataset_file == "o365":
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, num_classes=366))
        return cfg

    num_classes = 91 if args.dataset_file == "coco" else (
        366 if args.dataset_file == "o365" else 20)
    model = ModelConfig(
        encoder=args.encoder,
        vit_encoder_num_layers=args.vit_encoder_num_layers,
        window_block_indexes=tuple(args.window_block_indexes or ()),
        out_feature_indexes=tuple(args.out_feature_indexes),
        position_embedding=args.position_embedding,
        drop_path=args.drop_path,
        dropout=args.dropout,
        grad_checkpointing=args.grad_checkpointing,
        projector_scale=tuple(args.projector_scale),
        dec_layers=args.dec_layers,
        dim_feedforward=args.dim_feedforward,
        hidden_dim=args.hidden_dim,
        sa_nheads=args.sa_nheads,
        ca_nheads=args.ca_nheads,
        num_queries=args.num_queries,
        group_detr=args.group_detr,
        two_stage=args.two_stage,
        lite_refpoint_refine=args.lite_refpoint_refine,
        dec_n_points=args.dec_n_points,
        decoder_norm=args.decoder_norm,
        bbox_reparam=args.bbox_reparam,
        aux_loss=args.aux_loss,
        num_classes=num_classes,
        num_select=args.num_select,
    )
    train = TrainConfig(
        lr=args.lr, lr_encoder=args.lr_encoder, batch_size=args.batch_size,
        weight_decay=args.weight_decay, epochs=args.epochs, lr_drop=args.lr_drop,
        clip_max_norm=args.clip_max_norm,
        lr_vit_layer_decay=args.lr_vit_layer_decay,
        lr_component_decay=args.lr_component_decay,
        drop_mode=args.drop_mode, drop_schedule=args.drop_schedule,
        cutoff_epoch=args.cutoff_epoch,
        set_cost_class=args.set_cost_class, set_cost_bbox=args.set_cost_bbox,
        set_cost_giou=args.set_cost_giou,
        cls_loss_coef=args.cls_loss_coef, bbox_loss_coef=args.bbox_loss_coef,
        giou_loss_coef=args.giou_loss_coef, focal_alpha=args.focal_alpha,
        sum_group_losses=args.sum_group_losses,
        use_varifocal_loss=args.use_varifocal_loss,
        use_position_supervised_loss=args.use_position_supervised_loss,
        ia_bce_loss=args.ia_bce_loss,
        use_ema=args.use_ema, ema_decay=args.ema_decay,
        seed=args.seed, max_gt=args.max_gt,
    )
    data = DataConfig(
        dataset_file=args.dataset_file, coco_path=args.coco_path or "",
        square_resize_div_64=args.square_resize_div_64,
        per_image_scales=args.per_image_scales,
        num_workers=args.num_workers)
    return Config(model=model, train=train, data=data, output_dir=args.output_dir)


def main(args) -> dict:
    """Trains, or with `--eval` evaluates. Returns {"stats": the last eval's
    stats, "ema_stats": its EMA's or None}, and in training also "state" (the
    `TrainState`) and "epochs" (the epochs run). `export_model` returns
    {"path": the artifact's}."""
    from lwdetr_tpu_torch.data.coco import build_dataset
    from lwdetr_tpu_torch.data.loader import DetectionLoader
    from lwdetr_tpu_torch.models.criterion import SetCriterion
    from lwdetr_tpu_torch.models.lwdetr import resolve_device
    from lwdetr_tpu_torch.parallel import dist as pdist

    # f32 stays f32: no TF32 in the GEMMs or the projector's convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.subcommand == "export_model":
        return export_model(args)

    # a multi-process launch from the environment (root main.py:265-269); one
    # process starts no group
    rank, world = pdist.init_distributed(args.device)
    pdist.setup_print_for_distributed()
    device = resolve_device(pdist.local_device(args.device) if world > 1 else args.device)
    if world > 1:
        print(f"distributed: process {rank}/{world}, backend {pdist.backend()}, "
              f"device {device}")
    cfg = config_from_args(args)
    mcfg, tcfg, dcfg = cfg.model, cfg.train, cfg.data
    print(f"config: {mcfg}")
    # fail fast on bad weight paths
    for flag, path in (("--pretrained_encoder", args.pretrained_encoder),
                       ("--pretrain_weights", args.pretrain_weights),
                       ("--resume", args.resume)):
        if path and not os.path.exists(path):
            raise FileNotFoundError(f"{flag}: no such file: {path}")
    if tcfg.batch_size < 1:
        raise ValueError(f"--batch_size {tcfg.batch_size}: each process needs a batch of at "
                         "least 1")

    torch.manual_seed(tcfg.seed)
    np.random.seed(tcfg.seed)
    # --fp16_eval: half-precision eval compute; bfloat16, with f32 parameters
    half = args.bf16 or args.fp16_eval
    criterion = SetCriterion(mcfg, tcfg)

    # bf16 eval takes bf16 images from the loader: the cast runs on the host,
    # in the loader's thread, and halves the bytes moved to the card
    ds_val = build_dataset("val", dcfg)
    val_loader = DetectionLoader(
        ds_val, batch_size=tcfg.batch_size, train=False, max_gt=tcfg.max_gt,
        square_div_64=dcfg.square_resize_div_64, eval_size=dcfg.eval_square_size,
        num_workers=dcfg.num_workers, image_dtype=torch.bfloat16 if half else None,
        process_index=rank, process_count=world)
    eval_dtype = torch.bfloat16 if half else torch.float32
    if args.eval:
        return _evaluate_only(args, mcfg, tcfg, device, eval_dtype, criterion, ds_val, val_loader)
    return _train(args, cfg, device, eval_dtype, criterion, ds_val, val_loader)


def export_model(args) -> dict:
    """`export_model`: the deploy artifact of `deploy/export.py::export_main`
    ({"path": its path}), or with `--dry-run` only what it would do."""
    from lwdetr_tpu_torch.deploy.export import ARTIFACT, export_main

    if args.dry_run:
        print(f"[dry-run] would export preset={args.preset} shape={tuple(args.shape)} "
              f"batch={args.batch} resume={args.resume!r} device={args.device} -> "
              f"{os.path.join(args.output_dir or 'output', ARTIFACT)}")
        return {"path": None}
    return {"path": export_main(args, config_from_args(args))}


def _load_weights(args, model, use_ema: bool):
    """--pretrained_encoder, then --pretrain_weights (reference main.py:240-259);
    returns the EMA re-seeded from them with `use_ema`, else None."""
    from lwdetr_tpu_torch.train import checkpoint as ckpt

    if args.pretrained_encoder:
        n = ckpt.load_pretrained_encoder(args.pretrained_encoder, model)
        print(f"loaded {n} encoder tensors from {args.pretrained_encoder}")
    if args.pretrain_weights:
        ckpt.load_pretrain_weights(model, args.pretrain_weights, args.pretrain_exclude_keys,
                                   args.pretrain_keys_modify_to_load)
        print(f"loaded pretrain weights from {args.pretrain_weights}")
    if (args.pretrained_encoder or args.pretrain_weights) and use_ema:
        return {k: v.detach().clone() for k, v in model.state_dict().items()}
    return None


def _startup_bench(args, model):
    """The startup self-benchmark on rank 0 unless `--dont_bench` (root
    `main.py:372-374`): the model in its compute dtype, 640 x 640, batch 1."""
    from lwdetr_tpu_torch.parallel.dist import is_main_process
    from lwdetr_tpu_torch.utils.benchmark import benchmark_model

    if is_main_process() and not args.dont_bench:
        benchmark_model(model, image_size=640, batch=1)


def _run_eval(model, mcfg, criterion, ds_val, val_loader, device):
    """`evaluate` of `model` over the val loader; (stats, the evaluator)."""
    from lwdetr_tpu_torch.data.coco_eval import CocoEvaluator
    from lwdetr_tpu_torch.data.loader import to_device
    from lwdetr_tpu_torch.train.engine import build_eval_step, evaluate

    eval_step = build_eval_step(model, mcfg.num_select, criterion=criterion)
    evaluator = CocoEvaluator(ds_val.coco)
    stats = evaluate(eval_step, val_loader, evaluator, put_fn=lambda b: to_device(b, device))
    return stats, evaluator


def _evaluate_only(args, mcfg, tcfg, device, dtype, criterion, ds_val, val_loader) -> dict:
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import checkpoint as ckpt
    from lwdetr_tpu_torch.utils.logging import is_main_process, write_log_line

    # weights: encoder, then pretrain, then resume (reference main.py:240-286);
    # a fresh model's initialisation is drawn only when no resume replaces it
    raw = ckpt.read_checkpoint(args.resume) if args.resume else None
    orbax = ckpt.is_orbax_tree(raw)
    if orbax:
        sd = ckpt.orbax_state_dict(raw, mcfg, where=args.resume)
    else:
        sd = None if raw is None else ckpt.state_dict_of(raw, "model")
    model = build_model(mcfg, device=device, dtype=dtype, state_dict=sd,
                        generator=torch.Generator().manual_seed(tcfg.seed))
    ema = _load_weights(args, model, tcfg.use_ema)
    if orbax:
        # the JAX CLI's orbax train state (root main.py:343-357, :394-399): the
        # model's weights (loaded above), and with --use_ema the EMA's (the
        # model's when it has none)
        ema = (ckpt.orbax_state_dict(raw, mcfg, use_ema=True, where=args.resume)
               if tcfg.use_ema else None)
        print(f"resumed from {args.resume} at step {raw.step}")
    elif args.resume:
        # with --use_ema the EMA weights are the checkpoint's (else None, as before)
        ema, start_epoch = ckpt.resume_pth(model, args.resume, use_ema=tcfg.use_ema, ckpt=raw)
        print(f"resumed model weights from {args.resume}"
              + (f" (epoch {start_epoch - 1})" if start_epoch else ""))
    _startup_bench(args, model)

    stats, _ = _run_eval(model, mcfg, criterion, ds_val, val_loader, device)
    stats_ema = None
    if tcfg.use_ema and ema is not None:
        print("EMA eval:")
        ema_model = build_model(mcfg, device=device, dtype=dtype, state_dict=ema)
        stats_ema, _ = _run_eval(ema_model, mcfg, criterion, ds_val, val_loader, device)
    if args.output_dir and is_main_process():
        record = {f"test_{k}": v for k, v in stats.items()}
        if stats_ema is not None:
            record.update({f"ema_test_{k}": v for k, v in stats_ema.items()})
        write_log_line(args.output_dir, record)
    print(json.dumps(stats))
    return {"stats": stats, "ema_stats": stats_ema}


def _train(args, cfg, device, eval_dtype, criterion, ds_val, val_loader) -> dict:
    """The root `main.py:310-320`, `:343-356` and `:402-497`; one process a card
    (`parallel/`), checkpoints and logs written by rank 0."""
    import datetime
    import signal
    import time

    from lwdetr_tpu_torch.data.coco import build_dataset
    from lwdetr_tpu_torch.data.loader import DetectionLoader, to_device
    from lwdetr_tpu_torch.models.lwdetr import build_model
    from lwdetr_tpu_torch.train import checkpoint as ckpt
    from lwdetr_tpu_torch.train import optim
    from lwdetr_tpu_torch.parallel import dist as pdist
    from lwdetr_tpu_torch.train.engine import (build_train_step, create_train_state,
                                               train_one_epoch)
    from lwdetr_tpu_torch.utils.logging import (BestMetricHolder, is_main_process,
                                                write_log_line)

    mcfg, tcfg, dcfg = cfg.model, cfg.train, cfg.data
    ds_train = build_dataset("train", dcfg)
    train_loader = DetectionLoader(
        ds_train, batch_size=tcfg.batch_size, train=True, max_gt=tcfg.max_gt, seed=tcfg.seed,
        square_div_64=dcfg.square_resize_div_64, per_image_scales=dcfg.per_image_scales,
        num_workers=dcfg.num_workers, process_index=pdist.rank(),
        process_count=pdist.world_size())
    niter_per_ep = len(train_loader)
    if niter_per_ep == 0:
        raise ValueError(f"--batch_size {tcfg.batch_size} per process leaves no whole batch of "
                         f"the {len(ds_train)} train images over {pdist.world_size()} "
                         "processes")
    train_dtype = torch.bfloat16 if args.bf16 else torch.float32
    state = create_train_state(mcfg, tcfg, niter_per_ep, device=device, dtype=train_dtype,
                               shard_opt_state=args.shard_opt_state)
    ema = _load_weights(args, state.model, tcfg.use_ema)
    if ema is not None:  # reference main.py:257-259: EMA re-seeded from the loaded weights
        state.ema = optim.ema_shard(ema, state.shards)
    start_epoch = args.start_epoch
    if args.resume:
        raw = ckpt.read_checkpoint(args.resume)
        if ckpt.is_orbax_tree(raw):
            # the JAX CLI's train state: training goes on from its step
            step = ckpt.restore_orbax_train_state(args.resume, state, mcfg, raw)
            start_epoch = step // max(niter_per_ep, 1)
            print(f"resumed from {args.resume} at step {step}")
        elif ckpt.is_train_state(raw):
            step = ckpt.restore_checkpoint(args.resume, state, raw)
            start_epoch = step // max(niter_per_ep, 1)
            print(f"resumed from {args.resume} at step {step}")
        else:
            # a reference .pth: weights (and EMA) and the epoch; the optimizer
            # and schedule start afresh, as in the JAX CLI
            ema, epoch = ckpt.resume_pth(state.model, args.resume, use_ema=tcfg.use_ema, ckpt=raw)
            if ema is not None:
                state.ema = optim.ema_shard(ema, state.shards)
            if epoch is not None:
                start_epoch = epoch
            print(f"resumed model weights from {args.resume}")
        del raw

    _startup_bench(args, state.model)

    # schedules (reference main.py:296-309)
    dp_sched = optim.drop_scheduler(mcfg.drop_path, tcfg.epochs, niter_per_ep, tcfg.cutoff_epoch,
                                    tcfg.drop_mode, tcfg.drop_schedule)
    do_sched = optim.drop_scheduler(mcfg.dropout, tcfg.epochs, niter_per_ep, tcfg.cutoff_epoch,
                                    tcfg.drop_mode, tcfg.drop_schedule)
    train_step = build_train_step(state, criterion, tcfg,
                                  static_zero_drop_path=bool(np.all(dp_sched == 0)),
                                  static_zero_dropout=bool(np.all(do_sched == 0)))
    # the eval models: the trained model itself when it computes in the eval
    # dtype (else a copy, refreshed before each eval), and one for the EMA weights
    eval_model = (state.model if eval_dtype == train_dtype
                  else build_model(mcfg, device=device, dtype=eval_dtype,
                                   state_dict=state.model.state_dict()))
    ema_model = (build_model(mcfg, device=device, dtype=eval_dtype,
                             state_dict=optim.ema_full(state.ema, state.shards))
                 if tcfg.use_ema else None)
    put = lambda b: to_device(b, device)  # noqa: E731
    out_dir = args.output_dir if is_main_process() else ""

    def save(sub: str, key: int, epoch: int):
        # a ZeRO-1 state is gathered by every process; rank 0 writes
        if args.output_dir and (out_dir or state.shards):
            ckpt.save_checkpoint(os.path.join(args.output_dir, sub), key, state, epoch, args,
                                 keep=ckpt.KEEP[sub])

    # preemption: finish the step in flight, save, exit; resume is step-granular
    preempt = {"sig": None}

    def on_term(signum, frame):
        preempt["sig"] = signum
        print(f"signal {signum}: draining the current step, will save and exit", flush=True)

    def should_stop() -> bool:
        """A signal on any process stops every process after the same step."""
        return pdist.any_process(preempt["sig"] is not None)

    previous = signal.signal(signal.SIGTERM, on_term)
    best = BestMetricHolder(use_ema=tcfg.use_ema)
    stats = stats_ema = None
    epochs = []
    start = time.time()
    try:
        for epoch in range(start_epoch, tcfg.epochs):
            train_loader.set_epoch(epoch)
            train_meters = train_one_epoch(
                train_step, state, train_loader, epoch, niter_per_ep, put_fn=put,
                should_stop=should_stop, drop_path_sched=dp_sched, dropout_sched=do_sched)
            if should_stop():
                save("ckpt", state.step, epoch)
                print(f"preempted (signal {preempt['sig']}): saved at step {state.step}, exiting")
                break
            epochs.append(epoch)
            # the rolling dir is keyed by global step; an extra durable save
            # before the LR drop and every checkpoint_interval epochs
            save("ckpt", state.step, epoch)
            if (epoch + 1) % tcfg.lr_drop == 0 or (epoch + 1) % args.checkpoint_interval == 0:
                save("ckpt_epochs", epoch, epoch)

            if eval_model is not state.model:
                eval_model.load_state_dict(state.model.state_dict())
            stats, evaluator = _run_eval(eval_model, mcfg, criterion, ds_val, val_loader, device)
            if out_dir and getattr(evaluator, "eval", None):
                # precision / recall dump for offline analysis (reference main.py:402-411)
                os.makedirs(os.path.join(out_dir, "eval"), exist_ok=True)
                np.savez(os.path.join(out_dir, "eval", "latest.npz"), epoch=epoch,
                         **evaluator.eval)
            record = {"epoch": epoch, **{f"train_{k}": v for k, v in train_meters.items()},
                      **{f"test_{k}": v for k, v in stats.items()}}
            if best.update(stats["AP"], epoch):
                save("ckpt_best_regular", epoch, epoch)
            if tcfg.use_ema:
                ema_model.load_state_dict(optim.ema_full(state.ema, state.shards), strict=True)
                stats_ema, _ = _run_eval(ema_model, mcfg, criterion, ds_val, val_loader, device)
                record.update({f"ema_test_{k}": v for k, v in stats_ema.items()})
                if best.update(stats_ema["AP"], epoch, is_ema=True):
                    save("ckpt_best_ema", epoch, epoch)
            record.update(best.summary())
            write_log_line(out_dir, record)
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start))}")
    return {"stats": stats, "ema_stats": stats_ema, "state": state, "epochs": epochs}


def flags_given(argv) -> list:
    """The destinations of the flags `argv` gives, whatever their values: every
    destination starts as a marker (argparse sets no default where one is
    set), so only a flag on the command line replaces it."""
    bare = get_args_parser()
    unset = object()
    start = argparse.Namespace(**{dest: unset for dest in vars(bare.parse_args([]))})
    return sorted(dest for dest, value in vars(bare.parse_known_args(argv, start)[0]).items()
                  if value is not unset)


class _Parser(argparse.ArgumentParser):
    """Records in `args.flags_given` the flags the command line gives, so that a
    preset's recipe yields to each of them, at its default value too."""

    def parse_known_args(self, args=None, namespace=None):
        argv = sys.argv[1:] if args is None else list(args)
        parsed, rest = super().parse_known_args(argv, namespace)
        parsed.flags_given = flags_given(argv)
        return parsed, rest


def parser() -> argparse.ArgumentParser:
    return _Parser("LW-DETR PyTorch/CUDA", parents=[get_args_parser()])


if __name__ == "__main__":
    from lwdetr_tpu_torch.parallel.dist import shutdown

    main(parser().parse_args())
    shutdown()
