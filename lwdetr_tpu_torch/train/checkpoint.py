"""Checkpoints: reference `.pth` files into the port's model, and the save
and restore of the whole train state.

Counterpart of `lwdetr_tpu/train/checkpoint.py`: its `.pth` half
(`clean_state_dict :230`, `load_pretrained_encoder :265`, `load_pth :312`,
and `main.py`'s `_load_pretrain` / `_resume_pth`), and its save / restore of
the train state (`save_checkpoint :365`, `restore_checkpoint :377`) with
`torch.save` in place of orbax. The port's `LWDETR` carries the reference's
own state_dict keys, so a reference checkpoint needs no mapping.

A saved train state is one `.pth` in the reference's format: `model` (the
reference's keys, BatchNorm statistics included), `optimizer`,
`lr_scheduler`, `ema_model` (with EMA on), `epoch`, plus `step` and `args`;
the JAX package's `.pth` readers read its `model`. The directories keep the
JAX CLI's layout and retention (`KEEP`), one file a key (`<key>.pth`: the
global step in `ckpt/`, the epoch in the others). A file is written under a
temporary name and renamed, so a run killed mid-write leaves no torn file.
With more than one process rank 0 writes; a ZeRO-1 state's optimizer moments
and EMA are gathered into the unsharded layout first (every process takes
part), and a restore gives each process its slices.

The JAX CLI's own train states, orbax directories (`<output_dir>/ckpt/` or one
`<step>/` of it), are read too, by `train/orbax_read.py` (no JAX, orbax or
tensorstore): `read_checkpoint` returns their tree, `load_orbax_variables` the
model's (or the EMA's) state_dict (the JAX `load_orbax_variables :293`), and
`restore_orbax_train_state` the whole train state (the JAX CLI's
`restore_checkpoint` on `--resume`): weights, BatchNorm statistics, EMA, the
AdamW moments and step from optax's Adam state, the schedule's position and
the step. The port writes no orbax directory.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from lwdetr_tpu_torch.config import ModelConfig
from lwdetr_tpu_torch.parallel.dist import is_main_process
from lwdetr_tpu_torch.train import orbax_read
from lwdetr_tpu_torch.train.optim import ema_full, optimizer_param_names
from lwdetr_tpu_torch.utils.obj365_remap import remap_torch_state_dict
from lwdetr_tpu_torch.weights import (jax_tree_mismatch, param_tensors_from_jax,
                                      state_dict_from_jax)

ENCODER_PREFIX = "backbone.0.encoder."


# the reference registers the shared box head of its iterative refinement
# twice (`transformer.decoder.bbox_embed` is `bbox_embed`); the port, as the
# JAX package's mapping, keeps it once, under `bbox_embed.`
SHARED_HEAD_ALIAS = "transformer.decoder.bbox_embed."


def clean_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DDP 'module.' prefixes (reference util/utils.py:109-115), and
    the second copy of the shared box head (`SHARED_HEAD_ALIAS`), which the
    model reads from `bbox_embed.*`."""
    sd = {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}
    return {k: v for k, v in sd.items() if not k.startswith(SHARED_HEAD_ALIAS)}


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def read_checkpoint(path: str):
    """A checkpoint file, or a directory's latest, loaded on the CPU; for a JAX
    CLI orbax directory (a `<step>/` holding `_CHECKPOINT_METADATA`, or a
    directory of them) the tree of its latest step (`orbax_read.Restored`)."""
    if orbax_read.is_orbax_checkpoint(path):
        return orbax_read.restore(path)
    return _read(checkpoint_file(path))


def is_orbax_tree(ckpt) -> bool:
    """Whether a loaded checkpoint is a JAX CLI orbax train state."""
    return isinstance(ckpt, orbax_read.Restored)


def state_dict_of(ckpt, key: str = "model") -> Dict[str, torch.Tensor]:
    """A loaded checkpoint's `key` entry (the whole file when it is a bare
    state_dict), DDP prefixes stripped."""
    sd = ckpt.get(key, ckpt) if isinstance(ckpt, dict) else ckpt
    return clean_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` -> its 'model' state_dict (or the whole file when
    it is a bare state_dict), DDP prefixes stripped, on the CPU."""
    return state_dict_of(_read(path))


def load_matching(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> int:
    """Load the entries of `sd` that `model` has, at the same shape (the
    reference's `load_state_dict(strict=False)`, which the JAX package's
    `_merge` mirrors by skipping a shape that differs); returns how many."""
    own = model.state_dict()
    matched = {k: v for k, v in sd.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(matched, strict=False)
    return len(matched)


def load_pretrained_encoder(path: str, model: torch.nn.Module) -> int:
    """A CAE-pretrained ViT checkpoint into the encoder (reference
    backbone.py:77-85: `torch.load(...)['model']`, the 'encoder.' key prefix
    stripped, `load_state_dict(strict=False)`); returns the tensors loaded."""
    ckpt = _read(path)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = {ENCODER_PREFIX + (k[len("encoder."):] if k.startswith("encoder.") else k):
          torch.as_tensor(v) for k, v in sd.items()}
    return load_matching(model, sd)


def load_pretrain_weights(model: torch.nn.Module, path: str,
                          exclude_keys: Optional[Iterable[str]] = None,
                          keys_modify_to_load: Optional[Iterable[str]] = None) -> int:
    """`--pretrain_weights` (reference main.py:240-259): the checkpoint's
    model, without `exclude_keys`, with the Objects365 -> COCO classifier
    rows remapped on `keys_modify_to_load`, loaded non-strictly."""
    sd = load_pth(path)
    for k in exclude_keys or []:
        sd.pop(k, None)
    if keys_modify_to_load:
        cur = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
        remapped = remap_torch_state_dict(cur, {k: v.numpy() for k, v in sd.items()},
                                          keys_modify_to_load)
        sd = {k: torch.as_tensor(v) for k, v in remapped.items()}
    return load_matching(model, sd)


def resume_pth(model: torch.nn.Module, path: str, use_ema: bool,
               ckpt: Optional[dict] = None) -> Tuple[Optional[Dict[str, torch.Tensor]],
                                                     Optional[int]]:
    """`--resume X.pth` (the JAX CLI's `main.py:529-562 _resume_pth`; the
    reference's main.py:270-286): the model loads the checkpoint's 'model'
    strictly. With `use_ema` the EMA weights come from its 'ema_model' over
    the model's own (entries it lacks keep the model's), or are the model's
    when it has none. Returns (the EMA state_dict or None, the epoch to start
    from, or None). The optimizer and schedule states are not read (a saved
    train state restores them: `restore_checkpoint`). `path` may be a
    checkpoint directory: its latest file (`ckpt`: that file already loaded)."""
    if ckpt is None:
        ckpt = read_checkpoint(path)
    model.load_state_dict(state_dict_of(ckpt, "model"), strict=True)
    ema = None
    if use_ema:
        ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if isinstance(ckpt, dict) and "ema_model" in ckpt:
            for k, v in state_dict_of(ckpt, "ema_model").items():
                if k in ema and ema[k].shape == v.shape:
                    ema[k] = v.to(ema[k].device, ema[k].dtype)
    start_epoch = None
    if isinstance(ckpt, dict) and "epoch" in ckpt:
        start_epoch = int(ckpt["epoch"]) + 1
    return ema, start_epoch


# retention a directory (None: keep all), as the JAX CLI's managers keep them
KEEP = {"ckpt": 3, "ckpt_epochs": None, "ckpt_best_regular": 1, "ckpt_best_ema": 1}


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def checkpoint_keys(ckpt_dir: str) -> List[int]:
    """The keys of the `<key>.pth` files in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    names = [n[:-4] for n in os.listdir(ckpt_dir) if n.endswith(".pth")]
    return sorted(int(n) for n in names if n.isdigit())


def checkpoint_file(path: str) -> str:
    """A checkpoint file as given, a directory's latest (highest key), or the
    latest step directory of a JAX CLI orbax directory."""
    if not os.path.isdir(path):
        return path
    if orbax_read.is_orbax_checkpoint(path):
        return orbax_read.step_directory(path)[0]
    keys = checkpoint_keys(path)
    if not keys:
        raise FileNotFoundError(f"no checkpoint under {path}")
    return os.path.join(path, f"{keys[-1]}.pth")


def _payload(state, epoch: int, args=None) -> dict:
    """The train state as the reference's `.pth` dict, on the CPU (a ZeRO-1
    state gathered: every process calls this)."""
    payload = {"model": _to_cpu(state.model.state_dict()),
               "optimizer": _to_cpu(state.optimizer.state_dict()),
               "lr_scheduler": state.scheduler.state_dict(),
               "epoch": int(epoch), "step": int(state.step),
               "args": dict(vars(args)) if args is not None else None}
    if state.ema is not None:
        payload["ema_model"] = _to_cpu(ema_full(state.ema, state.shards))
    return payload


def save_checkpoint(ckpt_dir: str, key: int, state, epoch: int, args=None,
                    keep: Optional[int] = 3) -> str:
    """Writes `ckpt_dir/<key>.pth` (temporary name, then rename) and removes
    the oldest files past `keep` (None keeps all); returns the path. Every
    process of a ZeRO-1 state calls it; only rank 0 writes."""
    path = os.path.join(ckpt_dir, f"{int(key)}.pth")
    payload = _payload(state, epoch, args)
    if not is_main_process():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if keep is not None:
        for old in checkpoint_keys(ckpt_dir)[:-keep]:
            os.remove(os.path.join(ckpt_dir, f"{old}.pth"))
    return path


def is_train_state(ckpt) -> bool:
    """Whether a loaded `.pth` is a saved train state (not only weights)."""
    return isinstance(ckpt, dict) and "optimizer" in ckpt and "step" in ckpt


@torch.no_grad()
def restore_checkpoint(path: str, state, ckpt: Optional[dict] = None) -> int:
    """Restores `state` in place from a train-state file, or a directory's
    latest (`ckpt`: that file already loaded): model (strictly, BatchNorm
    statistics included), optimizer moments, the schedule, EMA (the model's
    weights when the file has none) and `state.step`; a ZeRO-1 state takes its
    slices of the moments and the EMA. Returns the step."""
    if ckpt is None:
        ckpt = read_checkpoint(path)
    if not is_train_state(ckpt):
        raise ValueError(f"{path} holds no train state (no optimizer / step)")
    state.model.load_state_dict(state_dict_of(ckpt, "model"), strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["lr_scheduler"])
    if state.ema is not None:
        _load_ema(state, ckpt.get("ema_model") or state.model.state_dict())
    state.step = int(ckpt["step"])
    return state.step


def _load_ema(state, src: Dict[str, torch.Tensor]) -> None:
    """The whole EMA state_dict `src` into `state.ema`, a ZeRO-1 state's slices."""
    for k, v in state.ema.items():
        full = src[k]
        if state.shards and k in state.shards:
            start, stop, _ = state.shards[k]
            full = full.reshape(-1)[start:stop]
        v.copy_(full)


# ---- the JAX CLI's orbax train states ----------------------------------------------------------


def _tree_check(tree: dict, cfg: ModelConfig, where: str) -> None:
    """Raises unless `tree` ({"params", "batch_stats"}) is `cfg`'s model's."""
    for coll in ("params", "batch_stats"):
        bad = jax_tree_mismatch(tree.get(coll) or {}, cfg, coll)
        if bad:
            raise ValueError(f"{where}: the tree does not match the model the flags build: {bad}")


def orbax_state_dict(tree: dict, cfg: ModelConfig, use_ema: bool = False,
                     where: str = "orbax checkpoint") -> Dict[str, torch.Tensor]:
    """The model's state_dict from a restored orbax train state: its `params`
    and `batch_stats`, or with `use_ema` its EMA's when it has one."""
    src = tree["ema"] if use_ema and tree.get("ema") else tree
    _tree_check(src, cfg, where + (" (EMA)" if src is not tree else ""))
    return state_dict_from_jax(src["params"], src.get("batch_stats") or {}, cfg)


def load_orbax_variables(path: str, cfg: ModelConfig, use_ema: bool = False,
                         tree: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The inference weights of a JAX CLI orbax directory's latest step, as a
    state_dict the model loads strictly: the model's, or with `use_ema` the
    EMA's when the state has one (`lwdetr_tpu/train/checkpoint.py:293`).
    `tree`: that step already restored."""
    tree = orbax_read.restore(path) if tree is None else tree
    return orbax_state_dict(tree, cfg, use_ema, where=path)


def _optax_states(opt_state, where: str):
    """The Adam state ({count, mu, nu}) and the schedule's ({count}) of the
    JAX optimizer's chain (`lwdetr_tpu/train/optim.py:117-121`: clip, then
    `scale_by_adam`, then `scale_by_param_lr_wd`)."""
    chain = opt_state if isinstance(opt_state, list) else [opt_state]
    adam = [s for s in chain if isinstance(s, dict) and set(s) == {"count", "mu", "nu"}]
    sched = [s for s in chain if isinstance(s, dict) and set(s) == {"count"}]
    if len(adam) != 1 or len(sched) != 1:
        shape = [sorted(s) if isinstance(s, dict) else s for s in chain]
        raise ValueError(f"{where}: opt_state {shape} is not the JAX optimizer's chain (an Adam "
                         "state {count, mu, nu} and a schedule state {count})")
    return adam[0], sched[0]


@torch.no_grad()
def restore_orbax_train_state(path: str, state, cfg: ModelConfig,
                              tree: Optional[dict] = None) -> int:
    """Restores `state` in place from a JAX CLI orbax directory's latest step
    (`tree`: already restored), as the JAX CLI's `--resume` restores its
    `TrainState` (`main.py:343-357`): the model strictly, BatchNorm statistics
    included; the EMA (the model's weights when the state has none); AdamW's
    `exp_avg` / `exp_avg_sq` from Adam's `mu` / `nu` through the weights'
    layout changes and its `step` from Adam's `count`; the schedule's position
    from the last transform's `count`; and `state.step`. A ZeRO-1 state takes
    its slices. Returns the step."""
    tree = orbax_read.restore(path) if tree is None else tree
    for key in ("params", "opt_state", "step"):
        if key not in tree:
            raise ValueError(f"{path}: no {key!r} in the tree: not a JAX CLI train state")
    state.model.load_state_dict(orbax_state_dict(tree, cfg, where=path), strict=True)
    if state.ema is not None:
        _load_ema(state, orbax_state_dict(tree, cfg, use_ema=True, where=path))
    adam, sched = _optax_states(tree["opt_state"], path)
    for name in ("mu", "nu"):
        bad = jax_tree_mismatch(adam[name], cfg, "params")
        if bad:
            raise ValueError(f"{path}: Adam's {name} does not match the model: {bad}")
    mu, nu = param_tensors_from_jax(adam["mu"], cfg), param_tensors_from_jax(adam["nu"], cfg)
    count = int(adam["count"])
    groups = torch.optim.Optimizer.state_dict(state.optimizer)["param_groups"]
    names = optimizer_param_names(state.optimizer, state.model)
    state.optimizer.load_state_dict({
        "state": {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in enumerate(names)},
        "param_groups": groups})
    position = int(sched["count"])
    sd = state.scheduler.state_dict()
    lrs = [base * fn(position) for base, fn in zip(state.scheduler.base_lrs,
                                                    state.scheduler.lr_lambdas)]
    sd.update(last_epoch=position, _step_count=position + 1, _last_lr=lrs)
    state.scheduler.load_state_dict(sd)
    for g, lr in zip(state.optimizer.param_groups, lrs):
        g["lr"] = lr
    state.step = int(tree["step"])
    return state.step
