"""Reference `.pth` checkpoints into the port's model.

Counterpart of the `.pth` half of `lwdetr_tpu/train/checkpoint.py`
(`clean_state_dict :230`, `load_pretrained_encoder :265`, `load_pth :312`)
and of `main.py`'s `_load_pretrain` / `_resume_pth`. The port's `LWDETR`
carries the reference's own state_dict keys, so a reference checkpoint needs
no mapping: `torch.load` on the CPU, strip the DDP prefix, load. Save and
restore of a whole train state (model, optimizer, schedule, EMA, step) is
ROADMAP.md § 1 item 4 and is not here.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from lwdetr_tpu_torch.utils.obj365_remap import remap_torch_state_dict

ENCODER_PREFIX = "backbone.0.encoder."


def clean_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Strip DDP 'module.' prefixes (reference util/utils.py:109-115)."""
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def _read(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _state_dict(ckpt, key: str = "model") -> Dict[str, torch.Tensor]:
    sd = ckpt.get(key, ckpt) if isinstance(ckpt, dict) else ckpt
    return clean_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` -> its 'model' state_dict (or the whole file when
    it is a bare state_dict), DDP prefixes stripped, on the CPU."""
    return _state_dict(_read(path))


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


def resume_pth(model: torch.nn.Module, path: str,
               use_ema: bool) -> Tuple[Optional[Dict[str, torch.Tensor]], Optional[int]]:
    """`--resume X.pth` (the JAX CLI's `main.py:529-562 _resume_pth`; the
    reference's main.py:270-286): the model loads the checkpoint's 'model'
    strictly. With `use_ema` the EMA weights come from its 'ema_model' over
    the model's own (entries it lacks keep the model's), or are the model's
    when it has none. Returns (the EMA state_dict or None, the epoch to start
    from, or None). The torch optimizer and schedule states are not read."""
    ckpt = _read(path)
    model.load_state_dict(_state_dict(ckpt, "model"), strict=True)
    ema = None
    if use_ema:
        ema = {k: v.detach().clone() for k, v in model.state_dict().items()}
        if isinstance(ckpt, dict) and "ema_model" in ckpt:
            for k, v in _state_dict(ckpt, "ema_model").items():
                if k in ema and ema[k].shape == v.shape:
                    ema[k] = v.to(ema[k].device, ema[k].dtype)
    start_epoch = None
    if isinstance(ckpt, dict) and "epoch" in ckpt:
        start_epoch = int(ckpt["epoch"]) + 1
    return ema, start_epoch
