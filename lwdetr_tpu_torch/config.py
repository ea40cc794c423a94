"""Model and train configuration and the five release presets.

The port keeps its own copy of the JAX package's `ModelConfig`, `TrainConfig`
and presets (`lwdetr_tpu/config.py`): the flag sets of the reference's
`scripts/lwdetr_*_coco_train.sh`, with the data config and the whole-run
`Config` that bundles the three.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (reference main.py 'Model'/'Transformer' flags)."""

    # Encoder (backbone)
    encoder: str = "vit_tiny"  # vit_tiny | vit_small | vit_base
    vit_encoder_num_layers: int = 12
    window_block_indexes: Tuple[int, ...] = ()
    out_feature_indexes: Tuple[int, ...] = (-1,)
    position_embedding: str = "sine"  # sine | learned
    drop_path: float = 0.0
    dropout: float = 0.0
    grad_checkpointing: bool = False

    # Projector
    projector_scale: Tuple[str, ...] = ("P4",)  # subset of P3 P4 P5 P6, ascending

    # Decoder / transformer
    dec_layers: int = 3
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    sa_nheads: int = 8
    ca_nheads: int = 8
    num_queries: int = 300
    group_detr: int = 13
    two_stage: bool = False
    lite_refpoint_refine: bool = False
    dec_n_points: int = 4
    decoder_norm: str = "LN"  # LN | Identity
    bbox_reparam: bool = False
    aux_loss: bool = True

    # Detection head
    num_classes: int = 91  # COCO: max_obj_id + 1
    num_select: int = 100

    @property
    def num_feature_levels(self) -> int:
        return len(self.projector_scale)

    @property
    def embed_dim(self) -> int:
        return {"vit_tiny": 192, "vit_small": 384, "vit_base": 768}.get(self.encoder, 0)

    @property
    def num_heads(self) -> int:
        # ViT attention heads (reference backbone.py: always 12)
        return 12


@dataclass(frozen=True)
class TrainConfig:
    """Optimization hyper-parameters (reference main.py argparse)."""

    lr: float = 1e-4
    lr_encoder: float = 1.5e-4
    batch_size: int = 2  # per device
    weight_decay: float = 1e-4
    epochs: int = 12
    lr_drop: int = 11
    clip_max_norm: float = 0.1
    lr_vit_layer_decay: float = 0.8
    lr_component_decay: float = 1.0

    # drop scheduler
    drop_mode: str = "standard"  # standard | early | late
    drop_schedule: str = "constant"  # constant | linear
    cutoff_epoch: int = 0

    # matcher costs
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0

    # loss coefficients
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    focal_alpha: float = 0.25
    sum_group_losses: bool = False
    use_varifocal_loss: bool = False
    use_position_supervised_loss: bool = False
    ia_bce_loss: bool = False

    # EMA
    use_ema: bool = False
    ema_decay: float = 0.9997

    seed: int = 42
    # targets are padded to this many boxes per image
    max_gt: int = 100


@dataclass(frozen=True)
class DataConfig:
    dataset_file: str = "coco"  # coco | o365
    coco_path: str = ""
    square_resize_div_64: bool = False
    # sample the square train size per image and pad the batch to its max with
    # a pad_mask (the reference recipe); the default samples one size a batch
    per_image_scales: bool = False
    num_workers: int = 2
    eval_square_size: int = 640


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    output_dir: str = "output"
    # parameters are always float32; the compute dtype is configurable
    compute_dtype: str = "float32"  # float32 | bfloat16

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _release_train_defaults(**kw) -> TrainConfig:
    """Flag set shared by all scripts/lwdetr_*_coco_train.sh."""
    base = dict(
        lr=1e-4,
        lr_encoder=1.5e-4,
        weight_decay=1e-4,
        epochs=60,
        lr_drop=60,
        lr_vit_layer_decay=0.8,
        lr_component_decay=0.7,
        ia_bce_loss=True,
        cls_loss_coef=1.0,
        use_ema=True,
        batch_size=4,
    )
    base.update(kw)
    return TrainConfig(**base)


def _release_model_defaults(**kw) -> ModelConfig:
    base = dict(
        dec_layers=3,
        group_detr=13,
        two_stage=True,
        bbox_reparam=True,
        lite_refpoint_refine=True,
        aux_loss=True,
    )
    base.update(kw)
    return ModelConfig(**base)


_WINDOWED = dict(
    vit_encoder_num_layers=10,
    window_block_indexes=(0, 1, 3, 6, 7, 9),
    out_feature_indexes=(2, 4, 5, 9),
)

# Release presets: reference scripts/lwdetr_{size}_coco_train.sh
PRESETS = {
    "tiny": _release_model_defaults(
        encoder="vit_tiny", vit_encoder_num_layers=6,
        window_block_indexes=(0, 2, 4), out_feature_indexes=(1, 3, 5),
        projector_scale=("P4",), hidden_dim=256, sa_nheads=8, ca_nheads=16,
        dec_n_points=2, num_queries=100, num_select=100),
    "small": _release_model_defaults(
        encoder="vit_tiny", **_WINDOWED,
        projector_scale=("P4",), hidden_dim=256, sa_nheads=8, ca_nheads=16,
        dec_n_points=2, num_queries=300, num_select=300),
    "medium": _release_model_defaults(
        encoder="vit_small", **_WINDOWED,
        projector_scale=("P4",), hidden_dim=256, sa_nheads=8, ca_nheads=16,
        dec_n_points=2, num_queries=300, num_select=300),
    "large": _release_model_defaults(
        encoder="vit_small", **_WINDOWED,
        projector_scale=("P3", "P5"), hidden_dim=384, sa_nheads=12,
        ca_nheads=24, dec_n_points=4, num_queries=300, num_select=300,
        drop_path=0.1),
    "xlarge": _release_model_defaults(
        encoder="vit_base", **_WINDOWED,
        projector_scale=("P3", "P5"), hidden_dim=384, sa_nheads=12,
        ca_nheads=24, dec_n_points=4, num_queries=300, num_select=300,
        drop_path=0.1),
}


TRAIN_PRESETS = {
    "tiny": _release_train_defaults(),
    "small": _release_train_defaults(),
    "medium": _release_train_defaults(lr_vit_layer_decay=0.7),
    "large": _release_train_defaults(lr_vit_layer_decay=0.7, lr_component_decay=0.5,
                                     batch_size=2),
    "xlarge": _release_train_defaults(lr_vit_layer_decay=0.75, lr_component_decay=0.5,
                                      weight_decay=1e-3, batch_size=2),
}


def get_train_config(name: str, **overrides) -> TrainConfig:
    cfg = TRAIN_PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_config(name: str, **overrides) -> ModelConfig:
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def release_config(name: str) -> Config:
    """The whole release recipe of preset `name`: its model and train
    configs and the `square_resize_div_64` data recipe every preset uses."""
    return Config(model=PRESETS[name], train=TRAIN_PRESETS[name],
                  data=DataConfig(square_resize_div_64=True))
