"""Typed configuration of the search and finetune stages.

Port of ofb_tpu/config.py (the reference CLI surface as dataclasses).
`SearchConfig.resolve` and `FinetuneConfig.resolve` fill absolute learning
rates from base rates: lr = blr * eff_batch / 256.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class OptimFamilyConfig:
    """One optimizer family (param / arch / decoder)."""

    lr: Optional[float] = None          # absolute lr; derived from blr if None
    blr: float = 2.5e-4                 # base lr (scaled by eff_batch/256)
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1e-3


@dataclass
class ScheduleConfig:
    """Per-iteration schedule with a linear warmup prefix (timm
    CosineLRScheduler semantics for 'cosine')."""

    sched: str = "cosine"               # cosine | tanh | step | plateau | constant
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    warmup_epochs: int = 20
    decay_epochs: float = 30.0          # for 'step'
    decay_rate: float = 0.1
    cooldown_epochs: int = 10


@dataclass
class AugmentConfig:
    """Training augmentation settings (timm create_transform usage)."""

    color_jitter: float = 0.4
    auto_augment: str = "rand-m9-mstd0.5-inc1"
    train_interpolation: str = "bicubic"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    scale: Tuple[float, float] = (0.08, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)


@dataclass
class MixupConfig:
    """Mixup/CutMix; off during search. `label_smoothing` is the CE
    smoothing of the search phase."""

    mixup: float = 0.0
    cutmix: float = 0.0
    cutmix_minmax: Optional[Tuple[float, float]] = None
    prob: float = 1.0
    switch_prob: float = 0.5
    mode: str = "batch"
    label_smoothing: float = 0.1


@dataclass
class DistillationConfig:
    """Teacher distillation settings."""

    teacher_model: str = "regnety_160"
    teacher_path: str = ""
    distillation_type: str = "none"     # none | soft | hard
    alpha: float = 0.5
    tau: float = 1.0


@dataclass
class DataConfig:
    data_path: str = ""
    data_set: str = "IMNET"
    input_size: int = 224
    num_workers: int = 10
    repeated_aug: bool = True
    batch_size: int = 128               # per-process micro batch
    synthetic_num_classes: int = 1000
    synthetic_size: int = 2048


@dataclass
class SearchConfig:
    """The search CLI's knobs, typed."""

    # run shape
    model: str = "deit_small_patch16_224_mim"
    epochs: int = 100
    accum_iter: int = 2
    fuse_point: int = 50
    seed: int = 0
    start_epoch: int = 0
    output_dir: str = "runs/test"

    # model regularization
    drop: float = 0.0
    drop_path: float = 0.1
    mask_ratio: float = 1.0
    mae: bool = True
    norm_pix_loss: bool = True

    # search-space toggles
    attn_search: bool = True
    mlp_search: bool = True
    embed_search: bool = True
    patch_search: bool = False
    head_search: bool = False
    channel_search: bool = False
    freeze_weights: bool = False

    # loss weights
    w_head: float = 0.5
    w_mlp: float = 0.5
    w_patch: float = 0.0
    w_embedding: float = 0.5
    w_flops: float = 5.0
    w_decoder: float = 1.0
    target_flops: float = 1.0           # GFLOPs

    # sparsity-loss terms
    progressive: bool = True
    entropy: bool = True
    var: bool = True
    norm: bool = True

    # PMIM keep-ratio anneal
    max_ratio: float = 0.95
    min_ratio: float = 0.75

    # compress cadence
    compress_per_epoch: int = 3
    compress_thresh: float = 0.2

    # optimizer families
    optim_param: OptimFamilyConfig = field(default_factory=OptimFamilyConfig)
    optim_arch: OptimFamilyConfig = field(
        default_factory=lambda: OptimFamilyConfig(betas=(0.5, 0.999)))
    optim_decoder: OptimFamilyConfig = field(default_factory=OptimFamilyConfig)
    clip_grad: Optional[float] = None
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)

    # EMA (off by default for search)
    model_ema: bool = False
    model_ema_decay: float = 0.99996

    # data / aug
    data: DataConfig = field(default_factory=DataConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    mixup: MixupConfig = field(default_factory=MixupConfig)
    distillation: DistillationConfig = field(default_factory=DistillationConfig)

    # resume
    resume: bool = False
    checkpoint: str = ""
    pretrained_path: str = ""

    compute_dtype: str = "bfloat16"
    log_every: int = 10

    def resolve(self, world_size: int = 1) -> "SearchConfig":
        """Fill derived lrs: lr = blr * eff_batch / 256."""
        eff_batch = self.data.batch_size * self.accum_iter * world_size
        out = dataclasses.replace(self)
        for name in ("optim_param", "optim_arch", "optim_decoder"):
            fam: OptimFamilyConfig = getattr(out, name)
            if fam.lr is None:
                setattr(out, name,
                        dataclasses.replace(fam, lr=fam.blr * eff_batch / 256))
        return out


@dataclass
class FinetuneConfig:
    """The finetune CLI's knobs, typed."""

    model: str = "deit_small_patch16_224_finetune"
    epochs: int = 300
    accum_iter: int = 1
    seed: int = 0
    start_epoch: int = 0
    output_dir: str = "runs/finetune"
    finetune: str = ""                  # path to searched best/fused checkpoint

    drop: float = 0.0
    drop_path: float = 0.1

    blr: float = 1.5e-4
    lr: Optional[float] = None
    layer_decay: float = 0.95
    weight_decay: float = 0.05
    eps: float = 1e-8
    betas: Tuple[float, float] = (0.9, 0.999)
    clip_grad: Optional[float] = None
    schedule: ScheduleConfig = field(
        default_factory=lambda: ScheduleConfig(warmup_epochs=5, min_lr=1e-6))

    model_ema: bool = True
    model_ema_decay: float = 0.99996

    data: DataConfig = field(default_factory=DataConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    mixup: MixupConfig = field(
        default_factory=lambda: MixupConfig(mixup=0.8, cutmix=1.0))
    distillation: DistillationConfig = field(default_factory=DistillationConfig)

    resume: bool = False
    checkpoint: str = ""

    compute_dtype: str = "bfloat16"
    mesh_shape: Optional[Tuple[int, ...]] = None
    log_every: int = 10

    def resolve(self, world_size: int = 1) -> "FinetuneConfig":
        eff_batch = self.data.batch_size * self.accum_iter * world_size
        out = dataclasses.replace(self)
        if out.lr is None:
            out.lr = out.blr * eff_batch / 256
        return out
