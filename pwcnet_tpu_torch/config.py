"""Config tree of the port: the JAX package's dataclasses (counterpart of
``pwcnet_tpu/config.py``, which imports JAX through ``data.augment`` and so
cannot be imported here) and its PWC-Net presets.

Field names and defaults are the JAX package's, so a config reads the same
in both. ``apply_overrides`` applies the CLI's ``section.field=value``
overrides with the JAX package's coercions.
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from pwcnet_tpu_torch.train.schedule import S_FINE, S_LONG, ScheduleConfig

__all__ = ["AugmentConfig", "Config", "DataConfig", "ModelConfig",
           "ParallelConfig", "PRESETS", "S_FINE", "S_LONG", "ScheduleConfig",
           "TrainConfig", "apply_overrides"]


@dataclass(frozen=True)
class AugmentConfig:
    """Fields of ``pwcnet_tpu/data/augment.py:AugmentConfig``: the training
    augmentation (``data/augment.py``), whose ``crop_hw`` is also the size
    of device-generated synthetic batches."""
    crop_hw: Tuple[int, int] = (384, 448)
    hflip_prob: float = 0.5
    vflip_prob: float = 0.1
    photometric: bool = True
    brightness: float = 0.2
    contrast: float = 0.4
    gamma: Tuple[float, float] = (0.7, 1.5)
    color: float = 0.3
    noise_std: float = 0.02
    asymmetric_prob: float = 0.2


@dataclass(frozen=True)
class ModelConfig:
    family: str = "pwcnet"            # pwcnet | raft
    raft_iters: int = 12
    raft_radius: int = 4
    num_levels: int = 6
    output_level: int = 4
    search_range: int = 4
    residual: bool = True
    use_norm: bool = False
    input_norm: bool = False
    input_center: bool = False
    corr_backend: str = "pallas"
    stem_backend: str = "auto"
    context_s2b: Any = None
    raft_gru_fuse: Any = None
    flow_scale: float = 20.0
    resize_mode: str = "half_pixel"
    dtype: str = "bfloat16"           # float32 | bfloat16


@dataclass(frozen=True)
class DataConfig:
    name: str = "flyingchairs"
    root: str = "/data/FlyingChairs_release/data"
    crop_hw: Tuple[int, int] = (384, 448)
    sample_hw: Tuple[int, int] = (384, 512)
    eval_batch: int = 4
    num_threads: int = 8
    device_gen: bool = False          # synthetic batches made on the device
    synthetic_regime: str = "smooth"  # smooth | hard
    synthetic_val_length: int = 512
    augment: AugmentConfig = field(default_factory=AugmentConfig)


@dataclass(frozen=True)
class ParallelConfig:
    data: int = -1
    spatial: int = 1
    model: int = 1
    coordinator: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    schedule: ScheduleConfig = field(default_factory=lambda: S_LONG)
    weight_decay: float = 4e-4
    coupled_l2: bool = False          # torch Adam's coupled L2 vs AdamW
    grad_clip: float = 0.0
    loss: str = "multiscale"          # multiscale | robust
    level_weights: Optional[Tuple[float, ...]] = None
    seed: int = 0
    log_dir: str = "runs/default"
    summary_interval: int = 100
    eval_interval: int = 5000
    checkpoint_interval: int = 5000
    max_to_keep: int = 5
    resume: bool = True
    init_from: Optional[str] = None
    eval_limit: Optional[int] = None
    profile_dir: Optional[str] = None
    debug_nans: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


# The JAX package's PWC-Net presets, field for field (``raft-chairs`` comes
# with RAFT, ROADMAP A5). The file presets read the datasets under their
# ``data.root``; the synthetic ones render procedural pairs with exact
# ground truth on the device.
PRESETS = {
    "chairs-1chip": Config(
        train=TrainConfig(global_batch=8, log_dir="runs/chairs"),
    ),
    "chairs-quick": Config(
        train=TrainConfig(
            global_batch=4,
            schedule=ScheduleConfig(base_lr=1e-4, milestones=(800, 900),
                                    total_steps=1000),
            summary_interval=20, eval_interval=200, checkpoint_interval=200,
            eval_limit=64, log_dir="runs/chairs-quick"),
    ),
    "things-ft": Config(
        data=DataConfig(name="flyingthings", root="/data/FlyingThings3D",
                        crop_hw=(384, 768), sample_hw=(540, 960)),
        train=TrainConfig(global_batch=8, schedule=S_FINE, loss="multiscale",
                          log_dir="runs/things-ft"),
    ),
    "sintel-eval": Config(
        data=DataConfig(name="sintel", root="/data/Sintel",
                        sample_hw=(448, 1024)),
        train=TrainConfig(log_dir="runs/sintel-eval"),
    ),
    "synthetic-proof": Config(
        data=DataConfig(name="synthetic", root="-", crop_hw=(384, 448),
                        sample_hw=(384, 448), eval_batch=8, device_gen=True),
        train=TrainConfig(
            global_batch=8,
            schedule=ScheduleConfig(base_lr=1e-4,
                                    milestones=(60_000, 90_000, 110_000),
                                    total_steps=125_000),
            summary_interval=200, eval_interval=2500,
            checkpoint_interval=5000, eval_limit=128,
            log_dir="runs/synthetic-proof"),
    ),
    "synthetic-hard": Config(
        data=DataConfig(name="synthetic", root="-", crop_hw=(384, 448),
                        sample_hw=(384, 448), eval_batch=8, device_gen=True,
                        synthetic_regime="hard"),
        train=TrainConfig(
            global_batch=8,
            schedule=ScheduleConfig(base_lr=1e-4,
                                    milestones=(60_000, 90_000, 110_000),
                                    total_steps=125_000),
            summary_interval=200, eval_interval=2500,
            checkpoint_interval=5000, eval_limit=512,
            log_dir="runs/synthetic-hard"),
    ),
    "kitti-multihost": Config(
        data=DataConfig(name="kitti", root="/data/KITTI2015",
                        crop_hw=(320, 896), sample_hw=(384, 1280)),
        train=TrainConfig(global_batch=16, schedule=S_FINE, loss="robust",
                          log_dir="runs/kitti-ft"),
    ),
}


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """Apply ``section.field=value`` overrides (nested through dots)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        cfg = _set_nested(cfg, key.split("."), val)
    return cfg


def _coerce(current, val: str):
    """``val`` as the type of the field's ``current`` value."""
    if isinstance(current, bool):
        return val.lower() in ("1", "true", "yes")
    if val.lower() in ("none", "null"):
        return None
    if isinstance(current, str):
        return val
    if current is None:
        # No type to go by: lowercase booleans first (literal_eval refuses
        # them, and the string "false" would be truthy), then literals,
        # else the string itself (paths).
        if val.lower() in ("true", "yes"):
            return True
        if val.lower() in ("false", "no"):
            return False
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            return val
    try:
        return type(current)(ast.literal_eval(val))
    except (ValueError, SyntaxError):
        return type(current)(val)


def _set_nested(obj, parts: List[str], val: str):
    name = parts[0]
    if not hasattr(obj, name):
        raise AttributeError(
            f"{type(obj).__name__} has no field {name!r}; have "
            f"{[f.name for f in dataclasses.fields(obj)]}")
    cur = getattr(obj, name)
    new = _coerce(cur, val) if len(parts) == 1 else _set_nested(
        cur, parts[1:], val)
    return dataclasses.replace(obj, **{name: new})
