"""Optimization hyper-parameters (counterpart of adgs_tpu/train/config.py),
field for field, so one configuration drives both packages."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 60_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 60_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 200
    opacity_reset_interval: int = 10_000
    densify_from_iter: int = 0
    densify_until_iter: int = 30_000
    densify_scene_grad_threshold: float = 0.0002
    densify_obj_grad_threshold: float = 0.0002
    data_sample: str = "stack"

    position_deform_lr_scale: float = 0.2
    obj_position_lr_scale: float = 0.8
    object_extent: float = 10.0
    min_camera_extent: float = 10.0
    scene_position_lr_scale: float = 1.0

    rotation_deform_lr: float = 0.001
    shs_deform_lr: float = 0.0025
    env_lr: float = 1e-3
    gs_time_sigma_lr: float = 1e-2
    near_idx_reset_interval: int = 10
    near_num: int = 8

    lambda_l1: float = 1.0
    lambda_depth: float = 0.1
    lambda_flow: float = 0.1
    lambda_obj: float = 0.1
    lambda_sky: float = 0.05
    lambda_sigma: float = 0.01
    lambda_reg: float = 0.5
    lambda_sigma_reg: float = 0.5

    min_opacity: float = 0.005
