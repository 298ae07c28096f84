"""Weights and training inputs carried across from numpy arrays (e.g.
`np.asarray` of each leaf of the JAX package's GaussianParams /
GaussianState / EnvironmentMap / AdamState / FrameBatch), keyed by the
field names, and the optimization config from a dict of its fields."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .models.env_map import EnvironmentMap
from .models.gaussians import GaussianParams, GaussianState
from .ops.flow import FlowPackage
from .train.config import OptimizationConfig
from .train.losses import FrameBatch
from .train.optim import AdamState, TrainableState


def _check_keys(cls, names, given) -> None:
    missing = sorted(set(names) - set(given))
    extra = sorted(set(given) - set(names))
    if missing or extra:
        raise KeyError(f"{cls.__name__}: missing {missing}, "
                       f"unexpected {extra}")


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev)


def _build(cls, arrays: dict, device):
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    _check_keys(cls, names, arrays)
    return cls(**{n: _tensor(arrays[n], dev) for n in names})


def params_from_numpy(arrays: dict[str, np.ndarray],
                      device=None) -> GaussianParams:
    return _build(GaussianParams, arrays, device)


def state_from_numpy(arrays: dict[str, np.ndarray],
                     device=None) -> GaussianState:
    return _build(GaussianState, arrays, device)


def env_from_numpy(grid: np.ndarray, device=None) -> EnvironmentMap:
    return EnvironmentMap(grid=torch.as_tensor(np.array(grid, np.float32),
                                               device=resolve_device(device)))


def trainables_from_numpy(gaussians: dict[str, np.ndarray], grid: np.ndarray,
                          device=None) -> TrainableState:
    return TrainableState(gaussians=params_from_numpy(gaussians, device),
                          env=env_from_numpy(grid, device))


def adam_from_numpy(m_gaussians: dict[str, np.ndarray], m_grid: np.ndarray,
                    v_gaussians: dict[str, np.ndarray], v_grid: np.ndarray,
                    count: int, device=None) -> AdamState:
    """Moments (Gaussian leaves by field name, and the sky grid's) and the
    step count of an Adam state."""
    return AdamState(m=trainables_from_numpy(m_gaussians, m_grid, device),
                     v=trainables_from_numpy(v_gaussians, v_grid, device),
                     count=torch.tensor(int(count), dtype=torch.int32))


def flow_from_numpy(arrays: dict[str, np.ndarray], device=None) -> FlowPackage:
    dev = resolve_device(device)
    _check_keys(FlowPackage, FlowPackage._fields, arrays)
    return FlowPackage(**{n: _tensor(arrays[n], dev)
                          for n in FlowPackage._fields})


def batch_from_numpy(arrays: dict, device=None) -> FrameBatch:
    """A FrameBatch from its fields: "flow" is None or a dict of
    FlowPackage fields, "flow_valid" None or a bool."""
    dev = resolve_device(device)
    arrays = {"flow": None, "flow_valid": None, **arrays}
    _check_keys(FrameBatch, FrameBatch._fields, arrays)
    flow = arrays["flow"]
    valid = arrays["flow_valid"]
    return FrameBatch(
        image=_tensor(arrays["image"], dev),
        depth=_tensor(arrays["depth"], dev), sky=_tensor(arrays["sky"], dev),
        semantic=_tensor(arrays["semantic"], dev),
        flow=None if flow is None else flow_from_numpy(flow, dev),
        flow_valid=None if valid is None else torch.tensor(bool(valid),
                                                           device=dev))


def opt_config_from_dict(fields: dict) -> OptimizationConfig:
    """OptimizationConfig from a dict of its fields (e.g.
    dataclasses.asdict of the JAX package's)."""
    names = [f.name for f in dataclasses.fields(OptimizationConfig)]
    _check_keys(OptimizationConfig, names, fields)
    return OptimizationConfig(**fields)


def to_numpy(obj) -> dict[str, np.ndarray]:
    """The inverse: a dataclass or NamedTuple of tensors (e.g.
    GaussianParams, GaussianState, densify's DensifyReport) -> {field
    name: numpy array}."""
    names = (obj._fields if isinstance(obj, tuple)
             else [f.name for f in dataclasses.fields(obj)])
    return {n: getattr(obj, n).detach().cpu().numpy() for n in names}
