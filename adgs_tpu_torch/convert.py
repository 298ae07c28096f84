"""Weights carried across from numpy arrays (e.g. `np.asarray` of each leaf
of the JAX package's GaussianParams / GaussianState / EnvironmentMap),
keyed by the dataclass field names."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .models.env_map import EnvironmentMap
from .models.gaussians import GaussianParams, GaussianState


def _build(cls, arrays: dict, device):
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(cls)]
    missing = sorted(set(names) - set(arrays))
    extra = sorted(set(arrays) - set(names))
    if missing or extra:
        raise KeyError(f"{cls.__name__}: missing {missing}, unexpected {extra}")
    return cls(**{n: torch.as_tensor(np.array(arrays[n]), device=dev)
                  for n in names})


def params_from_numpy(arrays: dict[str, np.ndarray],
                      device=None) -> GaussianParams:
    return _build(GaussianParams, arrays, device)


def state_from_numpy(arrays: dict[str, np.ndarray],
                     device=None) -> GaussianState:
    return _build(GaussianState, arrays, device)


def env_from_numpy(grid: np.ndarray, device=None) -> EnvironmentMap:
    return EnvironmentMap(grid=torch.as_tensor(np.array(grid, np.float32),
                                               device=resolve_device(device)))


def to_numpy(obj) -> dict[str, np.ndarray]:
    """The inverse: a dataclass of tensors -> {field name: numpy array}."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
