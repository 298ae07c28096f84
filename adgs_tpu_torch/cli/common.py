"""Shared CLI plumbing (counterpart of adgs_tpu/cli/common.py): the
three-tier config system of the reference (arguments/__init__.py):
dataclass defaults < python-module config file (-c) < explicit
command-line flags. A cfg_args.json saved by either package loads here.

ADGS_RM=1 in the environment selects the compositor's "rows" instance
layout, as it does for the JAX package; `layout_from_env` is the one place
that reads it, for both entry points (cli.train and cli.render).

The renderer knobs of ModelConfig keep the JAX package's names and
values, so a saved config means the same in both packages:
  - `backend`: under "xla" and "reference" the entry point runs inside
    `_kernels.plain()` (the plain twins, on the card too); "auto" and
    "pallas" leave the choice to `_kernels.use` (the hand-written kernels
    on the card);
  - `max_per_tile` and `chunk` bound the JAX compositor's per-tile window;
    the port's compositor has no such bound, so they are read and unused.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
from typing import Optional

from .. import _kernels
from ..train.config import OptimizationConfig

# ModelConfig.backend -> whether the entry point runs under _kernels.plain()
_PLAIN = {"auto": False, "pallas": False, "xla": True, "reference": True}


@dataclasses.dataclass
class ModelConfig:
    """ModelParams parity (arguments/__init__.py:50-84)."""

    source_path: str = ""
    model_path: str = ""
    sh_degree: int = 3
    resolution: int = 1
    white_background: bool = False
    eval: bool = True
    split_mode: str = "nvs-75"
    use_colmap: bool = True
    default_order_downsample_ratio: int = 3
    num_cam: Optional[int] = None
    env_resolution: int = 8192
    inv_depth: bool = True

    # renderer/runtime knobs (module docstring)
    backend: str = "auto"
    capacity: int = 1 << 19
    max_per_tile: int = 4096
    chunk: int = 64
    # multi-device training: a "tile" mesh of `devices` ranks (tile-row
    # sharding; primitive_exchange routes the primitives by exchange, else
    # by all-gather), and a "data" axis of batch_cameras cameras a step;
    # B * max(devices, 1) ranks in all (cli/train.py starts them)
    devices: int = 0
    primitive_exchange: bool = True
    batch_cameras: int = 1

    order_args: Optional[dict] = None


def layout_from_env() -> str:
    """The compositor's instance layout named by ADGS_RM (as the JAX
    package reads it: an integer, nonzero for the row-major layout)."""
    return "rows" if int(os.environ.get("ADGS_RM", "0")) else "gather"


def backend_context(name: str):
    """The context an entry point runs in for ModelConfig.backend
    (module docstring)."""
    if name not in _PLAIN:
        raise ValueError(f"unknown backend: {name}")
    return _kernels.plain() if _PLAIN[name] else contextlib.nullcontext()


def load_config_module(path: str) -> dict:
    """get_config (arguments/__init__.py:159-167)."""
    spec = importlib.util.spec_from_file_location("_adgs_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {k: getattr(mod, k) for k in dir(mod) if not k.startswith("__")}


def add_dataclass_args(parser: argparse.ArgumentParser, dc,
                       skip: tuple = ()) -> None:
    existing = {a.dest for a in parser._actions}
    for f in dataclasses.fields(dc):
        if f.name == "order_args" or f.name in skip or f.name in existing:
            continue
        if isinstance(f.default, bool):
            # --flag / --no_flag both exist so a True dataclass default
            # stays overridable from the command line
            parser.add_argument(f"--{f.name}", default=None,
                                action=argparse.BooleanOptionalAction)
        else:
            cast = type(f.default) if f.default is not None else str
            if f.default is None:
                cast = int if f.name == "num_cam" else str
            # None = "not set on the command line"
            parser.add_argument(f"--{f.name}", default=None, type=cast)


def merge(dc, config_dict: Optional[dict], args: argparse.Namespace):
    values = dataclasses.asdict(dc) if dataclasses.is_dataclass(dc) else dict(dc)
    names = set(values.keys())
    if config_dict:
        for k, v in config_dict.items():
            if k in names:
                values[k] = v
    for k, v in vars(args).items():
        if k in names and v is not None:
            values[k] = v
    return type(dc)(**values)


def save_cfg_args(model_path: str, model_cfg: ModelConfig,
                  opt_cfg: OptimizationConfig) -> None:
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump({"model": dataclasses.asdict(model_cfg),
                   "opt": dataclasses.asdict(opt_cfg)}, f, indent=1)


def load_cfg_args(model_path: str):
    with open(os.path.join(model_path, "cfg_args.json")) as f:
        d = json.load(f)
    return ModelConfig(**d["model"]), OptimizationConfig(**d["opt"])
