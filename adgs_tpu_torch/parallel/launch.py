"""Local rank launcher: start N processes on this host, one per rank,
joined through a FileStore rendezvous, and fail as a whole if any rank
fails.

Two uses:
  - `spawn_module(module, argv, world)`: N copies of `python -m module
    argv` (cli.train starts its own ranks this way when no launcher did);
  - `call_ranks("pkg.mod:fn", world, kwargs)`: fn(**kwargs) in each rank,
    through `python -m adgs_tpu_torch.parallel.launch`; returns the
    ranks' return values (the tests, chip_smoke.py and bench_scaling run
    their rank bodies this way).

Each rank gets RANK, WORLD_SIZE, LOCAL_RANK and ADGS_DIST_INIT (a file://
rendezvous in a fresh directory) in its environment; mesh.py's
initialize_multihost reads them. A rank that exits non-zero, or a run
that outlasts `timeout`, stops every rank and raises with the failing
rank's last output: no rank's failure is swallowed.
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import INIT_ENV

REPO = Path(__file__).resolve().parents[2]


def _rank_env(rank: int, world: int, init: str, extra: Optional[dict]):
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    env[INIT_ENV] = init
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = str(REPO) + (os.pathsep + path if path else "")
    env.update(extra or {})
    return env


def _tail(path: Path, n: int = 40) -> str:
    try:
        return "\n".join(path.read_text(errors="replace").splitlines()[-n:])
    except OSError:
        return "<no output>"


def run_ranks(cmds: list, workdir: Path, timeout: Optional[float] = None,
              env: Optional[dict] = None, capture: bool = True) -> None:
    """Run one command per rank and wait for all of them. capture: each
    rank's output goes to workdir/rank<r>.log (shown on a failure), else
    to this process's stdout and stderr."""
    world = len(cmds)
    init = f"file://{workdir / 'rendezvous'}"
    procs, logs = [], []
    try:
        for r, cmd in enumerate(cmds):
            log = workdir / f"rank{r}.log"
            out = open(log, "w") if capture else None
            logs.append(log)
            procs.append(subprocess.Popen(
                cmd, env=_rank_env(r, world, init, env), stdout=out,
                stderr=subprocess.STDOUT if capture else None))
            if out is not None:
                out.close()
        t0 = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise RuntimeError(
                    f"rank {r} of {world} exited with {codes[r]}"
                    + (f":\n{_tail(logs[r])}" if capture else ""))
            if all(c == 0 for c in codes):
                return
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(
                    f"ranks still running after {timeout:.0f} s "
                    f"(exit codes {codes})"
                    + (f"; rank 0's output:\n{_tail(logs[0])}"
                       if capture else ""))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def spawn_module(module: str, argv: list, world: int,
                 timeout: Optional[float] = None,
                 env: Optional[dict] = None) -> None:
    """N local ranks of `python -m module argv`, their output shown."""
    workdir = Path(tempfile.mkdtemp(prefix="adgs_ranks_"))
    try:
        run_ranks([[sys.executable, "-m", module] + list(argv)] * world,
                  workdir, timeout, env, capture=False)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def call_ranks(target: str, world: int, kwargs: Optional[dict] = None,
               timeout: Optional[float] = None, env: Optional[dict] = None,
               workdir: Optional[str] = None) -> list:
    """fn(**kwargs) in each of `world` local ranks (target "module:fn");
    returns their return values in rank order (torch.save'd by each rank,
    so tensors come back as they were returned)."""
    own = workdir is None
    wd = Path(tempfile.mkdtemp(prefix="adgs_ranks_") if own else workdir)
    wd.mkdir(parents=True, exist_ok=True)
    try:
        torch.save(kwargs or {}, wd / "kwargs.pt")
        cmd = [sys.executable, "-m", "adgs_tpu_torch.parallel.launch",
               target, str(wd)]
        run_ranks([cmd] * world, wd, timeout, env)
        return [torch.load(wd / f"result{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        if own:
            shutil.rmtree(wd, ignore_errors=True)


def _rank_main(target: str, workdir: str) -> None:
    mod, fn = target.split(":")
    kwargs = torch.load(Path(workdir) / "kwargs.pt", weights_only=False)
    out = getattr(importlib.import_module(mod), fn)(**kwargs)
    if dist.is_initialized():
        dist.destroy_process_group()
    tmp = Path(workdir) / f".result{os.environ['RANK']}.pt"
    torch.save(out, tmp)
    tmp.rename(Path(workdir) / f"result{os.environ['RANK']}.pt")


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
