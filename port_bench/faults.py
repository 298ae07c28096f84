"""Faults planted underneath the timed path, to read what the comparison
that decides `correct` says of them:

- unchanged_state: the training step returns the state it was given;
- frozen_statistics: the training step returns the statistics that
  densify reads (max_radii2d, xyz_grad_accum, denom) as it was given
  them, the rest as it computed it;
- half_batch: the step's losses see only the top half of the frame's
  pixels (the mean is taken over the rest);
- altered_answer: a served image has one pixel altered where it is
  produced.

    python3 -m port_bench.faults --workload <cell> --fault <name>
        --seeds 1 2 3 [--seconds 2]

runs the cell with the fault planted on the card (a short window: the
comparison does not depend on its length) and prints each number beside
its limit. The tests plant the same faults at a toy size on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _half(x, h):
    import torch
    if isinstance(x, torch.Tensor) and x.dim() >= 2 and x.shape[-2] == h:
        return x[..., : h // 2, :]
    return x


@contextlib.contextmanager
def _patched(module, name, value):
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def planted(fault: str):
    if fault == "unchanged_state":
        from adgs_tpu_torch.train import trainer as mod
        make = mod.make_train_step

        def frozen_step(*args, **kwargs):
            inner = make(*args, **kwargs)

            def step(params, env, opt_state, state, *rest, **kw):
                logs = inner(params, env, opt_state, state, *rest, **kw)[4]
                return params, env, opt_state, state, logs
            return step
        with _patched(mod, "make_train_step", frozen_step):
            yield
    elif fault == "frozen_statistics":
        import dataclasses
        from adgs_tpu_torch.train import trainer as mod
        make = mod.make_train_step

        def stale_step(*args, **kwargs):
            inner = make(*args, **kwargs)

            def step(params, env, opt_state, state, *rest, **kw):
                out = inner(params, env, opt_state, state, *rest, **kw)
                kept = dataclasses.replace(
                    out[3], max_radii2d=state.max_radii2d,
                    xyz_grad_accum=state.xyz_grad_accum, denom=state.denom)
                return out[:3] + (kept, out[4])
            return step
        with _patched(mod, "make_train_step", stale_step):
            yield
    elif fault == "half_batch":
        from adgs_tpu_torch.train import step as mod
        losses = mod.compute_losses

        def half_losses(pkg, batch, *args, **kwargs):
            h = batch.image.shape[-2]
            flow = batch.flow
            if flow is not None:
                flow = flow._replace(flow=_half(flow.flow, h),
                                     vis=_half(flow.vis, h))
            batch = batch._replace(
                image=_half(batch.image, h), depth=_half(batch.depth, h),
                sky=_half(batch.sky, h), semantic=_half(batch.semantic, h),
                flow=flow)
            pkg = {k: _half(v, h) for k, v in pkg.items()}
            return losses(pkg, batch, *args, **kwargs)
        with _patched(mod, "compute_losses", half_losses):
            yield
    elif fault == "altered_answer":
        import torch
        from adgs_tpu_torch import render as mod
        make = mod.make_staged_render_fn

        def altered(*args, **kwargs):
            fn = make(*args, **kwargs)

            def serve(*a, **kw):
                out = fn(*a, **kw)
                img = out["render"].clone()
                img[:, 0, 0] = torch.remainder(img[:, 0, 0] + 0.5, 1.0)
                return dict(out, render=img)
            return serve
        with _patched(mod, "make_staged_render_fn", altered):
            yield
    else:
        raise ValueError(f"no such fault: {fault}")


def main(argv=None) -> int:
    import torch
    from . import harness
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the faults are read on a card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        run = harness.Run(args.workload, seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter())
        try:
            with planted(args.fault):
                harness.drive(run)
        finally:
            run.close()
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": run.correct,
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in run.checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
