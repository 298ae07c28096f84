"""The control of `correct`: the plain reference put in the program's place
and computed in TF32 (the nearest precision below the configuration's
float32 with TF32 off; every matrix product's operands rounded to TF32 by
hand, reference/tf32.py), judged by the same numbers against the float32
reference. Its numbers must fail the cell's limits. In a training cell it
takes the first stretch of checked steps, from the seed (the step after
the window starts from the program's own state, which the control does
not have).

    python3 -m port_bench.control --workload <cell> --seeds 1 2 3

prints one JSON line per seed with the control's numbers beside the
limits. Runs on the card (the cells' sizes need one).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness, judge


def train_numbers(spec, traffic, seed, dev, steps) -> dict:
    from .reference import train_ref
    ref = train_ref.follow(spec, traffic, seed, dev, steps)
    low = train_ref.follow(spec, traffic, seed, dev, steps, tf32=True)
    def bare(stretches):
        return [{k: v for k, v in x.items() if k != "images"}
                for x in stretches]

    return dict(judge.train(low, ref), readings=dict(
        control=bare(low), reference=bare(ref),
        image_gaps=[judge.image_gaps(a["images"], b["images"])
                    for a, b in zip(low, ref)]))


def render_numbers(spec, traffic, seed, dev) -> dict:
    from .drivers.render import sample, traffic_views
    from .reference import render_ref
    views = traffic_views(spec, traffic, seed)
    picked = [views[i % len(views)] for i in sample(traffic, seed)]
    ref = render_ref.render(spec, traffic, seed, dev, picked)
    low = render_ref.render(spec, traffic, seed, dev, picked, tf32=True)
    return judge.render(low, ref)


def numbers(workload: str, seed: int, dev) -> dict:
    """The control's numbers for one seed of a cell, at its own size."""
    cell, spec, traffic = harness.cell_files(workload)
    if traffic["driver"] == "train":
        return train_numbers(spec, traffic, seed, dev,
                             int(traffic["check_steps"]))
    return render_numbers(spec, traffic, seed, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a card", file=sys.stderr)
        return 3
    limits = harness.cell_files(args.workload)[0]["limits"]
    for seed in args.seeds:
        got = numbers(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": any(got[k] > limits[k] for k in limits
                                       if k in got)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
