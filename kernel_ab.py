#!/usr/bin/env python3
"""B1 and B3 of one tree's PyTorch/CUDA port on chip_smoke.py's inputs:
their outputs, saved so that a later run (of another tree) can be held to
them bit for bit, and their times on the card.

    python3 kernel_ab.py [--root DIR] --save FILE [--against FILE] [--seed 0]

--root DIR imports `adgs_tpu_torch` from DIR (default: this file's
directory), so that one script measures two trees in turns, e.g. a parent
unpacked with `git archive` under build/. The inputs are built by the
chip_smoke.py beside this file, whatever the root, so that both trees see
the same ones (its scene from --seed at full width): the served frame
(request 0), the training step's (its camera, ch=8 rows with the flow
points) and the step's saturated copy (every opacity 0.99, every splat 8x
wider, as chip_smoke.py's B4 exit check). On each: B3 at ch=4 and ch=8 in
both instance layouts (ch=4 reads the first 4 feature columns of the same
rows), the rows layout held bitwise to the gather layout; on the frame's
and the step's binning: B1's key and gid, also at a capacity below
num_rendered (the drop path); the saturated copy shares the step's
binning. --save writes every output (CPU tensors, torch.save); --against
holds each to the same entry of an earlier --save, bit for bit, and exits
1 if one differs. Times: card ms (CUDA events over calls enqueued back to
back) and device ms (torch.profiler, per call) of B1 and of B3 at each
width and layout on the served frame and the step. Needs one CUDA card;
prints one JSON line of results last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path


def log(msg: str) -> None:
    print(msg, flush=True)


def inputs(cs, dev, seed):
    """{name: (settings, binning, packed ch=8 rows, Preprocessed or None)}:
    the served frame, the training step and its saturated copy."""
    cfg, params, state, env, rays, cams = cs.build_scene(
        dev, seed, cs.N_GAUSS, cs.WIDTH, cs.HEIGHT, cs.ENV_RES)
    del env
    reqs = cs.requests(cams, cs.FRAMES)
    train_cam = cams[0].at_time(cs.TRAIN_TIME)
    capacity, _ = cs.size_capacity(cfg, params, state, reqs + [train_cam])
    batch, train_state = cs.train_inputs(dev, seed, params, state, cs.WIDTH,
                                         cs.HEIGHT)
    out = {}
    # the served frame: chip_smoke.kernel_phase's ch=8 rows
    cam = reqs[0]
    st, prep, binning = cs.frame_inputs(cfg, params, state, cam, capacity)
    packed = cs.composite_rows(cfg, params, prep, cam.time + 0.01, 8)
    out["frame"] = (st, binning, packed, prep)
    # the training step's: chip_smoke.step_composite_inputs
    st, binning, packed = cs.step_composite_inputs(cfg, params, train_state,
                                                   train_cam, batch, capacity)
    _, prep, _ = cs.frame_inputs(cfg, params, train_state, train_cam,
                                 capacity)
    out["step"] = (st, binning, packed, prep)
    out["saturated"] = (st, binning, cs.saturated_rows(packed), None)
    return out


def b1_outputs(st, binning, prep):
    """B1's key and gid on a frame's B2 table, at the binning's capacity
    and at half num_rendered (the drop path)."""
    import torch
    from adgs_tpu_torch.raster import binning as bl
    tiles = prep.tiles_touched
    offsets = torch.cumsum(tiles, 0, dtype=torch.int32)
    table, n_live = bl.compact_live(
        offsets - tiles, tiles, prep.rect_min.contiguous(),
        prep.rect_max.contiguous(), bl.quantize_depth(prep.depth,
                                                      st.num_tiles),
        offsets[-1])
    args = (table, n_live, offsets[-1], binning.gauss_id.shape[0], st.grid_x,
            bl.depth_bits_for(st.num_tiles), st.num_tiles)
    drop = args[:3] + (int(offsets[-1]) // 2,) + args[4:]
    return args, bl.expand(*args), bl.expand(*drop)


def b3_args(st, binning, packed, ch, layout):
    from adgs_tpu_torch.raster import render as rl
    src = (rl.build_instances_rows(binning.gauss_id, packed)
           if layout == "rows" else packed)
    return (src, ch, binning.gauss_id, binning.tile_start,
            binning.tile_count, st.grid_x), dict(layout=layout)


def b3_output(args, kw):
    from adgs_tpu_torch.raster import render as rl
    blended, final_t = rl.composite_fwd(*args, **kw)
    return (blended.contiguous(), final_t.contiguous())


def card_and_device(cs, fn, iters):
    return dict(ms=cs.cuda_ms(fn, iters=iters), device_ms=cs.device_ms(fn))


def run_outputs(cs, sets, timed):
    """Every output (name -> CPU tensor) and, where `timed`, the times."""
    import torch
    from adgs_tpu_torch.raster import binning as bl
    outs, t = {}, {}
    for name, (st, binning, packed, prep) in sets.items():
        if prep is not None:
            args, (key, gid), (dkey, dgid) = b1_outputs(st, binning, prep)
            outs[f"B1 {name} key"], outs[f"B1 {name} gid"] = key, gid
            outs[f"B1 {name} drop key"] = dkey
            outs[f"B1 {name} drop gid"] = dgid
            if timed:
                t[f"B1 {name}"] = card_and_device(
                    cs, lambda: bl.expand(*args), 20)
        for ch in (4, 8):
            got = {}
            for layout in ("gather", "rows"):
                a, kw = b3_args(st, binning, packed, ch, layout)
                got[layout] = b3_output(a, kw)
                if timed and name != "saturated":
                    t[f"B3 {name} ch={ch} {layout}"] = card_and_device(
                        cs, lambda: b3_output(a, kw), 20)
                del a
            same = all(torch.equal(x, y) for x, y in zip(got["gather"],
                                                          got["rows"]))
            log(f"  B3 {name} ch={ch}: rows layout vs gather layout "
                f"{'bitwise equal' if same else 'DIFFER'}")
            if not same:
                raise AssertionError("B3 rows layout differs from gather")
            outs[f"B3 {name} ch={ch} blended"] = got["gather"][0]
            outs[f"B3 {name} ch={ch} final_t"] = got["gather"][1]
    return {k: v.cpu() for k, v in outs.items()}, t


def compare(outs, want) -> list:
    """Names of the outputs that differ from `want`, each logged."""
    import torch
    differ = []
    for k in sorted(set(outs) | set(want)):
        a, b = outs.get(k), want.get(k)
        if a is None or b is None:
            log(f"  {k}: missing in {'this run' if a is None else 'the file'}")
            differ.append(k)
            continue
        if a.shape == b.shape and torch.equal(a, b):
            log(f"  {k}: bitwise equal ({a.numel()} elements)")
            continue
        n = (int((a != b).sum()) if a.shape == b.shape else -1)
        log(f"  {k}: DIFFER ({n} elements of {a.numel()})")
        differ.append(k)
    return differ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).parent)
    ap.add_argument("--save", type=Path, required=True)
    ap.add_argument("--against", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from adgs_tpu_torch import _kernels
    log(f"# kernel_ab: package {Path(_kernels.__file__).parent}, card "
        f"{torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    _kernels.build_all()
    sets = inputs(cs, dev, args.seed)
    outs, t = run_outputs(cs, sets, timed=True)
    args.save.parent.mkdir(parents=True, exist_ok=True)
    torch.save(outs, args.save)
    log(f"# saved {len(outs)} outputs to {args.save}")
    for k, v in t.items():
        log(f"# {k}: card {v['ms']:.4f} ms, device {cs.fmt_ms(v['device_ms'])}"
            " ms")
    result = dict(root=str(args.root), times=t)
    differ = []
    if args.against is not None:
        log(f"# against {args.against}")
        differ = compare(outs, torch.load(args.against))
        result["differ"] = differ
    print(json.dumps(result))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
