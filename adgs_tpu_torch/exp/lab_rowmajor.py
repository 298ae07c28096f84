"""Row-major instance layout lab (counterpart of exp/lab_rowmajor.py).

    python -m adgs_tpu_torch.exp.lab_rowmajor [--device cpu] [--seed 0]
    (LAB_N Gaussians, default 1,000,000; LAB_R instances, default 2,048,000)

The questions of the JAX lab, asked on this card:
  1. what each way of building the instances costs: the narrow row gather
     plus a transpose to component-major [16, R] (`build_current`), the
     lane pad to [N, 128] plus one wide row gather (`build_wide`), and the
     wide gather sliced and transposed back (`build_wide_cm`);
  2. what a kernel pays to read 256-instance blocks of each layout:
     component-major [16, 256] blocks (kernel E1, `block_sums_cm`) against
     row-major [256, width] blocks, staged and transposed through shared
     memory or read row by row (kernel E2, `block_sums_rm`).
Each kernel program sums the [8, 8] outer products of the first and second
8 values of its instances over `per` chunks of 256; the 1872 programs
cover nprog * per * 256 instances and the rest is never read, as in the
JAX lab. The kernels live in csrc/lab_rowmajor.cu; each has a plain
PyTorch twin here, run on CPU tensors. Times come from CUDA events over
K calls after one warm-up (the JAX lab chains K dispatches and subtracts a
round trip); with --device cpu they are host times of the twins.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F_nn

from .. import _kernels
from .._device import resolve_device

CHUNK = 256
F = 16
K = 10
MAX_PROGRAMS = 1872
HBM_BYTES_S = 3.35e12     # H100 SXM memory rate, for the printed bounds


class Programs(NamedTuple):
    nprog: int
    per: int              # chunks of CHUNK instances per program

    @property
    def covered(self) -> int:
        return self.nprog * self.per * CHUNK


def sizes() -> tuple[int, int]:
    """(N, R): LAB_N Gaussians and LAB_R instances from the environment,
    the JAX lab's defaults otherwise."""
    return (int(os.environ.get("LAB_N", 1_000_000)),
            int(os.environ.get("LAB_R", 2_048_000)))


def programs(r: int) -> Programs:
    """The JAX lab's grid: min(1872, R // 256) programs of R // 256 //
    nprog chunks each."""
    nchunks = r // CHUNK
    nprog = min(MAX_PROGRAMS, nchunks)
    if nprog < 1:
        raise ValueError(f"LAB_R={r} holds no chunk of {CHUNK}")
    return Programs(nprog, nchunks // nprog)


def build_current(packed: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Narrow row gather [R, 16] + transpose -> component-major [16, R]."""
    return packed[gid].t().contiguous()


def build_wide(packed: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Lane pad [N, 128] + one row gather -> row-major [R, 128]."""
    return F_nn.pad(packed, (0, 128 - packed.shape[1]))[gid]


def build_wide_cm(packed: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """The wide gather, sliced and transposed back to [16, R]."""
    return build_wide(packed, gid)[:, :F].t().contiguous()


def _outer_sums(blk: torch.Tensor) -> torch.Tensor:
    """[P, M, 16] -> [P, 8, 8]: out[p, a, b] = sum_m blk[p, m, a] *
    blk[p, m, 8 + b], one elementwise product and sum per a."""
    return torch.stack([(blk[:, :, a:a + 1] * blk[:, :, 8:16]).sum(1)
                        for a in range(8)], dim=1)


def cm_blocks(inst_cm: torch.Tensor, p: Programs) -> torch.Tensor:
    """The covered columns of [16, L] as the programs' [P, per*256, 16]."""
    return (inst_cm[:, :p.covered].reshape(F, p.nprog, p.per * CHUNK)
            .permute(1, 2, 0))


def rm_blocks(inst: torch.Tensor, p: Programs) -> torch.Tensor:
    """The covered rows of [L, width] as the programs' [P, per*256, 16]."""
    return inst[:p.covered, :F].reshape(p.nprog, p.per * CHUNK, F)


def block_sums_cm_torch(inst_cm: torch.Tensor, p: Programs) -> torch.Tensor:
    """Plain twin of kernel E1."""
    return _outer_sums(cm_blocks(inst_cm, p))


def block_sums_rm_torch(inst: torch.Tensor, p: Programs) -> torch.Tensor:
    """Plain twin of kernel E2 (either form)."""
    return _outer_sums(rm_blocks(inst, p))


def _launch(name: str, src: torch.Tensor, mode: int, ld: int,
            p: Programs) -> torch.Tensor:
    _kernels.require(src, "inst", torch.float32)
    out = torch.empty((p.nprog, 8, 8), dtype=torch.float32,
                      device=src.device)
    fn = _kernels.entry(name, "adgs_lab_block_sums", "piqiipp")
    err = fn(src.data_ptr(), mode, ld, p.nprog, p.per, out.data_ptr(),
             _kernels.stream(src))
    _kernels.check(err, name)
    _kernels.launches[name] += 1
    return out


def block_sums_cm(inst_cm: torch.Tensor, p: Programs) -> torch.Tensor:
    """Kernel E1 (component-major [16, L], L >= covered), or its plain
    twin where `_kernels.use` says so."""
    if not _kernels.use(inst_cm):
        return block_sums_cm_torch(inst_cm, p)
    if inst_cm.dim() != 2 or inst_cm.shape[0] != F \
            or inst_cm.shape[1] < p.covered:
        raise ValueError(f"block_sums_cm: [16, >= {p.covered}] expected, "
                         f"got {tuple(inst_cm.shape)}")
    return _launch("lab_cm", inst_cm, 0, inst_cm.shape[1], p)


def block_sums_rm(inst: torch.Tensor, p: Programs,
                  staged: bool = False) -> torch.Tensor:
    """Kernel E2 on a CUDA tensor (row-major [L, width], width 16 or 128,
    L >= covered, rows 16-byte aligned): staged through a two-slot
    shared-memory ring by asynchronous copies and read as [16, 256] (the
    JAX rm_kernel and its two-slot DMA) or read row by row
    (rm_notrans_kernel); or its plain twin where `_kernels.use` says so."""
    if not _kernels.use(inst):
        return block_sums_rm_torch(inst, p)
    if inst.dim() != 2 or inst.shape[1] not in (16, 128) \
            or inst.shape[0] < p.covered:
        raise ValueError(f"block_sums_rm: [>= {p.covered}, 16 or 128] "
                         f"expected, got {tuple(inst.shape)}")
    return _launch("lab_rm", inst, 1 if staged else 2, inst.shape[1], p)


def library_block_sums(blk: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the same sums (a yardstick, used by no path):
    torch.bmm over the programs' [P, per*256, 16] blocks."""
    return torch.bmm(blk[:, :, :8].transpose(1, 2), blk[:, :, 8:16])


def time_ms(fn, device: torch.device, iters: int = K) -> float:
    """Mean ms of fn() over iters calls after one warm-up: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


class Inputs(NamedTuple):
    packed: torch.Tensor   # [N, 16]
    gid: torch.Tensor      # [R + 256] instance -> Gaussian
    inst_cm: torch.Tensor  # [16, R + 256] build_current
    inst_rm: torch.Tensor  # [R + 256, 128] build_wide
    inst_rm16: torch.Tensor  # [R + 256, 16] the narrow gather


def make_inputs(n: int, r: int, rng: np.random.Generator,
                device) -> Inputs:
    """The lab's operands from a numpy generator: N(0,1) packed rows and
    uniform instance -> Gaussian ids (R + 256 of them, as the lab)."""
    packed = torch.as_tensor(rng.standard_normal((n, F), np.float32),
                             device=device)
    gid = torch.as_tensor(rng.integers(0, n, r + CHUNK), device=device)
    return Inputs(packed, gid, build_current(packed, gid),
                  build_wide(packed, gid), packed[gid])


class Variant(NamedTuple):
    label: str             # the JAX lab's line
    kernel: str            # E1 "lab_cm" or E2 "lab_rm"
    form: str              # "cm", "staged" or "direct"
    operand: str           # field of Inputs


VARIANTS = (
    Variant("kernel read component-major [16,CHUNK] blocks", "lab_cm", "cm",
            "inst_cm"),
    Variant("kernel read row-major [CHUNK,128] + in-kernel T", "lab_rm",
            "staged", "inst_rm"),
    Variant("kernel read row-major [CHUNK,128], row-major math", "lab_rm",
            "direct", "inst_rm"),
    Variant("kernel read row-major [CHUNK,16] blocks, rm math", "lab_rm",
            "direct", "inst_rm16"),
)


def run_variant(v: Variant, inp: Inputs, p: Programs) -> torch.Tensor:
    src = getattr(inp, v.operand)
    if v.form == "cm":
        return block_sums_cm(src, p)
    return block_sums_rm(src, p, staged=v.form == "staged")


def twin_variant(v: Variant, inp: Inputs, p: Programs) -> torch.Tensor:
    src = getattr(inp, v.operand)
    if v.form == "cm":
        return block_sums_cm_torch(src, p)
    return block_sums_rm_torch(src, p)


def variant_bytes(p: Programs) -> int:
    """Bytes a block reader must move: the 16 f32 of each covered instance
    read once, the [8, 8] sums written once."""
    return p.covered * F * 4 + p.nprog * 64 * 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, r = sizes()
    p = programs(r)
    where = (f"CUDA events on {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else "host clock, plain twins on the CPU")
    print(f"N={n} R={r} CHUNK={CHUNK}: {p.nprog} programs x {p.per} chunks "
          f"cover {p.covered} rows; ms over {K} calls, {where}", flush=True)

    inp = make_inputs(n, r, np.random.default_rng(args.seed), dev)
    times = {}
    for name, fn in (("current: narrow gather [R,16] + T -> [16,R]",
                      build_current),
                     ("wide: pad [N,128] + row gather (no T)", build_wide),
                     ("wide gather + slice + T -> [16,R]", build_wide_cm)):
        times[name] = time_ms(lambda: fn(inp.packed, inp.gid), dev)
        print(f"{name:56s} {times[name]:9.4f} ms", flush=True)

    nbytes = variant_bytes(p)
    bound = nbytes / HBM_BYTES_S * 1e3
    for v in VARIANTS:
        times[v.label] = time_ms(lambda: run_variant(v, inp, p), dev)
        print(f"{v.label:56s} {times[v.label]:9.4f} ms  "
              f"({nbytes / 1e6:.1f} MB read, bound {bound:.4f} ms)",
              flush=True)
    return times


if __name__ == "__main__":
    main()
