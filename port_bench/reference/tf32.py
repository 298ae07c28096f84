"""The precision of the plain reference: float32 with TF32 off, or, for the
control, TF32.

TF32 here is explicit: every matrix product of the reference takes its
operands rounded to TF32's 10-bit mantissa (round to nearest, ties to
even), and the gradient that flows back into each operand is rounded
alike, as the card's tensor cores take a product's inputs with TF32 on.
The library's own TF32 switches are set as well. Rounding by hand makes
the control the same on every seed and every shape: cuBLAS takes a TF32
kernel for some shapes and not for others, and the reference's products
are small.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

# the reference's matrix products, by the name of the torch function
PRODUCTS = frozenset(("matmul", "__matmul__", "__rmatmul__", "mm", "bmm",
                      "einsum", "linear"))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) with the 13 low bits of its mantissa rounded away."""
    b = x.contiguous().view(torch.int32)
    b = (b + (0x0FFF + ((b >> 13) & 1))) & ~0x1FFF
    return b.view(torch.float32)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g) if g.dtype == torch.float32 else g


def _rounded(a):
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return _Rounded.apply(a)
    if isinstance(a, (list, tuple)):
        return type(a)(_rounded(x) for x in a)
    return a


class _TF32Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in PRODUCTS:
            if func.__name__ == "linear":
                # the bias is added in float32, as a TF32 GEMM adds it
                args = (_rounded(args[0]), _rounded(args[1])) + args[2:]
            else:
                args = tuple(_rounded(a) for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(tf32: bool):
    """Inside: float32 with TF32 off, or TF32 products (tf32=True)."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = tf32
    mode = _TF32Products() if tf32 else contextlib.nullcontext()
    try:
        with mode:
            yield
    finally:
        for f, p in zip(flags, prev):
            f.allow_tf32 = p
