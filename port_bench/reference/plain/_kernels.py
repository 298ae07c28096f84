"""Stand-in for the program's kernel loader: the reference runs the plain
twins only, so reaching a kernel wrapper is a fault of the reference."""

from __future__ import annotations

launches: dict = {}


def _refuse(*args, **kwargs):
    raise RuntimeError("the plain reference reached a hand-kernel wrapper; "
                       "it must run with backend='torch'")


require = entry = stream = check = _refuse
