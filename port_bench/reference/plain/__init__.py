"""A frozen copy of the plain tier of adgs_tpu_torch (deform, preprocess,
binning, compositing, sky, losses, Adam, the device KNN groups), taken
when this benchmark was written and never updated with the program.

Only the "torch" backend is ever selected here, so no hand kernel runs:
`_kernels` is a stub that raises if a kernel wrapper is reached. The
modules keep the port's layout and relative imports so that each can be
read beside the file it was copied from; none imports the program.
"""

from ._device import resolve_device  # noqa: F401  (sets the TF32 guard)
