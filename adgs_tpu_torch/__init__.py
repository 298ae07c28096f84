"""PyTorch/CUDA port of adgs_tpu (object-aware dynamic Gaussian splatting).

The serving path — temporal deformation, EWA preprocess, tile binning,
compositing and the environment-map sky —, the training step — the same
render with its backward, every loss, per-group Adam and the
densification statistics —, the trainer and its entry point cli.train
(densify and prune, the KNN refresh, capacity growth, evaluation,
checkpoints) and the evaluation entry point cli.render (checkpoint and
scene loading, metrics) run on an NVIDIA Hopper card through ten
hand-written CUDA kernels (csrc/), each with a plain PyTorch twin that
the CPU tests hold against the JAX package.

The package imports neither JAX nor adgs_tpu.
"""

from ._device import resolve_device  # noqa: F401  (sets the TF32 guard)
