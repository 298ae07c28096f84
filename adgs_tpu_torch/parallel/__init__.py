"""Multi-device execution over torch.distributed: the mesh, tile-sharded
rendering and training, camera-batch data parallelism (counterpart of
adgs_tpu/parallel).

One process per device ("rank"); image tiles are sharded across the
mesh's "tile" axis, each rank rasterizes its tile-row slab, and the
parameter gradients of every rank's share cross the ranks as one
all-reduce (NCCL between cards, gloo for CPU ranks and ranks sharing a
card). launch.py starts local ranks; torchrun does across nodes.
"""

from .mesh import make_mesh  # noqa: F401
from .shard import make_sharded_train_step, sharded_render_color  # noqa: F401
