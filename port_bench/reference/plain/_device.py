"""Device resolution and the f32 precision guard.

Every f32 product in this package runs in full f32: TF32 keeps about three
decimal digits, the Hopper form of the bf16-truncation bug the JAX package
guards against with precision="highest". The flags are set when the
package is imported.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Asking for CUDA without one raises: an entry
    point never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
