"""Where the port's entry points put their tensors.

Every public constructor and entry point that takes `device=None` builds
on the first CUDA device: the port is for the card, and a silent CPU run
would look like a slow card. Without a CUDA device that default raises;
the caller asks for the CPU by passing `device="cpu"` or CPU tensors.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means CUDA, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gpmp2_tpu_torch: no CUDA device; pass device='cpu' (or CPU "
            "tensors) to run the plain PyTorch versions on the CPU")
    return torch.device("cuda")
