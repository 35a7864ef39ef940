"""Device selection shared by every public entry point."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``, a bare "cuda" resolved to the
    current card. A CUDA device without CUDA raises: the port never drops
    quietly to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the host")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
