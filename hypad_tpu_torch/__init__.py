"""HypAD in PyTorch and CUDA for NVIDIA Hopper (H100).

A port of ``hypad_tpu`` (JAX/Pallas) that keeps its module layout and
names. The hyperbolic one-call detector runs end to end on the card, with
the fused MobiusLinear forward and the KDE argmax as hand-written CUDA
kernels (``csrc/``, built with ``nvcc`` on first use and bound through
ctypes).

Every public entry point takes ``device="cuda"`` by default and raises when
CUDA is unavailable; pass ``device="cpu"`` explicitly to run the kernels'
plain PyTorch versions on the host. Importing this package needs neither a
GPU, ``nvcc`` nor ``triton``.
"""

from hypad_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
