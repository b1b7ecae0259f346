"""ofb_tpu_torch: Once-for-Both in PyTorch with hand-written CUDA kernels
for Hopper (H100), ported module by module from the JAX package `ofb_tpu`,
which stays the reference.

Entry points take `device=` and default to "cuda"; without a card they
raise rather than fall back to the CPU (pass device="cpu" explicitly).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
