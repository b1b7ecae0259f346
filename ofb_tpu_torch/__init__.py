"""ofb_tpu_torch: Once-for-Both in PyTorch with hand-written CUDA kernels
for Hopper (H100), ported module by module from the JAX package `ofb_tpu`,
which stays the reference.

Entry points take `device=` and default to "cuda"; without a card they
raise rather than fall back to the CPU (pass device="cpu" explicitly).
Under `torchrun` the CLIs and steps run data parallel over
torch.distributed (`parallel/`).
"""

from .device import resolve_device

__all__ = ["create_model", "list_models", "resolve_device"]


def create_model(name, **kwargs):
    """The registry's `create_model` (a `ModelBundle`; `device=` defaults
    to "cuda"), imported on first use."""
    from .models.registry import create_model as _cm
    return _cm(name, **kwargs)


def list_models():
    from .models.registry import list_models as _lm
    return _lm()
