"""Device selection and the float32 parity numerics of the port.

cuDNN runs float32 convolutions in TF32 by default, which keeps about
three decimal digits; the port is held to the JAX package's float32
results, so both TF32 switches are turned off on every path.
"""

from __future__ import annotations

import torch

__all__ = ["set_parity_numerics", "resolve_device"]


def set_parity_numerics():
    """Full float32 for cuDNN convolutions and cuBLAS matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current card, by its index
    (``cuda:N``, so that every tensor, pinned copy and stream names the
    same card when a process or a replica owns one), unless the caller
    names another ("cuda" alone also means the current card). With no
    device given and no card present this raises;
    it never falls back to the CPU on its own."""
    set_parity_numerics()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' explicitly to "
                "run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
