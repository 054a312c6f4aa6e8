"""Device choice for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without
a card it raises: the CPU is used only where the caller asks for it, as
the tests do.
"""

from __future__ import annotations

import torch

from .errors import ConfigurationError

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(
            "moose_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ConfigurationError(f"unsupported device {dev}")
    return dev
