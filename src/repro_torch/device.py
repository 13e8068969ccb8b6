"""Device resolution: every entry point takes an explicit ``device``."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE
                   ) -> torch.device:
    """Return ``device`` as a ``torch.device``.

    A CUDA device that is not available raises: the port never moves a
    run to the CPU on its own. Callers that want the CPU ask for it
    (``device="cpu"``), as the tests do."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
