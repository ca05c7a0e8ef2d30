"""Device resolution of the port's entry points (its kernel bookkeeping is
left out: this copy launches no hand-written kernel)."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """Entry-point device: CUDA unless the caller asks for another device.
    Raises when CUDA is asked for (or defaulted to) and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
