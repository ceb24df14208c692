"""PyTorch/CUDA port of the sublinear partition estimation serving path.

Mirrors ``repro``'s sub-paths and public names. Entry points default to
``device="cuda"`` and raise on a machine without a GPU; the CPU is used
only when the caller asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. A CUDA request on a machine
    without a GPU raises instead of quietly moving to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
