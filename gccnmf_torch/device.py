"""Device resolution: the port's entry points run on the card unless the
caller asks for the CPU, and never drop to the CPU on their own."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``. A CUDA device without a usable card raises
    instead of falling back to the CPU; pass ``device="cpu"`` for CPU runs."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: want cuda or cpu")
    return dev
