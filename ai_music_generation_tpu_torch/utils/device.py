"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str) -> torch.device:
    """The run's device: the card unless ``device`` says ``cpu``; a CUDA
    device without a card raises (no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device=cpu to run on the "
            "CPU")
    return device
