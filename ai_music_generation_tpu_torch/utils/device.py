"""The device an entry point runs on, and IEEE fp32 products on it."""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def ieee_fp32():
    """IEEE fp32 products inside the block: cuDNN's convolutions without
    TF32 (on by default in PyTorch) and float32 matmuls at "highest",
    whatever the process set; both restored on exit."""
    cudnn = torch.backends.cudnn
    matmul = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.set_float32_matmul_precision(matmul)
