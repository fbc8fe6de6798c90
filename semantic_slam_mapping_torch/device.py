"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device with no card raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev
