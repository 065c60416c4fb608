"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import argparse
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA on a machine without it raises; nothing falls
    back to the CPU unless the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' to "
            "run the port on the CPU")
    return dev


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    """An entry point's ``--device`` option, ``cuda`` by default."""
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")


def check_on(device: torch.device, tensor: torch.Tensor, what: str) -> None:
    """Raise unless ``tensor`` lives on ``device`` (type and index)."""
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index != device.index):
        raise ValueError(f"{what} lives on {tensor.device}, the engine runs "
                         f"on {device}")
