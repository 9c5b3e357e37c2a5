"""Small helpers shared by the port's modules."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["to_2tuple", "resolve_device"]


def to_2tuple(x) -> Tuple[int, int]:
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    first CUDA card. Without a card and without an explicit device this
    raises rather than carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --device cpu) "
            "to run on the CPU"
        )
    return torch.device("cuda")
