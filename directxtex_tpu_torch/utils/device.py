"""Where the port's entry points put their data: on the device the caller
names, else on CUDA; and constants made on the host, copied to a device
once."""

from __future__ import annotations

import torch

__all__ = ["resolve", "constant"]

_CONSTANTS: dict[tuple, torch.Tensor] = {}


def resolve(device) -> torch.device:
    """`device` where the caller names one, else CUDA."""
    return torch.device(device if device is not None else "cuda")


def constant(key, make, device) -> torch.Tensor:
    """The numpy array `make()` as a tensor on `device`, copied there once
    per (key, device), so that later calls copy nothing."""
    k = (key, str(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.from_numpy(make()).to(device)
    return t
