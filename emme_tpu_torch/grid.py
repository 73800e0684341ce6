"""Uniform 1-D field-line grid (reference include/Grid.h:6-20):
npoints nodes on [-length, length], dx = 2*length/(npoints-1)."""
from dataclasses import dataclass
from typing import Any

import torch

from .params import default_device


@dataclass(frozen=True)
class Grid:
    length: Any
    npoints: int
    dx: Any
    eta: Any    # (npoints,) nodes

    @classmethod
    def create(cls, length, npoints: int, dtype=torch.float64, device=None):
        device = default_device(device)   # None: the CUDA card
        length = torch.as_tensor(length, dtype=dtype, device=device)
        dx = 2.0 * length / (npoints - 1)
        eta = -length + dx * torch.arange(npoints, dtype=dtype, device=device)
        return cls(length=length, npoints=npoints, dx=dx, eta=eta)
