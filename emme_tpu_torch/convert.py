"""Carry parameters and solver state across from plain arrays.

``emme_tpu`` holds its ``Params`` leaves and ``EigenState`` fields as device
arrays; handed over as numpy arrays (``np.asarray(getattr(p, f))``) they
build the port's counterparts here, so both packages can compute from the
same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import DYNAMIC_FIELDS, STATIC_FIELDS, Params
from .solvers.eigen import EigenState


def params_from_arrays(fields: dict, static: dict, dtype=torch.float64,
                       device="cpu") -> Params:
    """``Params`` from its physical scalars ``fields`` (name -> array-like,
    every name of ``DYNAMIC_FIELDS``) and structural settings ``static``
    (name -> value, every name of ``STATIC_FIELDS``)."""
    missing = [k for k in DYNAMIC_FIELDS + STATIC_FIELDS
               if k not in fields and k not in static]
    if missing:
        raise KeyError(f"missing Params fields: {missing}")
    kwargs = {k: torch.as_tensor(float(np.asarray(fields[k])),
                                 dtype=dtype, device=device)
              for k in DYNAMIC_FIELDS}
    kwargs.update({k: static[k] for k in STATIC_FIELDS})
    return Params(**kwargs)


def state_from_arrays(omega, d_omega, M, dM, device="cpu") -> EigenState:
    """``EigenState`` from array-likes; complex dtypes are kept as given
    (complex64 stays complex64, complex128 stays complex128)."""
    def t(x):
        return torch.tensor(np.asarray(x), device=device)
    return EigenState(omega=t(omega), d_omega=t(d_omega), M=t(M), dM=t(dM))
