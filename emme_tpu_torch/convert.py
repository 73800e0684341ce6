"""Carry parameters and solver state across from plain arrays.

``emme_tpu`` holds its ``Params`` leaves, ``EigenState``, ``PICState`` and
``SparseEigenState`` fields and its BDIA operators' (re, im) planes as
device arrays; handed over as numpy arrays (``np.asarray(getattr(p, f))``)
they build the port's counterparts here, so both packages can compute from
the same inputs.  ``device=None`` is the CUDA card, as in ``from_config``;
the CPU is asked for by name.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import DYNAMIC_FIELDS, STATIC_FIELDS, Params, default_device
from .ops.sparse import BDIAOperator
from .solvers.eigen import EigenState
from .solvers.pic import PICState
from .solvers.sparse_eigen import SparseEigenState


def params_from_arrays(fields: dict, static: dict, dtype=torch.float64,
                       device=None) -> Params:
    """``Params`` from its physical scalars ``fields`` (name -> array-like,
    every name of ``DYNAMIC_FIELDS``) and structural settings ``static``
    (name -> value, every name of ``STATIC_FIELDS``)."""
    missing = [k for k in DYNAMIC_FIELDS + STATIC_FIELDS
               if k not in fields and k not in static]
    if missing:
        raise KeyError(f"missing Params fields: {missing}")
    device = default_device(device)
    kwargs = {k: torch.as_tensor(float(np.asarray(fields[k])),
                                 dtype=dtype, device=device)
              for k in DYNAMIC_FIELDS}
    kwargs.update({k: static[k] for k in STATIC_FIELDS})
    return Params(**kwargs)


def state_from_arrays(omega, d_omega, M, dM, device=None) -> EigenState:
    """``EigenState`` from array-likes; complex dtypes are kept as given
    (complex64 stays complex64, complex128 stays complex128)."""
    device = default_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), device=device)
    return EigenState(omega=t(omega), d_omega=t(d_omega), M=t(M), dM=t(dM))


_PIC_COMPLEX = ("weight", "dc_pb", "field")


def pic_state_from_arrays(fields: dict, device=None,
                          dtype=torch.float64) -> PICState:
    """The port's ``PICState`` from a JAX ``PICState`` handed over as
    arrays (name -> array-like, every field of ``PICState``): real fields
    in ``dtype``, weight, dc_pb and field in its complex counterpart."""
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    device = default_device(device)
    return PICState(**{
        name: torch.tensor(np.asarray(fields[name]), device=device,
                           dtype=cdtype if name in _PIC_COMPLEX else dtype)
        for name in PICState.__dataclass_fields__})


def bdia_from_arrays(data, offsets, n: int, block: int,
                     device=None) -> BDIAOperator:
    """The port's complex ``BDIAOperator`` from a JAX one's (ndiag, nb, 2,
    bs, bs) (re, im) planes: float64 planes give complex128, float32
    planes complex64."""
    planes = np.asarray(data)
    cdtype = torch.complex128 if planes.dtype == np.float64 \
        else torch.complex64
    cplx = torch.complex(torch.tensor(planes[:, :, 0]),
                         torch.tensor(planes[:, :, 1]))
    return BDIAOperator(data=cplx.to(device=default_device(device),
                                     dtype=cdtype),
                        offsets=tuple(int(d) for d in offsets), n=int(n),
                        block=int(block))


def sparse_state_from_arrays(omega, d_omega, M, dM,
                             device=None) -> SparseEigenState:
    """The port's ``SparseEigenState`` from a JAX one: ``omega`` and
    ``d_omega`` array-likes (complex, dtype kept), ``M`` and ``dM`` each a
    (data, offsets, n, block) tuple as ``bdia_from_arrays`` takes."""
    device = default_device(device)

    def t(x):
        return torch.tensor(np.asarray(x), device=device)
    return SparseEigenState(omega=t(omega), d_omega=t(d_omega),
                            M=bdia_from_arrays(*M, device=device),
                            dM=bdia_from_arrays(*dM, device=device))
