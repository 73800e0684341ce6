"""Quadrature-correction coefficient matrix for the |eta - eta'| kernel
singularity (reference src/singularity_handler.cpp:3-24): a band of 6
Lagrange-type coefficients by |i-j|, 1.0 elsewhere, and a -0.5 trapezoid
end-correction on the first/last columns."""
import numpy as np
import torch

from ..params import default_device

_COEFF = np.array([
    0.0,
    2.951388888888883,
    -2.4305555555555305,
    4.166666666667441,
    -0.3472222222224549,
    1.159722222222284,
])

# half-width of the correction band (|i-j| <= 5 gets non-unit coefficients)
SINGULAR_BAND_HALF_WIDTH = 5


def singularity_coeff_matrix(n: int, dtype=torch.float64, device=None):
    """Dense (n, n) coefficient matrix, built on ``device`` (None: the CUDA
    card, ``params.default_device``)."""
    device = default_device(device)
    i = torch.arange(n, device=device)
    diff = (i[:, None] - i[None, :]).abs()
    coeff = torch.as_tensor(_COEFF, dtype=dtype, device=device)
    mat = torch.where(diff <= SINGULAR_BAND_HALF_WIDTH,
                      coeff[diff.clamp(max=SINGULAR_BAND_HALF_WIDTH)],
                      torch.ones((), dtype=dtype, device=device))
    edge = (i[None, :] == 0) | (i[None, :] == n - 1)
    return mat - 0.5 * edge.to(dtype)


def singularity_coeff_band(n: int, h_el: int, dtype=torch.float64,
                           device=None):
    """Banded storage of the same coefficients, built on ``device`` (None:
    the CUDA card):
    (n, 2*h_el+1) with band[i, dj + h_el] = coeff[i, i + dj].  O(n * band)
    memory -- the dense (n, n) matrix never exists (used by the
    direct-to-BDIA assembly).  At n=8192, h_el=2175 it is 142 MB in
    float32."""
    device = default_device(device)
    dj = torch.arange(-h_el, h_el + 1, device=device)
    adj = dj.abs()
    coeff = torch.as_tensor(_COEFF, dtype=dtype, device=device)
    base = torch.where(adj <= SINGULAR_BAND_HALF_WIDTH,
                       coeff[adj.clamp(max=SINGULAR_BAND_HALF_WIDTH)],
                       torch.ones((), dtype=dtype, device=device))
    j = torch.arange(n, device=device)[:, None] + dj[None, :]
    corr = 0.5 * ((j == 0) | (j == n - 1)).to(dtype)
    return base[None, :] - corr
