"""Quadrature-correction coefficient matrix for the |eta - eta'| kernel
singularity (reference src/singularity_handler.cpp:3-24): a band of 6
Lagrange-type coefficients by |i-j|, 1.0 elsewhere, and a -0.5 trapezoid
end-correction on the first/last columns."""
import numpy as np
import torch

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


def singularity_coeff_matrix(n: int, dtype=torch.float64, device="cpu"):
    """Dense (n, n) coefficient matrix, built on ``device``."""
    i = torch.arange(n, device=device)
    diff = (i[:, None] - i[None, :]).abs()
    coeff = torch.as_tensor(_COEFF, dtype=dtype, device=device)
    mat = torch.where(diff <= SINGULAR_BAND_HALF_WIDTH,
                      coeff[diff.clamp(max=SINGULAR_BAND_HALF_WIDTH)],
                      torch.ones((), dtype=dtype, device=device))
    edge = (i[None, :] == 0) | (i[None, :] == n - 1)
    return mat - 0.5 * edge.to(dtype)
