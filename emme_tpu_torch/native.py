"""The reference-exact float64 engine: adaptive Gauss-Kronrod assembly of
the dense operator, on the card through kernel N1.

Counterpart of ``emme_tpu/native.py``, which binds the multithreaded C++
engine ``native/emme_native.cpp`` on the CPU.  Here every (pair, moment)
integral is one adaptive integral of kernel N1 (``csrc/adaptive.cu``,
``ops/cuda_adaptive.py``) on a CUDA device, and of its plain PyTorch
version (``ops/adaptive.py``) where the caller asked for the CPU.  The
functions take the port's ``Params`` (float64 from ``from_config``) and
return complex128 tensors on ``p.device``.  ``n_threads`` stays in the
signatures for parity with ``emme_tpu.native`` and is not used: the card
runs the integrals in N1's warps.  ``assemble`` opens the dense path's
spans: ``layer.assembly.pairs`` around the integrals and the kernels made
of them, ``layer.assembly.place`` around the writes into M; an
electromagnetic operator's electron closed forms and A_par diagonal open
``layer.assembly.electron`` between them.
"""

from __future__ import annotations

import torch

from .ops import adaptive, cuda_adaptive
from .ops.adaptive import phys_from_params  # noqa: F401  (public)
from .utils.timer import span


def build() -> str:
    """Compile kernel N1's library (``csrc/adaptive.cu``) unless built;
    returns its path.  Raises where nvcc is missing or the build fails."""
    return cuda_adaptive.build()["path"]


def available() -> bool:
    """Whether kernel N1's library builds and loads here.  It chooses no
    path: on a CUDA device the kernel always runs (and raises if it
    cannot), on the CPU the plain version."""
    try:
        cuda_adaptive.library()
        return True
    except Exception:
        return False


def _f64(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def g_bi(p, eta):
    """(g(eta), b_i(eta)) in float64 on ``p.device``, the engine's forms."""
    ph = phys_from_params(p)
    eta = _f64(eta, p.device)
    return adaptive.g_eta(ph, eta), adaptive.bi_eta(ph, eta)


def kappa_batch(p, m, eta, eta_p, omega, with_electron=False,
                n_threads=None):
    """Adaptive-quadrature kappa for arrays of (m, eta, eta_p): complex128
    on ``p.device`` (the ion integral, plus the closed-form electron term
    where ``with_electron``)."""
    ph = phys_from_params(p)
    eta = _f64(eta, p.device).reshape(-1)
    eta_p = _f64(eta_p, p.device).reshape(-1)
    m = torch.as_tensor(m, device=p.device).to(torch.int32)
    m = torch.broadcast_to(m, eta.shape).contiguous()
    vals, _panels, _miller = cuda_adaptive.integrate(
        adaptive.pair_rows(ph, eta, eta_p), m, adaptive.scalars(ph, omega))
    out = adaptive.ion_prefactor(ph, vals)
    if with_electron:
        out = out + adaptive.kappa_electron(ph, m, eta, eta_p, omega)
    return out


def pair_integrals(p, i, j):
    """N1's inputs for the pairs (i, j) of the engine's grid of ``p``
    (dx = 2 L / (npoints - 1)): pair rows and moments, pair-major, one
    integral per moment of the operator (m = 0, or 0, 1, 2 when
    electromagnetic); returns (rows, m, the grid's eta, Phys)."""
    ph = phys_from_params(p)
    n = int(p.npoints)
    dx = 2.0 * ph.length / (n - 1)
    grid = -ph.length + torch.arange(n, dtype=torch.float64,
                                     device=p.device) * dx
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    i, j = i.to(p.device), j.to(p.device)
    m = torch.tensor(ms, dtype=torch.int32, device=p.device).repeat(i.numel())
    rows = adaptive.pair_rows(ph, grid[i].repeat_interleave(len(ms)),
                              grid[j].repeat_interleave(len(ms)))
    return rows, m, grid, ph


def assemble(p, coeff, omega, n_threads=None):
    """The dense operator M(omega), complex128 (dim, dim) on ``p.device``,
    dim = npoints (electrostatic) or 2 npoints (electromagnetic), with the
    engine's entries (emme_native.cpp:439-496)."""
    dev = p.device
    n = int(p.npoints)
    em = bool(p.electromagnetic)
    with span("assembly.pairs"):
        iu, ju = torch.triu_indices(n, n, 1, device=dev)
        rows, m, grid, ph = pair_integrals(p, iu, ju)
        vals, _panels, _miller = cuda_adaptive.integrate(
            rows, m, adaptive.scalars(ph, omega))
        npairs = iu.numel()
        k = adaptive.ion_prefactor(ph, vals).reshape(npairs, -1)
    if em:
        with span("assembly.electron"):
            ke = adaptive.kappa_electron(ph, m.reshape(npairs, 3)[:, 1:],
                                         grid[iu, None], grid[ju, None],
                                         omega)
            bi = adaptive.bi_eta(ph, grid)
    dx = 2.0 * ph.length / (n - 1)
    with span("assembly.place"):
        coeff = _f64(coeff, dev)
        dim = 2 * n if em else n
        M = torch.zeros((dim, dim), dtype=torch.complex128, device=dev)
        a = -k[:, 0] * coeff[iu, ju] * dx
        M[iu, ju] = a
        M[ju, iu] = a
        diag = torch.arange(n, device=dev)
        M[diag, diag] = 1.0 + 1.0 / ph.tau
        if em:
            u = (k[:, 1] + ke[:, 0]) * dx
            d = (k[:, 2] + ke[:, 1]) * dx
            M[iu, ju + n] = u
            M[ju, iu + n] = -u
            M[iu + n, ju] = -u
            M[ju + n, iu] = u
            M[iu + n, ju + n] = d
            M[ju + n, iu + n] = d
            M[diag + n, diag + n] = ((2.0 * ph.tau) / ph.beta_e * bi).to(
                M.dtype)
    return M
