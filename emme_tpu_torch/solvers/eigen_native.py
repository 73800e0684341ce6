"""Reference-exact eigensolve on the float64 adaptive assembly.

Counterpart of ``emme_tpu/solvers/eigen_native.py``: the Newton secant
iteration (TraceSecant, solver.h:113-160; QRSecant, solver.h:210-383) on
``native.assemble``, whose integrals run through kernel N1 on the card and
its plain version on the CPU, with the linear algebra of ``ops/linalg`` in
complex128 on the same device.  A solve makes one ``native.assembly_plan``
(the parameters' one host read, N1's pair rows, the placement's indices)
and hands it to each of its 2 + steps assemblies; on the card the plan's
N1 memo is filled by the second and read by the later ones (one more host
read, of the memo's size, at the second).  It opens the dense path's
spans: the coefficients and the plan under ``layer.solve.setup``, each
step's trace solve or QR step under ``layer.linalg.step``, the null vector
(one LU of the final M and inverse iteration on M^H M: the SVD's vector
without the SVD) under ``layer.linalg.vector``, and each step's read of
d_omega under ``layer.host_read`` (the plan and ``native.assemble`` open the
assembly's, the plan's read of the parameters one more
``layer.host_read``).
"""

from __future__ import annotations

import torch

from .. import native
from ..ops import linalg
from ..ops.singularity import singularity_coeff_matrix
from ..utils.timer import host_read, span

METHODS = ("TraceSecant", "QRSecant")


def solve(p, omega_init: complex, tol: float = 1e-6, callback=None,
          n_threads=None, method: str = "TraceSecant"):
    """Secant-Newton on det M(omega) = 0 from ``omega_init`` (the start
    0.99 omega_init, then omega_init).  Stops when |d_omega| < tol |omega|
    or after ``p.iteration_step_limit + 1`` steps; ``callback(j, omega,
    d_omega)`` after each step.  Returns (omega, null vector of M in the
    engine's conjugated convention, steps, M), the last two complex128 on
    ``p.device``.  ``n_threads`` is unused (``native``)."""
    with span("solve.setup"):
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, "
                             f"got {method!r}")
        coeff = singularity_coeff_matrix(p.npoints, dtype=torch.float64,
                                         device=p.device)
        plan = native.assembly_plan(p, coeff)

    omega = 0.99 * complex(omega_init)
    d_omega = 0.01 * complex(omega_init)
    M_old = native.assemble(p, coeff, omega, n_threads, plan=plan)
    omega = omega + d_omega
    M = native.assemble(p, coeff, omega, n_threads, plan=plan)
    dM = (M - M_old) / d_omega

    n_steps = 0
    for j in range(p.iteration_step_limit + 1):
        with span("linalg.step"):
            if method == "QRSecant":
                d_omega = linalg.qr_secant_delta(M, dM)
            else:
                d_omega = -1.0 / linalg.complex_solve_trace(M, dM)
        d_omega = host_read(complex, d_omega)
        omega = omega + d_omega
        M_new = native.assemble(p, coeff, omega, n_threads, plan=plan)
        dM = (M_new - M) / d_omega
        M = M_new
        n_steps = j + 1
        if callback is not None:
            callback(j, omega, d_omega)
        if abs(d_omega) < tol * abs(omega):
            break

    with span("linalg.vector"):
        vec = linalg.null_space_vector(M, "singular")
    return omega, vec, n_steps, M
