"""The Newton-secant iteration on det M(omega) = 0, shared by the dense
(``eigen.py``), banded (``sparse_eigen.py``), mesh-sharded dense
(``parallel/sharded.py``) and SPIKE (``parallel/spike.py``) backends.  A
backend gives an ``assemble(omega)`` closure, its update rule for d_omega
and its secant ``secant(M_new, M_old, d_omega)`` (solver.h:54-57); here are
the seeding, a step's tail, the loop with its stop rules, the complex128
polish and the counted host reads.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..utils.timer import host_read, span

# Host reads made by a solve and its polish since the caller last set them
# to 0.  "blocking": the host waits for a scalar with nothing queued behind
# it (``.item()``), so the card idles meanwhile.  "flag_polls": the device
# loop's waits for the done flag of step j, made after step j + 1 is queued,
# so the card does not idle.
HOST_READS = {"blocking": 0, "flag_polls": 0}

# What the last solve did: its loop, the steps it counted, the steps it
# queued (the device loop queues one masked step past the flag), and the
# polish's steps and assemblies.
LAST_SOLVE: dict = {}


def item(t):
    """A blocking read of a 0-d tensor, counted."""
    HOST_READS["blocking"] += 1
    return host_read(t.item)


def items(t):
    """A blocking read of a small 1-d tensor as a list, counted once."""
    HOST_READS["blocking"] += 1
    return host_read(t.tolist)


def seed(assemble, omega_init, secant, state_cls):
    """Reference ctor seeding (solver.h:396-415): assemble at 0.99 w0 and
    w0, the secant derivative from the pair.  ``omega_init`` is a complex
    0-d tensor; returns a ``state_cls``."""
    omega_old = 0.99 * omega_init
    d_omega = 0.01 * omega_init
    M_old = assemble(omega_old)
    omega = omega_old + d_omega
    M = assemble(omega)
    return state_cls(omega=omega, d_omega=d_omega, M=M,
                     dM=secant(M, M_old, d_omega))


def advance(state, d_omega, assemble, secant):
    """A step's tail: omega + d_omega, M there and the secant dM against
    ``state.M``.  Returns a state of ``state``'s class."""
    omega = state.omega + d_omega
    M = assemble(omega)
    return type(state)(omega=omega, d_omega=d_omega, M=M,
                       dM=secant(M, state.M, d_omega))


def step(state, delta, assemble, secant):
    """One Newton step of a single-device backend: its update ``delta(state)``
    under the span ``linalg.step``, then ``advance``."""
    with span("linalg.step"):
        d_omega = delta(state)
    return advance(state, d_omega, assemble, secant)


def _select(keep, new, old):
    """``new`` where the 0-d flag ``keep`` is set, else ``old``: for a
    tensor, or for a block operator (``BDIAOperator``), whose ``data`` is
    selected and whose structure is kept."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep, new, old)
    return replace(new, data=torch.where(keep, new.data, old.data))


def _loop(step, state, tol, limit, f32, callback=None, lag=0):
    """The Newton iteration: returns (state, n_steps), n_steps a 0-d int32
    tensor on the state's device (``run`` reads it with omega).
    ``state`` is any frozen dataclass with fields omega, d_omega (complex
    0-d tensors), M and dM (tensors, or block operators with ``data``):
    ``eigen.EigenState`` or ``sparse_eigen.SparseEigenState``.

    The convergence test |d_omega| < tol |omega|, the finiteness test, the
    stagnation counter and the keep-last-good-state rule are computed on
    device tensors and applied with ``torch.where``: once the done flag is
    set a further step changes nothing.  ``lag`` says when the host reads
    the flag:

    * 0 (``loop="host"``): right after each step, one blocking read a step;
      ``callback(j, state)`` sees every step's state.
    * 1 (``loop="device"``): no host wait inside the loop.  The flag goes
      to pinned memory by a non-blocking copy behind an event, and the host
      reads step j's flag only after it has queued step j + 1, so the card
      always has work queued and the host runs at most one masked step
      past convergence.  On CPU tensors the same code runs without the
      events."""
    dev = state.omega.device
    cuda = dev.type == "cuda"
    rdtype = state.omega.real.dtype
    done = torch.zeros((), dtype=torch.bool, device=dev)
    d_prev = torch.full((), float("inf"), dtype=rdtype, device=dev)
    sc = torch.zeros((), dtype=torch.int32, device=dev)
    n_steps = torch.zeros((), dtype=torch.int32, device=dev)
    flags = torch.zeros(limit, dtype=torch.bool, pin_memory=cuda and lag > 0)
    events = []
    for j in range(limit):
        new = step(state)
        if callback is not None:
            callback(j, new)
        adw = new.d_omega.abs()
        aw = new.omega.abs()
        live = ~done
        finished = adw < tol * aw
        keep = live
        if f32:
            # the float32 floor shows as stagnation (two consecutive steps
            # without 1.25x contraction below 1e-3 |omega|) or as a blow-up
            # (singular M at convergence -> inf / NaN trace solve): then
            # keep the last good state and stop
            ok = torch.isfinite(adw) & torch.isfinite(aw)
            stag = (adw < 1e-3 * aw) & (adw > 0.8 * d_prev)
            sc = torch.where(live, torch.where(ok & stag, sc + 1,
                                               torch.zeros_like(sc)), sc)
            finished = (finished & ok) | ~ok | (sc >= 2)
            keep = live & ok
        state = replace(state, **{f: _select(keep, getattr(new, f),
                                             getattr(state, f))
                                  for f in ("omega", "d_omega", "M", "dM")})
        d_prev = torch.where(keep, adw, d_prev)
        n_steps = n_steps + live.to(torch.int32)
        done = done | finished
        if lag == 0:
            if item(done):
                break
            continue
        flags[j].copy_(done, non_blocking=True)
        if cuda:
            events.append(torch.cuda.Event())
            events[-1].record()
        if j >= 1:
            if cuda:
                host_read(events[j - 1].synchronize)
            HOST_READS["flag_polls"] += 1
            if flags[j - 1]:
                break
    LAST_SOLVE["queued_steps"] = j + 1
    return state, n_steps


def run(step, state, tol, limit, f32, loop="host", callback=None,
        **record):
    """The iteration from ``state`` to its stop (``_loop``), by the host
    loop or the device loop (``loop``), then the step count and omega in
    one read.
    ``LAST_SOLVE`` is cleared first and then holds the loop, the steps and
    ``record``.  Returns (state, n_steps, omega): an int and a Python
    complex."""
    LAST_SOLVE.clear()
    state, n_steps = _loop(step, state, tol, limit, f32, callback,
                           lag=1 if loop == "device" else 0)
    # one read; float64 holds a float32 omega and the count exactly
    n, re, im = items(torch.stack([n_steps.to(torch.float64),
                                   state.omega.real.to(torch.float64),
                                   state.omega.imag.to(torch.float64)]))
    LAST_SOLVE.update(loop=loop, steps=int(n), **record)
    return state, int(n), complex(re, im)


def polish(state, tol, assemble, widen, bilinear, null_vec, secant,
           omega: complex | None = None, max_steps: int = 8):
    """Hybrid-precision certification polish: assembly in the working
    precision (``assemble``, K1 for float32), linear algebra in complex128
    on the same device.

    The float32 Newton iteration plateaus at the rounding noise of its
    update (~1e-4 relative on ill-conditioned electromagnetic cases), while
    float32 ASSEMBLY rounding is harmless.  So after the loop, keep
    assembling in the working precision and drive a bordered-secant update
    on the scalar g(omega) = v^T M(omega) v in complex128 to the
    reference's criterion |d_omega| < tol * |omega| (main.cpp:53-56).

    The null vector v is kept FROZEN across secant steps -- the bilinear
    zero of g is QUADRATICALLY insensitive to v's error (v is a stationary
    point of the complex-symmetric Rayleigh quotient) -- and refreshed only
    when the loop first signals convergence; the criterion is then
    re-verified with the refreshed v.  When g and its secant derivative are
    both rounding noise (0/0) the step is zero: the criterion passes and the
    refreshed-v pass certifies the point.

    The backend gives ``widen`` (its operator in complex128), ``bilinear(v,
    A)`` (v^T A v), ``null_vec(A)`` (v of unit norm) and ``secant(A_new,
    A_old, d_omega)`` with a Python complex d_omega.  ``omega``:
    ``state.omega`` as a Python complex where the caller has read it
    already; else it is read here.  Returns (omega, v, steps): a Python
    complex, v complex128 on the device, and the secant steps taken.
    ``LAST_SOLVE["polish_assemblies"]`` counts the assemblies."""
    LAST_SOLVE["polish_assemblies"] = 0
    if omega is None:
        omega = complex(item(state.omega))
    A = widen(state.M)
    dA = widen(state.dM)
    v = null_vec(A)
    refreshed = False
    steps = 0
    for _ in range(max_steps):
        den, num = items(torch.stack([bilinear(v, dA), bilinear(v, A)]))
        d_omega = -num / den if den != 0 else complex(0.0)
        if not (np.isfinite(d_omega.real) and np.isfinite(d_omega.imag)):
            d_omega = complex(0.0)   # 0/0 secant at the floor (see above)
        omega = omega + d_omega
        steps += 1
        converged = abs(d_omega) < tol * abs(omega)
        if converged and refreshed:
            break
        A_new = widen(assemble(torch.tensor(omega, dtype=state.omega.dtype,
                                            device=state.omega.device)))
        LAST_SOLVE["polish_assemblies"] += 1
        dA = secant(A_new, A, d_omega)
        A = A_new
        if converged:
            # refresh v on the converged (near-singular) operator and let
            # the next pass re-verify the criterion with it
            v = null_vec(A)
            refreshed = True

    if not refreshed:  # step limit hit before a confirming pass
        v = null_vec(A)
    return omega, v, steps
