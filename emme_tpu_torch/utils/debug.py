"""Debug-mode checks: the port's analogue of the reference's ``EMME_DEBUG``
build flag (bounds/dimension/div-by-zero checks, ``Matrix.h:38-42``,
``solver.h:418-425``).  Counterpart of ``emme_tpu/utils/debug.py``.

  * ``check_finite``: with the checks enabled, raises ``FloatingPointError``
    naming the stage whose tensor holds a NaN or an Inf -- the runtime twin
    of the reference's div-by-zero guards.  The driver calls it on omega,
    the eigenvector, every dumped matrix and every PIC field.  Each call is
    one blocking read of the device, so the checks run only in debug mode.
  * ``validate_problem``: the input-dimension consistency checks the
    reference performs at solver construction (solver.h:418-425): grid /
    operator / marker sizes, positivity of the physical scales the kernels
    divide by.

Enable via ``driver.run(debug=True)``, input key ``"debug": true``, or the
CLI ``--debug`` flag (runtime-selectable rather than a compile-time flag).
"""

from __future__ import annotations

import torch

from .timer import host_read

_NAN_CHECKS = False


def enable_nan_checks() -> None:
    global _NAN_CHECKS
    _NAN_CHECKS = True


def disable_nan_checks() -> None:
    global _NAN_CHECKS
    _NAN_CHECKS = False


def nan_checks_enabled() -> bool:
    return _NAN_CHECKS


def check_finite(name: str, value) -> None:
    """With the NaN checks enabled, raise ``FloatingPointError`` naming
    ``name`` when ``value`` (a tensor, an array, a Python number, or a
    block operator with ``offsets`` and ``data``) is not finite everywhere.  A no-op otherwise."""
    if not _NAN_CHECKS:
        return
    if hasattr(value, "offsets"):   # a block operator: its stored blocks
        value = value.data
    t = torch.as_tensor(value)
    if not host_read(bool, torch.isfinite(t).all()):
        bad = int((~torch.isfinite(t)).sum())
        raise FloatingPointError(
            f"debug: {name} holds {bad} non-finite value(s) of {t.numel()}")


def validate_problem(p, cfg: dict) -> None:
    """Input-dimension/positivity checks (cf. solver.h:418-425: the
    reference throws on grid/coeff dimension mismatch under EMME_DEBUG).
    Raises ValueError with a named reason instead of letting a later
    kernel divide by zero or a reshape fail opaquely."""
    def positive(name, v):
        if not float(v) > 0:
            raise ValueError(f"debug: {name} must be > 0, got {v}")

    positive("npoints", p.npoints)
    positive("length", p.length)
    positive("vt", p.vt)
    positive("tau", p.tau)
    positive("R", p.R)
    if p.npoints % 2:
        raise ValueError("debug: npoints must be even (interleaved "
                         "electromagnetic ordering pairs phi/A rows)")
    if cfg.get("eigen_backend") == "sparse":
        dim = 2 * p.npoints if p.electromagnetic else p.npoints
        block = cfg.get("band_block")
        if block and dim % int(block):
            raise ValueError(
                f"debug: band_block {block} does not divide operator "
                f"dimension {dim}")
    if cfg.get("method") == "PIC":
        if int(cfg.get("marker_per_cell", 1)) <= 0:
            raise ValueError("debug: marker_per_cell must be > 0")
        if float(cfg.get("time_step", 1.0)) <= 0:
            raise ValueError("debug: time_step must be > 0")
    mesh_cfg = cfg.get("mesh") or {}
    rows = mesh_cfg.get("rows")
    if rows:
        dim = 2 * p.npoints if p.electromagnetic else p.npoints
        if dim % int(rows):
            raise ValueError(
                f"debug: mesh rows {rows} does not divide operator "
                f"dimension {dim}")
