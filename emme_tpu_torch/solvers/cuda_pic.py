"""The fused delta-f PIC marker pass: CUDA kernels K2, K3, K4, their plain
PyTorch versions, and the host side of a fused run.

Counterpart of ``emme_tpu/solvers/pallas_pic.py``.  The kernels
(``csrc/pic.cu``):

* K2, one RK3 stage over all markers (Pallas ``_stage_kernel``): the launch
  ``pic_stage`` (gather, physics, RK update, per-block deposit histogram
  written as one float64 partial a block) and ``pic_field`` (the
  fixed-order float64 sum of the partials times the quasi-neutrality
  coefficient).  ``stage`` runs both.
* K3, the whole run, n_steps x 3 stages, in one persistent cooperative
  launch (Pallas ``_mega_kernel``), J0 and the drift-center phase factor
  carried from stage to stage.  ``mega`` runs it; ``mega_grid`` reports the
  launch shape (one block of 1024 threads a SM, in clusters in
  ``FORM_CLUSTER``) and ``LAST_MEGA_GRID`` the one the last launch took.
* K4, the grid-sync probe (Pallas ``alias_carry_probe``): a cooperative
  launch at K3's grid, clusters and co-residency in which each round after
  the first reads what another block wrote before the grid barrier.
  ``grid_sync_probe`` runs it; ``grid_sync_selfcheck`` runs it once per
  process, with the co-residency check of K3's grid.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
``LAUNCHES``; for CPU tensors it runs the plain version (``stage_ref``,
``mega_ref``, ``grid_sync_probe_ref``).  A failed build or launch raises:
nothing falls back.  The plain versions mirror the Pallas formulas, so the
kernel and its plain version compute one function.

Markers are flat (m,) float32 structure-of-arrays (``state_to_arrs``); the
field is two (nf,) float32 planes.  The Pallas (8, m/8) sublane view is a
TPU layout and is not carried over.

K2 and K3 take any npoints that is a multiple of 32 (``run``, as the Pallas
path, a multiple of 128); device memory is the only other limit.  Where a
stage keeps the field and the deposit histogram is its form, chosen by
npoints alone (``form``): up to ``SHARED_NF`` both in shared memory (the
small-grid build), up to ``CLUSTER_NF`` the histogram alone, in the
shared memory of a thread-block cluster of ``cluster_size(npoints)``
blocks (each holds ``npoints / cluster_size`` columns of both planes; one
block, a plain launch, up to ``CLUSTER_SLICE_NF``), above that a float32
scratch row a block in device memory.
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np
import torch

from .. import _build
from ..ops.bessel import bessel_j0, bessel_j1
from ..utils.timer import host_read, span
from . import pic
from .pic import RK_COEF, PICState

# kernel launches made by the wrappers on CUDA tensors
LAUNCHES = {"pic_stage": 0, "pic_field": 0, "pic_mega": 0,
            "grid_sync_probe": 0}
# the path the last ``run`` took: "single" (K3) or "stages" (K2)
LAST_LAUNCH: str | None = None
# the launch shape (``mega_grid``) of the last K3 launch
LAST_MEGA_GRID: dict | None = None

# csrc/pic.cu kFormShared / kFormCluster / kFormGlobal and the largest nf of
# the first: 4 nf floats of shared memory (192 KB)
FORM_SHARED, FORM_CLUSTER, FORM_GLOBAL = 0, 1, 2
SHARED_NF = 12288
# kFormCluster: the columns a cluster rank's slice holds at most (2 floats a
# column beside the reduce's 8 KB fill a block's 232,448 bytes), the largest
# cluster (the portable limit) and the largest nf of the form
CLUSTER_SLICE_NF = 28032
CLUSTER_MAX = 8
CLUSTER_NF = CLUSTER_MAX * CLUSTER_SLICE_NF
# csrc/pic.cu kThreads: threads a block.  K3 runs one such block a SM, the
# fastest of the shapes measured on an H100 (PERF.md section 6): few blocks
# make the grid barrier and the partials cheap, and 64 registers a thread
# hold the stage body without spills.
THREADS = 1024
TILE = 32               # csrc/pic.cu kTile: columns a block reduces at a time
PROBE_ROUNDS = 3        # x -> a, barrier, a -> b, barrier, b -> a
# csrc/pic.cu kPartNoDeposit: K3's marker pass without its deposit
PART_NO_DEPOSIT = 4

# scalar block layout (csrc/pic.cu kP_*)
(P_L, P_CW, P_VT, P_BT, P_SHAT, P_ODB, P_QR, P_I2CW, P_SUBDT) = range(9)
P_CPREV, P_CCUR = 11, 12
N_PARAMS = 16

MARKERS = ("eta", "v_para", "v_perp", "w_re", "w_im", "odv", "ost", "pw")
_PRECISIONS = ("default", "high", "highest")
_F32 = torch.float32


# ---------------------------------------------------------------------------
# host side of a fused run
# ---------------------------------------------------------------------------

def form(nf: int) -> int:
    """Where K2 and K3 keep the field and the histogram at ``nf`` grid
    points (csrc/pic.cu form_of): ``FORM_SHARED``, ``FORM_CLUSTER`` or
    ``FORM_GLOBAL``."""
    if nf <= SHARED_NF:
        return FORM_SHARED
    return FORM_CLUSTER if nf <= CLUSTER_NF else FORM_GLOBAL


def cluster_size(nf: int) -> int:
    """The blocks of a K2 / K3 cluster at ``nf`` grid points (csrc/pic.cu
    cluster_of): in ``FORM_CLUSTER`` the smallest of 1, 2, 4, 8 whose
    slice of nf / cs columns fits one block, else 1."""
    if form(nf) != FORM_CLUSTER:
        return 1
    cs = 1
    while nf > cs * CLUSTER_SLICE_NF:
        cs *= 2
    return cs


class FusedStep:
    """Shapes, guards and the float32 scalar block of a fused run."""

    def __init__(self, p, m: int, dt):
        nf = int(p.npoints)
        if nf % 128:
            raise ValueError(f"fused PIC needs npoints % 128 == 0, got {nf}")
        if m % 8 or (m // 8) % 128:
            raise ValueError(f"fused PIC needs markers % 1024 == 0, got {m}")
        self.nf = nf
        self.dc = bool(p.drift_center_transformation_switch)
        self.params = self.params_vec(p, dt)

    @staticmethod
    def params_vec(p, dt) -> np.ndarray:
        """The (16,) float32 scalar block, computed in float32 as
        ``pallas_pic.py:371-379`` does, with sub_dt of each stage and the
        stage-2 RK weights.  Each of p's scalars is its own blocking read
        (``timer.host_read``): eight a block."""
        def f(v):
            return torch.as_tensor(v).to(device="cpu", dtype=_F32)

        def read(v):
            return host_read(f, v)

        cw = pic.cell_width(p)
        vals = torch.zeros(N_PARAMS, dtype=_F32)
        sets = {P_L: p.length, P_CW: cw, P_VT: p.vt, P_BT: p.b_theta,
                P_SHAT: p.shat, P_ODB: p.omega_d_bar, P_QR: p.q * p.R}
        for k, v in sets.items():
            vals[k] = read(v)
        vals[P_I2CW] = 1.0 / (2.0 * read(cw))
        dtf = f(dt)
        for stage in range(3):
            vals[P_SUBDT + stage] = float(RK_COEF[stage][stage + 1]) * dtf
        vals[P_CPREV] = float(RK_COEF[2][1])
        vals[P_CCUR] = float(RK_COEF[2][2])
        return vals.numpy()

    def step(self, arrs, field, qn, first: bool = False):
        """One RK3 step: three K2 stages.  Returns (arrs, field)."""
        vel_prev = None
        for s in range(3):
            velr, veli, eta, wre, wim, fr, fi = stage(
                s, first and s == 0, self.dc, self.params, *field, qn, arrs,
                vel_prev)
            if s == 1:
                vel_prev = (velr, veli)
            arrs = dict(arrs, eta=eta, w_re=wre, w_im=wim)
            field = (fr, fi)
        return arrs, field


def state_to_arrs(s: PICState) -> dict:
    """The flat (m,) float32 marker arrays of a ``PICState``."""
    cols = {"eta": s.eta, "v_para": s.v_para, "v_perp": s.v_perp,
            "w_re": s.weight.real, "w_im": s.weight.imag, "odv": s.omega_dv,
            "ost": s.omega_st, "pw": s.p_weight}
    return {k: v.to(_F32).contiguous() for k, v in cols.items()}


def arrs_to_state(p, arrs, field) -> PICState:
    """Back to ``PICState``; j0 / dc_pb refreshed the way solve_field leaves
    them (recomputed at the current eta)."""
    eta, v_para, v_perp, odv = (arrs[k] for k in ("eta", "v_para", "v_perp",
                                                  "odv"))
    x_perp = v_perp / p.vt
    sb = torch.sqrt(p.b_theta * (1.0 + (p.shat * eta) ** 2))
    j0 = bessel_j0(x_perp * sb)
    odi = ((p.q * p.R / v_para) * p.omega_d_bar
           * (torch.sin(eta) * (1.0 + p.shat) - p.shat * eta * torch.cos(eta)))
    return PICState(
        eta=eta, v_para=v_para, v_perp=v_perp,
        weight=torch.complex(arrs["w_re"], arrs["w_im"]),
        omega_dv=odv, omega_st=arrs["ost"], p_weight=arrs["pw"],
        j0=j0, dc_pb=torch.exp(-1j * odi * odv),
        field=torch.complex(*field))


def plane_stats(fr, fi):
    """field_stats on the (re, im) planes (main.cpp:111-118)."""
    return torch.stack([fr.mean(), fi.mean(),
                        torch.sqrt((fr * fr + fi * fi).mean())])


def run(p, marker_per_cell: int, n_steps: int, dt, generator=None,
        state: PICState | None = None, precision: str = "default",
        launch: str = "auto"):
    """Full PIC run on the fused kernels, with the contract of ``pic.run``:
    (stats (n_steps, 3), final PICState, None).  Starts from ``state`` when
    given, else from ``pic.init_state`` with ``generator``.

    ``launch``: "single" runs the whole time loop as one cooperative launch
    of K3 and raises when the grid-sync self-check fails; "stages" launches
    K2 stage by stage; "auto" takes K3 when the self-check passes, and
    otherwise K2, with a warning that gives the reason.  ``LAST_LAUNCH``
    records the path taken.

    ``precision`` ("default", "high", "highest") is accepted for the JAX
    package's contract.  On the card all three give exact float32 gathers
    and deposits: the single bf16 pass of "default" was a property of the
    TPU's matrix unit, and nothing here is a matrix product.

    Spans: ``layer.pic.setup`` up to K3's launch, holding
    ``layer.pic.params`` (``FusedStep``: its eight reads of p's scalars),
    ``layer.pic.qn`` (the quasi-neutrality coefficient) and
    ``layer.pic.arrs`` (the initial state, the marker arrays, the field's
    planes); ``layer.pic.k3``; ``layer.pic.state``."""
    global LAST_LAUNCH
    with span("pic.setup"):
        if p.dtype != _F32:
            raise ValueError("fused PIC is f32-only (CUDA kernels)")
        if launch not in ("auto", "single", "stages"):
            raise ValueError(f"launch must be auto|single|stages, "
                             f"got {launch}")
        if precision not in _PRECISIONS:
            raise ValueError(f"precision must be one of {_PRECISIONS}, "
                             f"got {precision!r}")
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        with span("pic.params"):
            fs = FusedStep(p, marker_per_cell * p.npoints, dt)
        with span("pic.qn"):
            qn = pic.quasi_neutrality_coef(p, dtype=_F32)
        with span("pic.arrs"):
            state = pic.initial_state(p, marker_per_cell, generator, state)
            arrs = state_to_arrs(state)
            field = tuple(f.to(_F32).contiguous()
                          for f in (state.field.real, state.field.imag))

        path = launch
        if launch != "stages":
            ok, info = grid_sync_selfcheck(p.device, fs.nf, fs.dc)
            if ok:
                path = "single"
            elif launch == "single":
                raise RuntimeError(f"launch='single' needs K3's grid-sync "
                                   f"self-check to pass: {info['reason']}")
            else:
                warnings.warn(f"fused PIC takes the per-stage kernels (K2): "
                              f"{info['reason']}", RuntimeWarning,
                              stacklevel=2)
                path = "stages"
        LAST_LAUNCH = path

    with span("pic.k3"):
        if path == "single":
            eta, wre, wim, fr, fi, stats = mega(fs.dc, fs.params, *field, qn,
                                                arrs, n_steps)
            arrs = dict(arrs, eta=eta, w_re=wre, w_im=wim)
            field = (fr, fi)
        else:
            stats = []
            for k in range(n_steps):
                arrs, field = fs.step(arrs, field, qn, first=(k == 0))
                stats.append(plane_stats(*field))
            stats = torch.stack(stats)
    with span("pic.state"):
        return stats, arrs_to_state(p, arrs, field), None


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def marker_ref(stage_idx: int, first: bool, dc: bool, params, fr, fi, arrs,
               vel_prev=None):
    """One stage's per-marker arithmetic in torch, on any device: the Pallas
    formulas of ``pallas_pic.py:178-279`` with index gathers.  Returns
    (vel_re, vel_im, eta, w_re, w_im) and the deposit (den_re, den_im, i2,
    ir, w2): density, left and right cell, right-cell weight.  The scalars
    are 0-d tensors on the markers' device, so on the card the divisions
    are true divisions, as in the kernel."""
    nf = fr.shape[0]
    prm = torch.as_tensor(params, device=fr.device)
    L, cw, vt, bt, shat, odb, qR, i2cw = (prm[k] for k in range(8))
    sub_dt = prm[P_SUBDT + stage_idx]
    eta, vpar, vperp, wre, wim, odv, ost, pw = (arrs[k] for k in MARKERS)

    # locate at eta, clipped; gather f[c], f[c+1], g[c], g[c+1] (periodic)
    x = (eta + L) / cw
    idxf = torch.floor(x)
    wgt = x - idxf
    c = torch.clamp(idxf.to(torch.int64), 0, nf - 1)
    cp, cm, cpp = (c + 1) % nf, (c - 1) % nf, (c + 2) % nf
    f0r, f0i, f1r, f1i = fr[c], fi[c], fr[cp], fi[cp]
    g0r, g0i = f1r - fr[cm], f1i - fi[cm]
    g1r, g1i = fr[cpp] - f0r, fi[cpp] - f0i
    wl = 1.0 - wgt
    phir = wl * f0r + wgt * f1r
    phii = wl * f0i + wgt * f1i
    dphir = (wl * g0r + wgt * g1r) * i2cw
    dphii = (wl * g0i + wgt * g1i) * i2cw

    # marker physics (solver_pic.h:82-140)
    x_perp = vperp / vt
    sb = torch.sqrt(bt * (1.0 + (shat * eta) ** 2))
    dj0 = -bt * (shat * shat) * x_perp * eta * bessel_j1(x_perp * sb) / sb
    omega_d = odb * (torch.cos(eta) + shat * eta * torch.sin(eta))
    if first:
        j0 = dcr = dci = torch.zeros_like(eta)
    else:
        j0 = bessel_j0(x_perp * sb)
        odi = (qR / vpar) * odb * (torch.sin(eta) * (1.0 + shat)
                                   - shat * eta * torch.cos(eta))
        ph = odi * odv
        dcr, dci = torch.cos(ph), -torch.sin(ph)
    a = ost - omega_d * odv
    vq = vpar / qR
    comr = -a * j0 * phii - vq * (j0 * dphir + dj0 * phir)
    comi = a * j0 * phir - vq * (j0 * dphii + dj0 * phii)
    if dc:
        velr = pw * (dcr * comr + dci * comi)
        veli = pw * (dcr * comi - dci * comr)
    else:
        b = omega_d * odv
        velr = wim * b + pw * comr
        veli = -wre * b + pw * comi

    # RK combine + update (solver_pic.h:142-151, 425-435)
    if stage_idx == 2:
        combor = prm[P_CPREV] * vel_prev[0] + prm[P_CCUR] * velr
        comboi = prm[P_CPREV] * vel_prev[1] + prm[P_CCUR] * veli
    else:
        combor, comboi = velr, veli
    m = eta + vpar * (sub_dt / qR) + L
    two_l = 2.0 * L
    eta_n = m - two_l * torch.floor(m / two_l) - L
    wre_n = wre + combor * sub_dt
    wim_n = wim + comboi * sub_dt

    # deposit at eta_n (solver_pic.h:249-354) and the field solve
    x2 = (eta_n + L) / cw
    i2f = torch.floor(x2)
    w2 = x2 - i2f
    i2 = torch.clamp(i2f.to(torch.int64), 0, nf - 1)
    ir = torch.where(i2 + 1 >= nf, 0, i2 + 1)
    j0n = bessel_j0(x_perp * torch.sqrt(bt * (1.0 + (shat * eta_n) ** 2)))
    if dc:
        odin = (qR / vpar) * odb * (torch.sin(eta_n) * (1.0 + shat)
                                    - shat * eta_n * torch.cos(eta_n))
        phn = odin * odv
        dnr, dni = torch.cos(phn), -torch.sin(phn)
        denr = j0n * (wre_n * dnr - wim_n * dni)
        deni = j0n * (wre_n * dni + wim_n * dnr)
    else:
        denr, deni = j0n * wre_n, j0n * wim_n
    return (velr, veli, eta_n, wre_n, wim_n), (denr, deni, i2, ir, w2)


def deposit_ref(denr, deni, i2, ir, w2, qn):
    """The field planes of a deposit (solver_pic.h:249-354): the CIC
    histogram of the density, accumulated in float64 as the kernels'
    cross-block sums are, rounded once, times the quasi-neutrality
    coefficient."""
    w2l = 1.0 - w2
    planes = []
    for den in (denr, deni):
        h = torch.zeros(qn.shape[0], dtype=torch.float64, device=den.device)
        h.index_add_(0, i2, (den * w2l).double())
        h.index_add_(0, ir, (den * w2).double())
        planes.append(h.to(den.dtype) * qn)
    return planes[0], planes[1]


def stage_ref(stage_idx: int, first: bool, dc: bool, params, fr, fi, qn,
              arrs, vel_prev=None):
    """K2's plain version: ``marker_ref`` and ``deposit_ref``.  Returns
    (vel_re, vel_im, eta, w_re, w_im, field_re, field_im)."""
    state, deposit = marker_ref(stage_idx, first, dc, params, fr, fi, arrs,
                                vel_prev)
    return (*state, *deposit_ref(*deposit, qn))


def mega_ref(dc: bool, params, fr, fi, qn, arrs, n_steps: int):
    """K3's plain version: ``stage_ref`` over n_steps x 3 stages, the first
    stage of the run with j0 = dc = 0.  Returns (eta, w_re, w_im, field_re,
    field_im, stats (n_steps, 3))."""
    stats = []
    for step in range(n_steps):
        vel_prev = None
        for s in range(3):
            velr, veli, eta, wre, wim, fr, fi = stage_ref(
                s, step == 0 and s == 0, dc, params, fr, fi, qn, arrs,
                vel_prev)
            if s == 1:
                vel_prev = (velr, veli)
            arrs = dict(arrs, eta=eta, w_re=wre, w_im=wim)
        stats.append(plane_stats(fr, fi))
    return (arrs["eta"], arrs["w_re"], arrs["w_im"], fr, fi,
            torch.stack(stats))


def probe_rotation(s: int, nblocks: int) -> int:
    """The block rotation of K4's round s >= 2 (csrc/pic.cu
    probe_rotation): half the grid away at first, then nearer."""
    return (nblocks // s + s) % nblocks


def grid_sync_probe_ref(x, rounds: int = PROBE_ROUNDS):
    """K4's plain version on (nblocks, slice) x.  Round 1: block b holds
    2 x (its own slice).  Round s >= 2: block b holds 2 x (block
    (b + probe_rotation(s)) mod nblocks of round s - 1).  So the result is
    x * 2^rounds, rotated by the rotations' sum."""
    nblocks = x.shape[0]
    shift = sum(probe_rotation(s, nblocks) for s in range(2, rounds + 1))
    return torch.roll(x, -shift, dims=0) * 2.0 ** rounds


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _library():
    lib, _record = _build.load("pic")
    if lib.pic_stage_launch.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        pci = ctypes.POINTER(ctypes.c_int)
        sigs = {
            "pic_form": ([ci], ci),
            "pic_cluster_size": ([ci], ci),
            "pic_params_len": ([], ci),
            "pic_threads": ([], ci),
            "pic_tile": ([], ci),
            "pic_stage_grid": ([ci] * 5, ci),
            "pic_stage_launch": ([ci, ci, ci] + [vp] * 20 + [ci] * 3 + [vp],
                                 ci),
            "pic_field_launch": ([vp, ci, vp, vp, vp, ci, vp], ci),
            "pic_mega_grid": ([ci] * 2 + [pci] * 7, ci),
            "pic_mega_launch": ([ci] + [vp] * 20 + [ci] * 6 + [vp], ci),
            "grid_sync_probe_launch": ([vp, vp, vp] + [ci] * 5 + [vp], ci),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        if (lib.pic_params_len(), lib.pic_threads(), lib.pic_tile()) \
                != (N_PARAMS, THREADS, TILE) \
                or any((lib.pic_form(nf), lib.pic_cluster_size(nf))
                       != (form(nf), cluster_size(nf)) for nf in (
                    SHARED_NF, SHARED_NF + TILE, CLUSTER_SLICE_NF,
                    CLUSTER_SLICE_NF + TILE, 2 * CLUSTER_SLICE_NF, 2 * CLUSTER_SLICE_NF + TILE,
                    4 * CLUSTER_SLICE_NF + TILE, CLUSTER_NF,
                    CLUSTER_NF + TILE)):
            raise RuntimeError("csrc/pic.cu constants disagree with "
                               "cuda_pic.py")
    return lib


def _check(name, t, shape, device):
    if t.device != device or t.dtype != _F32 or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"PIC kernel: {name} must be a contiguous float32 tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")


def _check_inputs(fr, fi, qn, arrs, vel_prev=None):
    dev, nf = fr.device, fr.shape[0]
    if nf < TILE or nf % TILE:
        raise ValueError(f"PIC kernel: the field reduce takes tiles of "
                         f"{TILE} columns of one plane, so npoints % {TILE} "
                         f"== 0; got {nf}")
    m = arrs["eta"].shape[0]
    for name, t in (("field_re", fr), ("field_im", fi), ("qn", qn)):
        _check(name, t, (nf,), dev)
    for k in MARKERS:
        _check(k, arrs[k], (m,), dev)
    for k, t in zip(("vel_re", "vel_im"), vel_prev or ()):
        _check(k, t, (m,), dev)
    return dev, nf, m


def _check_partials(partials, device):
    if partials.device != device or partials.dtype != torch.float64 \
            or not partials.is_contiguous():
        raise ValueError("PIC kernel: partials must be a contiguous float64 "
                         f"tensor on {device}")


def _params_host(params) -> np.ndarray:
    params = np.ascontiguousarray(params, dtype=np.float32)
    if params.shape != (N_PARAMS,):
        raise ValueError(f"params must hold {N_PARAMS} floats")
    return params


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _scratch(n_blocks, nf, dev):
    """The per-block float32 histogram rows of ``FORM_GLOBAL``, else
    None."""
    if form(nf) != FORM_GLOBAL:
        return None
    return torch.empty((n_blocks, 2, nf), dtype=_F32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_stage(stage_idx, first, dc, params, fr, fi, arrs, vel_prev):
    """K2's first launch on the card: (vel_re, vel_im, eta, w_re, w_im,
    partials (n_blocks / cluster_size(nf), 2, nf) float64)."""
    dev, nf, m = fr.device, fr.shape[0], arrs["eta"].shape[0]
    lib = _library()
    params = _params_host(params)
    with torch.cuda.device(dev):
        n_blocks = lib.pic_stage_grid(stage_idx, int(first), int(dc), m, nf)
        if n_blocks < 1:
            raise RuntimeError(f"pic_stage: no grid for stage {stage_idx}, "
                               f"first={first}, dc={dc}, m={m}, nf={nf}")
        outs = [torch.empty(m, dtype=_F32, device=dev) for _ in range(5)]
        partials = torch.empty((n_blocks // cluster_size(nf), 2, nf),
                               dtype=torch.float64, device=dev)
        scratch = _scratch(n_blocks, nf, dev)
        vpre, vpim = vel_prev if vel_prev is not None else (None, None)
        err = lib.pic_stage_launch(
            stage_idx, int(first), int(dc), params.ctypes.data,
            fr.data_ptr(), fi.data_ptr(),
            *(arrs[k].data_ptr() for k in MARKERS), _ptr(vpre), _ptr(vpim),
            *(o.data_ptr() for o in outs), partials.data_ptr(),
            _ptr(scratch), m, nf, n_blocks, _stream(dev))
    _raise_on(err, "pic_stage launch")
    LAUNCHES["pic_stage"] += 1
    return (*outs, partials)


def _launch_field(partials, qn):
    """K2's second launch: the field planes from the blocks' partial
    histograms, summed in a fixed order."""
    dev = qn.device
    n_part, _, nf = partials.shape
    _check_partials(partials, dev)
    fro = torch.empty(nf, dtype=_F32, device=dev)
    fio = torch.empty(nf, dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _library().pic_field_launch(
            partials.data_ptr(), n_part, qn.data_ptr(), fro.data_ptr(),
            fio.data_ptr(), nf, _stream(dev))
    _raise_on(err, "pic_field launch")
    LAUNCHES["pic_field"] += 1
    return fro, fio


def mega_grid(device, nf: int, dc: bool) -> dict:
    """K3's launch shape on ``device``: {"sms", "grid" (co-resident blocks,
    one a SM; in ``FORM_CLUSTER`` the co-resident clusters times their size,
    which may leave SMs out; 0 where none fits), "threads", "cluster" (blocks
    a cluster, 1 outside ``FORM_CLUSTER``), "clusters" (grid / cluster),
    "partials" (one a cluster: grid / cluster), "smem" (bytes of dynamic
    shared memory: a SM's whole share in ``FORM_SHARED``, what the form
    needs in the others), "registers", "cooperative", "form"}."""
    out = [ctypes.c_int() for _ in range(7)]
    with torch.cuda.device(device):
        err = _library().pic_mega_grid(int(dc), nf,
                                       *(ctypes.byref(v) for v in out))
    _raise_on(err, "pic_mega occupancy query")
    sms, grid, smem, regs, coop, cluster, clusters = (v.value for v in out)
    return {"sms": sms, "grid": grid, "threads": THREADS, "cluster": cluster,
            "clusters": clusters, "partials": grid // cluster, "smem": smem,
            "registers": regs, "cooperative": bool(coop), "form": form(nf)}


def _launch_mega(dc, params, fr, fi, qn, arrs, n_steps, parts=3):
    """K3 on the card.  ``parts``: 3 for a run; 1 leaves the field reduce
    out and 2 the marker pass, and ``| PART_NO_DEPOSIT`` the marker pass's
    deposit, to time each by difference."""
    global LAST_MEGA_GRID
    dev, nf, m = fr.device, fr.shape[0], arrs["eta"].shape[0]
    shape = mega_grid(dev, nf, dc)
    if shape["grid"] < 1:
        raise RuntimeError(f"pic_mega: no block of {THREADS} threads fits a "
                           f"SM at nf={nf}")
    params = _params_host(params)
    eta, wre, wim = (arrs[k].clone() for k in ("eta", "w_re", "w_im"))
    vel = torch.zeros((2, m), dtype=_F32, device=dev)
    carry = torch.empty((3, m), dtype=_F32, device=dev)
    partials = torch.empty((shape["partials"], 2, nf), dtype=torch.float64,
                           device=dev)
    fbuf = torch.empty((2, 2, nf), dtype=_F32, device=dev)
    tile_stats = torch.empty((2 * nf // TILE, 2), dtype=torch.float64,
                             device=dev)
    stats = torch.empty((n_steps, 3), dtype=_F32, device=dev)
    scratch = _scratch(shape["grid"], nf, dev)
    with torch.cuda.device(dev):
        err = _library().pic_mega_launch(
            int(dc), params.ctypes.data, fr.data_ptr(), fi.data_ptr(),
            qn.data_ptr(), eta.data_ptr(), arrs["v_para"].data_ptr(),
            arrs["v_perp"].data_ptr(), wre.data_ptr(), wim.data_ptr(),
            arrs["odv"].data_ptr(), arrs["ost"].data_ptr(),
            arrs["pw"].data_ptr(), vel[0].data_ptr(), vel[1].data_ptr(),
            carry.data_ptr(), partials.data_ptr(), fbuf.data_ptr(),
            tile_stats.data_ptr(), stats.data_ptr(), _ptr(scratch), n_steps,
            m, nf, shape["grid"], shape["smem"], parts, _stream(dev))
    _raise_on(err, f"pic_mega cooperative launch ({shape['grid']} blocks "
                   f"in clusters of {shape['cluster']})")
    LAUNCHES["pic_mega"] += 1
    LAST_MEGA_GRID = shape
    out = fbuf[(3 * n_steps) % 2]
    return eta, wre, wim, out[0], out[1], stats


def _launch_probe(x, rounds, copy, cluster):
    dev = x.device
    nblocks, slice_ = x.shape
    bufs = torch.empty((2, nblocks, slice_), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _library().grid_sync_probe_launch(
            x.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(), nblocks,
            slice_, rounds, int(copy), cluster, _stream(dev))
    _raise_on(err, f"grid_sync_probe cooperative launch ({nblocks} blocks "
                   f"in clusters of {cluster})")
    LAUNCHES["grid_sync_probe"] += 1
    return bufs[(rounds + 1) % 2]


# ---------------------------------------------------------------------------
# wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------

def _route(device):
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused PIC: no kernel for device {device}")
    return device.type == "cuda"


def stage(stage_idx: int, first: bool, dc: bool, params, fr, fi, qn, arrs,
          vel_prev=None):
    """One RK3 stage over all markers (K2: ``pic_stage`` + ``pic_field``).
    ``params``: the (16,) float32 block of ``FusedStep.params_vec``;
    ``vel_prev``: stage 1's (vel_re, vel_im), stage 2 only.  Returns
    (vel_re, vel_im, eta, w_re, w_im, field_re, field_im)."""
    if stage_idx not in (0, 1, 2) or (first and stage_idx != 0) \
            or ((stage_idx == 2) != (vel_prev is not None)):
        raise ValueError(f"bad stage variant: stage={stage_idx}, "
                         f"first={first}, vel_prev given="
                         f"{vel_prev is not None}")
    dev, _, _ = _check_inputs(fr, fi, qn, arrs, vel_prev)
    if not _route(dev):
        return stage_ref(stage_idx, first, dc, params, fr, fi, qn, arrs,
                         vel_prev)
    *outs, partials = _launch_stage(stage_idx, first, dc, params, fr, fi,
                                    arrs, vel_prev)
    return (*outs, *_launch_field(partials, qn))


def mega(dc: bool, params, fr, fi, qn, arrs, n_steps: int):
    """The whole run in one launch (K3).  Returns (eta, w_re, w_im,
    field_re, field_im, stats (n_steps, 3)); the input arrays are not
    modified."""
    dev, _, _ = _check_inputs(fr, fi, qn, arrs)
    if not _route(dev):
        return mega_ref(dc, params, fr, fi, qn, arrs, n_steps)
    return _launch_mega(dc, params, fr, fi, qn, arrs, n_steps)


def grid_sync_probe(x, rounds: int = PROBE_ROUNDS, copy: bool = True,
                    cluster: int = 1):
    """K4 on (nblocks, slice) float32 x, one cooperative block of
    ``THREADS`` threads per row, one block a SM as K3 runs, in clusters of
    ``cluster`` blocks as K3's ``FORM_CLUSTER`` launch (1: none).
    ``copy=False`` runs the launch and its barriers without the loads and
    stores (its result is scratch): the floor of the kernel's time, and at
    two round counts the cost of a grid barrier."""
    if x.dim() != 2 or rounds < 1:
        raise ValueError("grid_sync_probe takes (nblocks, slice) and rounds "
                         ">= 1")
    if cluster not in (1, 2, 4, CLUSTER_MAX) or x.shape[0] % cluster:
        raise ValueError(f"grid_sync_probe: clusters of 1, 2, 4 or "
                         f"{CLUSTER_MAX} blocks that divide nblocks, got "
                         f"{cluster} for {x.shape[0]}")
    _check("x", x, x.shape, x.device)
    if not _route(x.device):
        return grid_sync_probe_ref(x, rounds)
    return _launch_probe(x, rounds, copy, cluster)


_SELFCHECK: dict = {}


def grid_sync_selfcheck(device, nf: int, dc: bool):
    """Once per process and (device, nf, dc): can K3 run?  On the card:
    the cooperative-launch attribute, K3's co-resident grid at nf, and K4
    at that grid and cluster size (the runtime takes the cooperative and
    the cluster attributes together).  On the CPU the plain probe stands
    in.  Returns (ok, info) with info["reason"] set when not ok."""
    device = torch.device(device)
    key = (str(device), nf, dc)
    if key not in _SELFCHECK:
        info = {"reason": None}
        n_blocks, cluster = 4, 1
        if _route(device):
            shape = mega_grid(device, nf, dc)
            info.update(shape)
            n_blocks, cluster = shape["grid"], shape["cluster"]
            if not shape["cooperative"]:
                info["reason"] = "the device has no cooperative launch"
            elif n_blocks < 1:
                info["reason"] = f"no block of K3 fits a SM at nf={nf}"
        if info["reason"] is None:
            gen = torch.Generator(device=device).manual_seed(0)
            x = torch.rand((n_blocks, THREADS), generator=gen, dtype=_F32,
                           device=device)
            same = host_read(torch.equal, grid_sync_probe(x, cluster=cluster),
                             grid_sync_probe_ref(x))
            if not same:
                info["reason"] = ("the grid-sync probe failed: a block did "
                                  "not see another block's writes")
        _SELFCHECK[key] = (info["reason"] is None, info)
    return _SELFCHECK[key]
