"""The quadrature guard's plain version in its two pieces against the guard
as it was written before them and against emme_tpu's, on the CPU.

``eigen.guard_pairs`` (each sampled pair's |K|, embedded error and tier gap
through the torch integrand: what kernels G and R compute on the card) and
``eigen.guard_report`` (the float64 test: what R does after) are held
together to the single-loop guard they were cut from, kept below as
``_guard_as_before``, to the last bit, and to ``emme_tpu``'s
``quadrature_guard`` through ``_guard_matches``.  Cases: electrostatic
tiered at n = 32 and 128, electromagnetic with three moments, a band
``max_dij``, a regime that fires the flags (``BAD_OMEGA``) and the golden
omega, where the guard is silent.  float64 throughout, as emme_tpu's own
guard tests run, so that flags near the threshold cannot flip between
the two packages; float32 parameters on the CPU take the same route.
"""
import numpy as np
import pytest
import torch

import emme_tpu
from emme_tpu.grid import Grid as JGrid
from emme_tpu.solvers import eigen as jeigen
import emme_tpu_torch as et
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.ops import cuda_assembly, cuda_guard, kernels, quadrature
from emme_tpu_torch.solvers import eigen

torch.set_num_threads(2)

GOLDEN_OMEGA = -0.574227 + 0.274304j   # tests/test_eigen.py:114
BAD_OMEGA = -6.0 + 0.001j              # tests/test_eigen.py:128
STEL_OMEGA = -1.656 + 2.49j            # the stellarator's guess
CHUNK = 64

# name: (input, npoints, omega, guard keywords, tiered, fires)
CASES = {
    "tok32_golden_tiered": ("tokamak", 32, GOLDEN_OMEGA,
                            dict(sample=496), True, False),
    "tok32_bad": ("tokamak", 32, BAD_OMEGA, dict(sample=496), False, True),
    "tok128_golden_tiered": ("tokamak", 128, GOLDEN_OMEGA,
                             dict(sample=160, seed=5), True, False),
    "tok128_bad_tiered": ("tokamak", 128, BAD_OMEGA,
                          dict(sample=160, seed=7), True, True),
    "tok128_band": ("tokamak", 128, GOLDEN_OMEGA,
                    dict(sample=160, seed=3, max_dij=20), True, False),
    "stel24_em_tiered": ("stellarator", 24, STEL_OMEGA,
                         dict(sample=96, seed=1), True, None),
}


def _case(name, tokamak_cfg, stellarator_cfg, dtype=torch.float64):
    inp, n, om, kw, tiered, fires = CASES[name]
    cfg = dict(tokamak_cfg if inp == "tokamak" else stellarator_cfg,
               npoints=n)
    pt = et.from_config(cfg, dtype=dtype, device="cpu")
    gt = Grid.create(pt.length, n, dtype=dtype, device="cpu")
    kw = dict(kw)
    if tiered:
        kw["tiers"] = kernels.tier_thresholds_ij(float(gt.dx), n)
    return cfg, pt, gt, om, kw, fires


def _guard_as_before(p, grid, omega, quad=None, chunk=2048, sample=4096,
                     seed=0, tiers=None, max_dij=None):
    """``eigen.quadrature_guard`` as it was before its split: one loop over
    the tier groups, each group's values read to the host and tested
    there."""
    n = grid.npoints
    iu, ju = eigen._sample_pairs(n, sample, seed, max_dij)
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    rdtype = grid.eta.dtype
    om = torch.tensor(complex(omega), dtype=kernels.complex_dtype(rdtype))
    dij = ju - iu
    groups, lo = [], 0
    for ij_ub, scale in (tiers or ((n + 1, 1.0),)):
        m = (dij >= lo) & (dij < ij_ub)
        lo = ij_ub
        if m.any():
            groups.append((np.flatnonzero(m), scale))
    acc = float(p.integration_accuracy)
    prec = float(p.integration_precision)
    n_sampled = n_flagged = 0
    max_abs_err = max_rel_err = 0.0
    for idx, scale in groups:
        q_t = kernels.scaled_quad(quad, rdtype, scale) \
            if scale != 1.0 else None
        ea = grid.eta[torch.as_tensor(iu[idx])]
        eb = grid.eta[torch.as_tensor(ju[idx])]
        absks, errs, tdiffs = ([[] for _ in ms] for _ in range(3))
        for s in range(0, len(idx), chunk):
            a, b = ea[s:s + chunk], eb[s:s + chunk]
            vals, err = kernels.kappa_f_tau(p, a, b, om, ms=ms, quad=quad)
            tvals = kernels.kappa_f_tau(p, a, b, om, ms=ms, quad=q_t)[0] \
                if q_t is not None else ()
            for k, v in enumerate(vals):
                absks[k].append(v.abs())
                errs[k].append(err[k])
                if q_t is not None:
                    tdiffs[k].append((tvals[k] - v).abs())

        def host(parts):
            return [torch.cat(v).double().numpy() for v in parts]

        absks, errs = host(absks), host(errs)
        tdiffs = host(tdiffs) if q_t is not None else None
        flagged = np.zeros(len(idx), bool)
        for k, (absk, err) in enumerate(zip(absks, errs)):
            thresh = np.maximum(acc, prec * absk)
            flagged |= err > thresh
            if tdiffs is not None:
                flagged |= tdiffs[k] > thresh
                err = np.maximum(err, tdiffs[k])
            max_abs_err = max(max_abs_err, float(err.max()))
            max_rel_err = max(
                max_rel_err, float((err / np.maximum(absk, 1e-300)).max()))
        n_sampled += len(idx)
        n_flagged += int(flagged.sum())
    return {"n_sampled": n_sampled,
            "frac_flagged": n_flagged / max(n_sampled, 1),
            "max_abs_err": max_abs_err, "max_rel_err": max_rel_err}


def _guard_matches(g, gj):
    """As tests/test_torch_eigen_methods.py: the same counts, the largest
    error within 1e-8 relative plus 1e-16 of emme_tpu's."""
    assert g["n_sampled"] == gj["n_sampled"]
    assert g["frac_flagged"] == gj["frac_flagged"]
    assert abs(g["max_abs_err"] - gj["max_abs_err"]) \
        <= 1e-8 * gj["max_abs_err"] + 1e-16
    assert set(g) == set(gj)


@pytest.mark.parametrize("name", list(CASES))
def test_guard_pieces_equal_the_guard_as_before(name, tokamak_cfg,
                                                stellarator_cfg):
    """``guard_report(*guard_pairs(...))`` equals the one-loop guard to the
    last bit: the same integrand calls, the same float64 test.  The pieces
    keep the sample's group order and give one row a pair."""
    _cfg, pt, gt, om, kw, fires = _case(name, tokamak_cfg, stellarator_cfg)
    absk, err, gap = eigen.guard_pairs(pt, gt, om, chunk=CHUNK, **kw)
    ms = 3 if pt.electromagnetic else 1
    assert absk.shape == err.shape == gap.shape == (kw["sample"], ms)
    acc, prec = pt.integration_accuracy, pt.integration_precision
    got = eigen.guard_report(absk, err, gap, acc, prec)
    want = _guard_as_before(pt, gt, om, chunk=CHUNK, **kw)
    assert got == want
    _iu, _ju, groups = eigen.guard_sample(gt.npoints, kw["sample"],
                                          kw.get("seed", 0), kw.get("tiers"),
                                          kw.get("max_dij"))
    start = np.cumsum([0] + [len(idx) for idx, _ in groups])
    for k, (_idx, spec) in enumerate(groups):
        if spec == 1.0:   # the base mesh alone: no gap
            assert float(gap[start[k]:start[k + 1]].abs().sum()) == 0.0
    if fires is not None:
        assert (got["frac_flagged"] > 0.01) == fires
        assert (got["frac_flagged"] == 0.0) == (not fires)


@pytest.mark.parametrize("name", list(CASES))
def test_guard_torch_route_matches_emme_tpu(name, tokamak_cfg,
                                            stellarator_cfg):
    """``quadrature_guard`` on CPU tensors takes the torch route (counted in
    ``GUARD_ROUTE``) and reports emme_tpu's counts and largest error."""
    cfg, pt, gt, om, kw, _fires = _case(name, tokamak_cfg, stellarator_cfg)
    pj = emme_tpu.from_config(cfg)
    gj = JGrid.create(pj.length, cfg["npoints"])
    before = dict(eigen.GUARD_ROUTE)
    g = eigen.quadrature_guard(pt, gt, om, chunk=CHUNK, **kw)
    assert eigen.GUARD_ROUTE == {"kernels": before["kernels"],
                                 "torch": before["torch"] + 1}
    _guard_matches(g, jeigen.quadrature_guard(pj, gj, om, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_guard_route_on_the_cpu_is_torch(dtype, tokamak_cfg,
                                         stellarator_cfg):
    """Float32 and float64 parameters on the CPU, K1 asked for or not: the
    torch route, whose report is the pieces'."""
    _cfg, pt, gt, om, kw, _fires = _case("tok32_golden_tiered", tokamak_cfg,
                                         stellarator_cfg, dtype)
    for fused in (None, True, False):
        before = dict(eigen.GUARD_ROUTE)
        g = eigen.quadrature_guard(pt, gt, om, chunk=CHUNK, fused=fused, **kw)
        assert eigen.GUARD_ROUTE == {"kernels": before["kernels"],
                                     "torch": before["torch"] + 1}
        want = eigen.guard_report(
            *eigen.guard_pairs(pt, gt, om, chunk=CHUNK, **kw),
            pt.integration_accuracy, pt.integration_precision)
        assert g == want and g["n_sampled"] == 496


def test_guard_report_reads_nan_as_kernel_r():
    """A NaN value flags nothing and is passed over by the maxima, as
    kernel R's comparisons and fmax do; the maxima start at 0."""
    absk = torch.tensor([[1.0, 2.0], [float("nan"), 1.0]])
    err = torch.tensor([[1e-9, 3e-3], [1e-3, float("nan")]])
    gap = torch.tensor([[0.0, 0.0], [0.0, 1e-7]])
    g = eigen.guard_report(absk, err, gap, 1e-6, 1e-6)
    assert g["n_sampled"] == 2 and g["frac_flagged"] == 0.5
    assert g["max_abs_err"] == pytest.approx(3e-3)
    assert g["max_rel_err"] == pytest.approx(1.5e-3)
    empty = eigen.guard_report(*(torch.zeros((0, 1)),) * 3, 1e-6, 1e-6)
    assert empty == {"n_sampled": 0, "frac_flagged": 0.0,
                     "max_abs_err": 0.0, "max_rel_err": 0.0}


@pytest.mark.parametrize("name", ["tok128_bad_tiered", "tok128_band",
                                  "stel24_em_tiered"])
def test_guard_kernel_plan_lays_out_the_sample(name, tokamak_cfg,
                                              stellarator_cfg):
    """The kernels' plan, made here on the CPU: a set a (group, mesh), the
    base mesh for every group and the tier mesh beside it where the table
    scales it, in P's layout; each sampled pair's rows in G's output name
    its own pair in those sets, in the plain version's order; G's table is
    K1's followed by the embedded Gauss weights."""
    _cfg, pt, gt, _om, kw, _fires = _case(name, tokamak_cfg, stellarator_cfg,
                                          torch.float32)
    n = gt.npoints
    iu, ju, groups = eigen.guard_sample(n, kw["sample"], kw.get("seed", 0),
                                        kw["tiers"], kw.get("max_dij"))
    ms = (0, 1, 2) if pt.electromagnetic else (0,)
    plan = eigen._guard_plan(n, ms, (kw["sample"], kw.get("seed", 0),
                                     kw["tiers"], kw.get("max_dij")),
                             None, int(pt.integration_start_points), "cpu")
    assert plan is eigen._guard_plan(
        n, ms, (kw["sample"], kw.get("seed", 0), kw["tiers"],
                kw.get("max_dij")), None,
        int(pt.integration_start_points), "cpu")   # made once
    assert plan.n_sampled == kw["sample"] and plan.ms == ms
    assert len(plan.tiers) == sum(1 + (spec != 1.0) for _, spec in groups)
    assert len(plan.tiers) <= cuda_assembly.MAX_TIERS
    set_i = set_j = np.zeros(0, np.int64)
    for t in plan.tiers:
        set_i = np.concatenate([set_i, t.iu.numpy()])
        set_j = np.concatenate([set_j, t.ju.numpy()])
    assert plan.total == len(set_i)
    rows = plan.rows.numpy()
    order = np.concatenate([idx for idx, _ in groups])
    assert np.array_equal(set_i[rows[:, 0]], iu[order])
    assert np.array_equal(set_j[rows[:, 0]], ju[order])
    tiered = rows[:, 1] >= 0
    assert np.array_equal(set_i[rows[tiered, 1]], iu[order][tiered])
    k = 0
    for idx, spec in groups:
        assert plan.tiers[k].counts == (8, 32, 4)   # the float32 preset
        if spec != 1.0:
            q = kernels.scaled_quad(None, torch.float32, spec)
            k += 1
            assert plan.tiers[k].counts == (q["n_shoulder"], q["n_osc"],
                                            q["n_tail"])
        k += 1
    want_tiers, size, meta = cuda_assembly.layout(
        [(t.iu, t.ju, dict(zip(("n_shoulder", "n_osc", "n_tail"),
                               t.counts))) for t in plan.tiers], None,
        plan.order)
    assert size == plan.size and [t.counts for t in want_tiers] \
        == [t.counts for t in plan.tiers]
    tab = cuda_guard.rule_tables(plan.order)
    _x, _wk, wg = quadrature.gk_rule(plan.order)
    assert tab.size == 185 and np.array_equal(tab[-31:][:plan.order],
                                              wg.astype(np.float32))


@pytest.mark.parametrize("name", ["tok128_bad_tiered", "tok128_band",
                                  "stel24_em_tiered"])
def test_guard_pair_values_read_rows_as_guard_pairs(name, tokamak_cfg,
                                                    stellarator_cfg):
    """``cuda_guard.pair_values`` on rows laid out as kernel G writes them
    (each set's values and errors without K1's prefactor, here from the
    torch integrand on the CPU) gives ``guard_pairs``' |K|, error and tier
    gap pair by pair, to float32 rounding of the values' scale: each
    sampled pair reads its own base row, and its tier row or none."""
    _cfg, pt, gt, om, kw, _fires = _case(name, tokamak_cfg, stellarator_cfg,
                                         torch.float32)
    n = gt.npoints
    ms = (0, 1, 2) if pt.electromagnetic else (0,)
    key = (kw["sample"], kw.get("seed", 0), kw["tiers"], kw.get("max_dij"))
    plan = eigen._guard_plan(n, ms, key, None,
                             int(pt.integration_start_points), "cpu")
    _iu, _ju, groups = eigen.guard_sample(n, *key)
    quads = []
    for _idx, spec in groups:
        quads.append(None)
        if spec != 1.0:
            quads.append(kernels.scaled_quad(None, torch.float32, spec))
    _points, scalars = cuda_assembly.point_rows(pt, gt)
    i_r, i_i = (cuda_assembly.SCALARS.index(k) for k in ("pref_r", "pref_i"))
    pref = torch.complex(scalars[i_r], scalars[i_i])
    omega = torch.tensor(om, dtype=torch.complex64)
    out = []
    for t, quad in zip(plan.tiers, quads):
        vals, errs = kernels.kappa_f_tau(pt, gt.eta[t.iu], gt.eta[t.ju],
                                         omega, ms=ms, quad=quad)
        raw = [v / pref for v in vals]
        out.append(torch.stack([c for r in raw for c in (r.real, r.imag)]
                               + [e / pref.abs() for e in errs], dim=1))
    out = torch.cat(out)
    assert out.shape == (plan.total, 3 * len(ms))
    got = cuda_guard.pair_values(plan, out, scalars)
    want = eigen.guard_pairs(pt, gt, om, chunk=CHUNK, **kw)
    scale = float(want[0].max())
    for g, w in zip(got, want):
        assert g.shape == w.shape == (kw["sample"], len(ms))
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * scale)
    assert bool((got[2][plan.rows[:, 1] < 0] == 0).all())
    assert bool((got[2][plan.rows[:, 1] >= 0] > 0).any())
