"""emme_tpu_torch.ops (quadrature, singularity, bessel, kernels) vs emme_tpu
and the reference micro-goldens, float64 on the CPU."""
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
import emme_tpu.grid
from emme_tpu.ops import bessel as jbessel
from emme_tpu.ops import kernels as jkernels
from emme_tpu.ops import quadrature as jquadrature
from emme_tpu.ops import singularity as jsingularity
import emme_tpu_torch as et
from emme_tpu_torch.ops import bessel, kernels, quadrature, singularity

torch.set_num_threads(2)


@pytest.mark.parametrize("order", sorted(jquadrature._GK))
def test_gk_rule_equals_emme_tpu(order):
    for mine, ref in zip(quadrature.gk_rule(order), jquadrature.gk_rule(order)):
        assert np.array_equal(mine, ref)


@pytest.mark.parametrize("n,dtype", [(8, "float64"), (33, "float64"),
                                     (33, "float32")])
def test_singularity_coeff_matrix_equals_emme_tpu(n, dtype):
    mine = singularity.singularity_coeff_matrix(
        n, dtype=getattr(torch, dtype), device="cpu")
    ref = np.asarray(jsingularity.singularity_coeff_matrix(
        n, dtype=getattr(jnp, dtype)))
    assert mine.dtype == getattr(torch, dtype)
    assert np.array_equal(mine.numpy(), ref)
    if n == 8:   # the entries tests/test_eigen.py:17-24 pins
        C = mine.numpy()
        assert C[0, 0] == pytest.approx(0.0 - 0.5)
        assert C[2, 3] == pytest.approx(2.951388888888883)
        assert C[2, 7] == pytest.approx(1.159722222222284 - 0.5)
        assert C[0, 6] == pytest.approx(1.0)


def test_bessel_i01_scaled_matches_emme_tpu():
    """Seeded z over |z| in [0, 30] at every phase (both branches, both
    half-planes) plus edge points: i0, i1 within 1e-13 relative, zs exact.

    Relative to what: in the Taylor branch (|w| <= 12) near the imaginary
    axis the series cancels -- its terms sum in magnitude to I_n(|w|)
    e^{-Re w}, up to 1e4 times the value -- so last-bit differences in the
    two frameworks' complex arithmetic grow by that factor.  There the bar
    is 1e-13 of that sum; in the asymptotic branch it is 1e-13 of |value|."""
    from scipy.special import ive

    rng = np.random.default_rng(11)
    r = rng.uniform(0.0, 30.0, 4000)
    th = rng.uniform(0.0, 2 * np.pi, 4000)
    z = np.concatenate([r * np.exp(1j * th), [0.0, 12.0, -12.0, 11.9 + 1j]])
    aw = np.abs(z)
    assert (aw > 12).any() and (aw < 12).any() and (z.real < 0).any()
    mine = bessel.bessel_i01_scaled(torch.tensor(z))
    ref = jbessel.bessel_i01_scaled(jnp.asarray(z))
    assert np.array_equal(mine[2].numpy(), np.asarray(ref[2]))
    for n in (0, 1):
        f = np.asarray(ref[n])
        series = np.where(aw <= 12.0,
                          ive(n, aw) * np.exp(aw - np.abs(z.real)), 0.0)
        bar = 1e-13 * np.maximum(np.abs(f), series)
        assert np.all(np.abs(mine[n].numpy() - f) <= bar)


def _sample_z(n, max_mag, seed):
    """tests/test_bessel.py's sample: |z| log-uniform in [1e-3, max_mag],
    every phase."""
    rng = np.random.default_rng(seed)
    mag = 10 ** rng.uniform(-3, np.log10(max_mag), n)
    ang = rng.uniform(-np.pi, np.pi, n)
    return mag * np.exp(1j * ang)


def _relerr(a, b):
    return np.abs(a - b) / (np.abs(b) + 1e-300)


def test_bessel_miller_matches_emme_tpu_and_scipy():
    """bessel_i01_scaled_miller (the reference's Miller recurrence, static
    loop bounds 64 / 160) at tests/test_bessel.py:29-43's samples: within
    1e-12 relative of emme_tpu's, zs exact; within 1e-7 of scipy iv times
    exp(zs) (|z| <= 80); within 1e-6 of the fast form (|z| <= 60); I0 = 1,
    I1 = 0 at z = 0."""
    from scipy.special import iv

    z = _sample_z(1000, 80.0, 1)
    mine = [v.numpy() for v in bessel.bessel_i01_scaled_miller(
        torch.tensor(z))]
    ref = [np.asarray(v) for v in jbessel.bessel_i01_scaled_miller(
        jnp.asarray(z))]
    assert np.array_equal(mine[2], ref[2])
    for n in (0, 1):
        assert _relerr(mine[n], ref[n]).max() < 1e-12
        assert _relerr(mine[n], iv(n, z) * np.exp(mine[2])).max() < 1e-7
    z = _sample_z(500, 60.0, 2)
    fast = bessel.bessel_i01_scaled(torch.tensor(z))
    slow = bessel.bessel_i01_scaled_miller(torch.tensor(z))
    for n in (0, 1):
        assert _relerr(fast[n].numpy(), slow[n].numpy()).max() < 1e-6
    i0, i1, _ = bessel.bessel_i01_scaled_miller(
        torch.tensor([0.0 + 0.0j], dtype=torch.complex128))
    assert i0.item() == 1.0 and i1.item() == 0.0


def test_integrate_fixed_matches_emme_tpu():
    """integrate_fixed at tests/test_quadrature.py:27-40's bars: a Gaussian
    over 16 panels of [-8, 8] to 1e-13 with an embedded error under 1e-10,
    and a decaying complex oscillation over 64 panels of [0, 50] to 1e-12;
    each within 1e-14 of emme_tpu's value (the same nodes and weights, summed
    in another order)."""
    bounds = quadrature.linear_bounds(torch.tensor(-8.0, dtype=torch.float64),
                                      torch.tensor(8.0, dtype=torch.float64),
                                      16)
    val, err = quadrature.integrate_fixed(lambda t: torch.exp(-t ** 2),
                                          bounds)
    jval, _ = jquadrature.integrate_fixed(
        lambda t: jnp.exp(-t ** 2),
        jquadrature.linear_bounds(jnp.array(-8.0), jnp.array(8.0), 16))
    assert abs(val.item() - np.sqrt(np.pi)) < 1e-13 and err.item() < 1e-10
    assert abs(val.item() - float(jval)) < 1e-14
    bounds = quadrature.linear_bounds(torch.tensor(0.0, dtype=torch.float64),
                                      torch.tensor(50.0, dtype=torch.float64),
                                      64)
    val, _ = quadrature.integrate_fixed(
        lambda t: torch.exp((3j - 0.2) * t), bounds)
    jval, _ = jquadrature.integrate_fixed(
        lambda t: jnp.exp((1j * 3.0 - 0.2) * t),
        jquadrature.linear_bounds(jnp.array(0.0), jnp.array(50.0), 64))
    exact = (np.exp((3j - 0.2) * 50) - 1) / (3j - 0.2)
    assert abs(val.item() - exact) < 1e-12
    assert abs(val.item() - complex(jval)) < 1e-14


@pytest.fixture(scope="module")
def tok32(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    pj = emme_tpu.from_config(cfg)
    pt = et.from_config(cfg, device="cpu")
    iu, ju = np.triu_indices(32, k=1)
    eta = np.asarray(emme_tpu.grid.Grid.create(pj.length, 32).eta)
    return pj, pt, eta[iu], eta[ju]


def test_transit_panel_bounds_matches_emme_tpu(tok32):
    pj, pt, ea, eb = tok32
    om = -0.8 + 0.25j
    ref = np.asarray(jkernels.transit_panel_bounds(
        pj, jnp.abs(jnp.asarray(ea - eb)), jnp.complex128(om)))
    mine = kernels.transit_panel_bounds(
        pt, torch.tensor(np.abs(ea - eb)),
        torch.tensor(om, dtype=torch.complex128)).numpy()
    assert mine.shape == ref.shape
    assert np.all(np.abs(mine - ref) <= 1e-13 * np.abs(ref))


def test_kappa_f_tau_matches_emme_tpu(tok32):
    """All tok32 pairs, float64: values and embedded errors within 1e-12 of
    the values' scale.  (The errors are |K - G| of two nearly equal sums,
    ~1e-12 of the values here, so they carry rounding noise of the values'
    size; the values' scale is the one they are read against.)"""
    pj, pt, ea, eb = tok32
    om = -0.8 + 0.25j
    (vj,), (errj,) = jax.jit(lambda a, b: jkernels.kappa_f_tau(
        pj, a, b, jnp.complex128(om), ms=(0,)))(jnp.asarray(ea),
                                               jnp.asarray(eb))
    (vt,), (errt,) = kernels.kappa_f_tau(
        pt, torch.tensor(ea), torch.tensor(eb),
        torch.tensor(om, dtype=torch.complex128), ms=(0,))
    vj, errj = np.asarray(vj), np.asarray(errj)
    scale = np.abs(vj).max()
    assert np.abs(vt.numpy() - vj).max() <= 1e-12 * scale
    assert np.abs(errt.numpy() - errj).max() <= 1e-12 * scale


def test_kappa_vs_tokamak_micro_goldens(goldens_dir, tokamak_cfg):
    """kappa_f_tau (+ kappa_f_tau_e) vs the reference's own values at the
    tokamak bars of tests/test_kernels.py:100-102 (rtol 2e-2, median
    1e-7, abs floor 1e-9 of the per-omega scale; electron 1e-10)."""
    with open(goldens_dir / "micro_tokamak.json") as f:
        gold = json.load(f)
    p = et.from_config(tokamak_cfg, device="cpu")
    by_m = {}
    for c in gold["kappa_cases"]:
        by_m.setdefault(c["m"], []).append(c)
    rels = []
    for m, cs in by_m.items():
        eta = torch.tensor([float(c["eta"]) for c in cs], dtype=torch.float64)
        etap = torch.tensor([float(c["etap"]) for c in cs], dtype=torch.float64)
        omegas = np.array([complex(*c["omega"]) for c in cs])
        ref_i = np.array([complex(*c["kappa_i"]) for c in cs])
        ref_e = np.array([complex(*c["kappa_e"]) for c in cs])
        for om in np.unique(omegas):
            sel = np.where(omegas == om)[0]
            omt = torch.tensor(complex(om), dtype=torch.complex128)
            (vals,), _ = kernels.kappa_f_tau(p, eta[sel], etap[sel], omt,
                                             ms=(m,))
            mine = vals.numpy()
            rel = np.abs(mine - ref_i[sel]) / (np.abs(ref_i[sel]) + 1e-30)
            scale = np.abs(ref_i[sel]).max() + 1e-30
            ok = (rel < 2e-2) | (np.abs(mine - ref_i[sel]) < 1e-9 * scale)
            assert ok.all(), (m, om, rel.max())
            rels.extend(rel.tolist())
            if m > 0:
                mine_e = kernels.kappa_f_tau_e(p, eta[sel], etap[sel], omt,
                                               m).numpy()
                rel_e = np.abs(mine_e - ref_e[sel]) / (np.abs(ref_e[sel]) + 1e-30)
                assert rel_e.max() < 1e-10
    assert np.median(np.array(rels)) < 1e-7


@pytest.mark.parametrize("m", [0, 1, 2])
def test_kappa_f_tau_e_matches_emme_tpu(stellarator_cfg, m):
    pj = emme_tpu.from_config(stellarator_cfg)
    pt = et.from_config(stellarator_cfg, device="cpu")
    rng = np.random.default_rng(3)
    ea, eb = rng.uniform(-10, 10, 50), rng.uniform(-10, 10, 50)
    om = -1.656 + 2.49j
    ref = np.asarray(jkernels.kappa_f_tau_e(pj, jnp.asarray(ea),
                                            jnp.asarray(eb),
                                            jnp.complex128(om), m))
    mine = kernels.kappa_f_tau_e(pt, torch.tensor(ea), torch.tensor(eb),
                                 torch.tensor(om, dtype=torch.complex128),
                                 m).numpy()
    assert mine.shape == ref.shape
    assert np.abs(mine - ref).max() <= 1e-14 * max(np.abs(ref).max(), 1.0)


def test_tier_tables_and_scaled_quad_equal_emme_tpu():
    assert kernels.TIER_TABLE == jkernels.TIER_TABLE
    assert kernels.PANEL_PRESETS == jkernels.PANEL_PRESETS
    for dx, n in ((40 / 31, 32), (40 / 1023, 1024)):
        assert (kernels.tier_thresholds_ij(dx, n)
                == jkernels.tier_thresholds_ij(dx, n))
    refined = {"n_shoulder": 16, "n_osc": 64, "n_tail": 8, "order": 31}
    for (_, spec) in kernels.TIER_TABLE:
        for quad in (None, refined):
            for tdt, jdt in ((torch.float32, jnp.float32),
                             (torch.float64, jnp.float64)):
                assert (kernels.scaled_quad(quad, tdt, spec)
                        == jkernels.scaled_quad(quad, jdt, spec))
