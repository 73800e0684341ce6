"""The port's plain PIC path (emme_tpu_torch.solvers.pic) and the J0/J1/i0e
Bessel functions against emme_tpu on the CPU.  torch and jax.random draw
different numbers, so trajectories start both packages from one JAX-built
state (convert.pic_state_from_arrays)."""
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.special import jv

import emme_tpu
from emme_tpu.ops import bessel as jbessel
from emme_tpu.solvers import pic as jpic
import emme_tpu_torch as et
from emme_tpu_torch import convert
from emme_tpu_torch.ops import bessel
from emme_tpu_torch.solvers import pic

torch.set_num_threads(2)


def _to_port(s, dtype=torch.float64):
    return convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s, k)) for k in s.__dataclass_fields__},
        device="cpu", dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def tok64(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=64)
    return emme_tpu.from_config(cfg), et.from_config(cfg, device="cpu")


# ---------------------------------------------------------------------------
# Bessel J0 / J1 / i0e
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,order", [("bessel_j0", 0), ("bessel_j1", 1)])
def test_j01_vs_scipy(name, order):
    """1e-9 absolute against scipy on [-40, 40] at f64 (the JAX package's
    bar, tests/test_bessel.py:52-56)."""
    x = np.linspace(-40, 40, 4001)
    got = getattr(bessel, name)(torch.tensor(x)).numpy()
    assert np.abs(got - jv(order, x)).max() < 1e-9


@pytest.mark.parametrize("name", ["bessel_j0", "bessel_j1"])
def test_j01_vs_jax(name):
    """Equal to the JAX function to 1e-14 at f64, and to 1e-6 at f32 on the
    arguments PIC reaches (|x| up to ~25, both branches), where the f32
    Taylor sum cancels near |x| = 8 and only the same term order agrees."""
    x = np.linspace(-40, 40, 4001)
    ref = np.asarray(getattr(jbessel, name)(jnp.array(x)))
    assert np.abs(getattr(bessel, name)(torch.tensor(x)).numpy()
                  - ref).max() < 1e-14
    x32 = np.linspace(-30, 30, 60001).astype(np.float32)
    got = getattr(bessel, name)(torch.tensor(x32))
    assert got.dtype == torch.float32
    ref32 = np.asarray(getattr(jbessel, name)(jnp.array(x32)))
    assert np.abs(got.numpy() - ref32).max() < 1e-6


def test_i0e_vs_jax():
    x = np.linspace(0.0, 60.0, 601)
    got = bessel.bessel_i0e(torch.tensor(x)).numpy()
    assert np.abs(got - np.asarray(jbessel.bessel_i0e(jnp.array(x)))).max() \
        < 1e-14


# ---------------------------------------------------------------------------
# set-up: quasi-neutrality, marker loading
# ---------------------------------------------------------------------------

def test_quasi_neutrality_coef(tok64, tokamak_cfg):
    """f64 within 1e-13 relative of JAX; an f32 Params gives f32 values."""
    pj, pt = tok64
    ref = np.asarray(jpic.quasi_neutrality_coef(pj))
    got = pic.quasi_neutrality_coef(pt)
    assert got.dtype == torch.float64 and got.shape == (64,)
    assert _rel(got.numpy(), ref) < 1e-13
    p32 = et.from_config(dict(tokamak_cfg, npoints=64), dtype=torch.float32,
                         device="cpu")
    got32 = pic.quasi_neutrality_coef(p32, dtype=torch.float32)
    assert got32.dtype == torch.float32
    assert _rel(got32.numpy(), ref) < 1e-6


def test_init_state_formulas_from_jax_draws(tok64):
    """state_from_draws on the JAX package's own random draws gives its
    init_state, field by field (pic.py:87-114); j0, dc_pb, field start at
    zero."""
    pj, pt = tok64
    key = jax.random.PRNGKey(11)
    n = 8 * 64
    k1, k2, k3, k4 = jax.random.split(key, 4)
    L = float(pj.length)
    draws = [jax.random.uniform(k1, (n,), jnp.float64, -L, L),
             jax.random.normal(k2, (n,), jnp.float64),
             jax.random.normal(k3, (n,), jnp.float64),
             jax.random.uniform(k4, (n,), jnp.float64, 0.0, 0.001)]
    got = pic.state_from_draws(pt, *(torch.tensor(np.asarray(d))
                                     for d in draws))
    ref = jpic.init_state(pj, 8, key)
    for name in ref.__dataclass_fields__:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert np.abs(a - b).max() <= 1e-13 * max(np.abs(b).max(), 1.0), name


def test_init_state_generator(tok64):
    """init_state draws from the generator: reproducible per seed, eta in
    [-L, L), v_perp >= 0, p_weight normalized to 2L."""
    _, pt = tok64
    a = pic.init_state(pt, 4, torch.Generator().manual_seed(5))
    b = pic.init_state(pt, 4, torch.Generator().manual_seed(5))
    L = float(pt.length)
    assert torch.equal(a.eta, b.eta) and a.eta.shape == (256,)
    assert float(a.eta.min()) >= -L and float(a.eta.max()) < L
    assert float(a.v_perp.min()) >= 0.0
    assert float(a.p_weight.sum()) == pytest.approx(2.0 * L, rel=1e-12)
    assert a.weight.dtype == torch.complex128
    assert not a.j0.any() and not a.dc_pb.any() and not a.field.any()


def test_deposition_charge_conservation(tok64):
    """Total deposited charge equals the sum of den (test_pic.py:64-76)."""
    _, pt = tok64
    s = pic.init_state(pt, 16, torch.Generator().manual_seed(1))
    qn = pic.quasi_neutrality_coef(pt)
    s2 = pic.solve_field(pt, s, qn)
    assert bool(torch.isfinite(s2.field).all())
    assert float(s2.j0.abs().max()) > 0
    den = (s2.j0 * s.weight * s2.dc_pb).sum()
    total = (s2.field / qn).sum()
    assert abs(complex(total - den)) < 1e-10 * abs(complex(den))


def test_unported_cic_forms_raise(tok64):
    """A CIC form name that neither package has raises a ValueError naming
    the forms there are ('take' / 'matmul' / 'bf16' gathers, 'segment' /
    'matmul' / 'bf16' deposits), where emme_tpu runs its one-hot form for
    any unknown name (a deliberate deviation, ROADMAP.md Queue 3)."""
    _, pt = tok64
    with pytest.raises(ValueError, match="'segment'.*'take', 'matmul'"):
        pic.run(pt, 4, 1, 0.25, gather_method="segment")
    with pytest.raises(ValueError, match="'take'.*'segment', 'matmul'"):
        pic.run(pt, 4, 1, 0.25, deposit_method="take")
    with pytest.raises(ValueError, match="'fp8'"):
        pic.run(pt, 4, 1, 0.25, gather_method="fp8")


# ---------------------------------------------------------------------------
# RK3
# ---------------------------------------------------------------------------

def test_rk3_harmonic_oscillator():
    """x'' = -x with the 3-stage tableau: within 1e-5 of sin/cos over
    t in [0, 10] (test_pic.py:13-32, the reference's test_integrator.cpp)."""
    s = torch.tensor([0.0, 1.0], dtype=torch.float64)
    vel = lambda st: torch.stack([st[1], -st[0]])
    upd = lambda st, v, dt: st + v * dt
    for _ in range(1000):
        s, v = pic.rk3_generic(s, vel, upd, 0.01)
    assert abs(float(s[0]) - np.sin(10.0)) < 1e-5
    assert abs(float(s[1]) - np.cos(10.0)) < 1e-5
    err = pic.rk3_error_estimate(v, 0.01, lambda c, dt: torch.linalg.norm(c * dt))
    assert float(err) < 1e-4


def test_run_matches_jax_f64(tok64):
    """3 steps at f64 from the JAX-built state: stats and field within
    1e-10 relative of JAX pic.run; the rest of the state too."""
    pj, pt = tok64
    key = jax.random.PRNGKey(3)
    stats_j, s_j, _ = jpic.run(pj, 8, 3, 0.25, key=key)
    stats_t, s_t, fields = pic.run(pt, 8, 3, 0.25,
                                   state=_to_port(jpic.init_state(pj, 8, key)),
                                   record_fields=True)
    assert stats_t.shape == (3, 3) and fields.shape == (3, 64)
    assert torch.equal(fields[-1], s_t.field)
    assert _rel(stats_t.numpy(), stats_j) < 1e-10
    for name in ("field", "eta", "weight", "j0", "dc_pb"):
        assert _rel(getattr(s_t, name).numpy(), getattr(s_j, name)) < 1e-10, \
            name


def test_step_adaptive_matches_jax(tok64):
    """Adaptive halving/doubling with rollback (test_pic.py:181-195) takes
    the JAX package's steps and lands on its state."""
    pj, pt = tok64
    key = jax.random.PRNGKey(5)
    sj0 = jpic.init_state(pj, 8, key)
    st0 = _to_port(sj0)
    qn_j = jpic.quasi_neutrality_coef(pj)
    qn_t = pic.quasi_neutrality_coef(pt)
    for up, lo in ((1e-4, 1e-12), (1e-9, 1e-14)):
        s_j, dt_j, nx_j = jpic.step_adaptive(pj, sj0, 0.25, qn_j, up, lo)
        s_t, dt_t, nx_t = pic.step_adaptive(pt, st0, 0.25, qn_t, up, lo)
        assert (dt_t, nx_t) == (dt_j, nx_j)
        assert _rel(s_t.field.numpy(), s_j.field) < 1e-10
    assert dt_t < 0.25   # the tight bound halved


def test_run_adaptive_matches_jax(tok64):
    """run_adaptive: the same accepted step times and stats as JAX, and a
    finite nonuniform fit (test_pic.py:213-222)."""
    pj, pt = tok64
    key = jax.random.PRNGKey(4)
    bounds = dict(upper_err_bound=1e-2, lower_err_bound=1e-3)
    t_j, st_j, _ = jpic.run_adaptive(pj, 8, 0.5, 0.25, key=key, **bounds)
    t_t, st_t, _ = pic.run_adaptive(
        pt, 8, 0.5, 0.25, state=_to_port(jpic.init_state(pj, 8, key)),
        **bounds)
    assert np.array_equal(t_t, t_j)
    assert len(t_t) == 8 and t_t[0] < 0.25   # halved, then doubled back
    assert t_t[-1] == pytest.approx(0.5, abs=1e-12)
    assert _rel(st_t, st_j) < 1e-10
    om = pic.calculate_omega_nonuniform(t_t, st_t)
    assert om == pytest.approx(jpic.calculate_omega_nonuniform(t_j, st_j),
                               rel=1e-10)


# ---------------------------------------------------------------------------
# (omega, gamma) fits
# ---------------------------------------------------------------------------

def _fit_series():
    dt, gam, w, n = 0.25, 0.21, 0.83, 180
    t = np.arange(1, n + 1) * dt
    grow = np.exp(gam * t)
    return dt, np.stack([grow * np.cos(w * t) + 1e-3 * np.sin(3.1 * t),
                         grow * np.sin(w * t),
                         grow * (1.0 + 0.01 * np.sin(1.7 * t))], axis=1)


def test_omega_fit_views_golden(goldens_dir):
    """Both gamma conventions against the reference binary compiled each way
    (test_pic.py:276-298, tests/goldens/omega_fit.json), from a tensor."""
    with open(goldens_dir / "omega_fit.json") as f:
        g = json.load(f)
    dt, stats = _fit_series()
    for views, want in ((False, g["plain"]), (True, g["views"])):
        om = pic.calculate_omega(torch.tensor(stats), dt, views=views)
        assert om.real == pytest.approx(want[0], rel=1e-12)
        assert om.imag == pytest.approx(want[1], rel=1e-12)


def test_calculate_omega_fft_matches_jax():
    """The sign-resolving FFT fit equals the JAX package's on the same
    stats: the golden series and a signed synthetic mode."""
    dt, stats = _fit_series()
    t = dt * np.arange(200)
    phi = np.exp((0.2 + 0.83j) * t) * (0.3 - 0.1j)
    signed = np.stack([phi.real, phi.imag, np.abs(phi)], axis=1)
    for s in (stats, signed):
        assert pic.calculate_omega_fft(s, dt) == jpic.calculate_omega_fft(s, dt)
    assert pic.calculate_omega_fft(signed, dt).real == pytest.approx(-0.83,
                                                                     rel=5e-3)


def test_init_state_draws_no_zero_v_para(tok64, monkeypatch):
    """A v_para draw of exactly 0 (drift-center phase q R / v_para = inf,
    a NaN deposit) is drawn again from the same generator: with a normal
    draw that yields zeros twice, init_state redraws until none is left,
    and the state is finite."""
    _, pt = tok64
    real_randn = torch.randn
    calls = []

    def randn(*size, **kw):
        out = real_randn(*size, **kw)
        calls.append(out.numel())
        if len(calls) <= 2:
            out[:3] = 0.0
        return out

    monkeypatch.setattr(torch, "randn", randn)
    s = pic.init_state(pt, 4, torch.Generator().manual_seed(5))
    assert calls[:3] == [4 * 64, 3, 3]
    assert bool((s.v_para != 0).all())
    assert all(bool(torch.isfinite(getattr(s, k)).all())
               for k in ("v_para", "v_perp", "p_weight", "omega_dv"))
