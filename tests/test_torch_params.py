"""emme_tpu_torch parameters, geometry and grid vs the reference micro-goldens
and vs emme_tpu (the JAX package is the oracle; float64 on the CPU)."""
import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import emme_tpu
import emme_tpu.grid
import emme_tpu_torch as et
from emme_tpu_torch import convert
from emme_tpu_torch.grid import Grid
from emme_tpu_torch.params import (DYNAMIC_FIELDS, STATIC_FIELDS,
                                   default_device)

torch.set_num_threads(2)

GEOMETRIES = ["tokamak", "stellarator", "cylinder", "cylinder_old",
              "taloyMagneticDrift"]


def _load(goldens_dir, name):
    with open(goldens_dir / name) as f:
        return json.load(f)


def _derived(p):
    return {k: float(getattr(p, k))
            for k in ("alpha", "omega_s_i", "omega_s_e", "omega_d_bar")}


@pytest.mark.parametrize("name", GEOMETRIES)
def test_geometry_vs_micro_goldens(goldens_dir, name):
    """Bars of tests/test_kernels.py:28-45: derived scalars 1e-13, g
    1e-8 (1 + max), bi 1e-12 (1 + max)."""
    p = et.from_config(_load(goldens_dir, f"inputs/{name}.json"),
                       device="cpu")
    gold = _load(goldens_dir, f"micro_{name}.json")
    d = gold["derived"]
    mine = _derived(p)
    assert abs(mine["alpha"] - d["alpha"]) < 1e-13 + 1e-13 * abs(d["alpha"])
    for k in ("omega_s_i", "omega_s_e", "omega_d_bar"):
        assert abs(mine[k] - d[k]) < 1e-13, k
    etas = torch.tensor(gold["eta_samples"], dtype=torch.float64)
    g = p.g(etas).numpy()
    bi = p.bi(etas).numpy()
    g_ref = np.array(gold["g_integration_f"])
    bi_ref = np.array(gold["bi"])
    assert np.abs(g - g_ref).max() < 1e-8 * (1 + np.abs(g_ref).max())
    assert np.abs(bi - bi_ref).max() < 1e-12 * (1 + np.abs(bi_ref).max())


@pytest.mark.parametrize("name", GEOMETRIES)
def test_geometry_matches_emme_tpu(goldens_dir, name):
    """Same inputs, float64: fields, derived scalars, g, bi and beta_1 equal
    to emme_tpu's within 1e-14 relative to their scale."""
    cfg = _load(goldens_dir, f"inputs/{name}.json")
    pj = emme_tpu.from_config(cfg)
    pt = et.from_config(cfg, device="cpu")
    for f in DYNAMIC_FIELDS:   # cyl_shat_coeff: a bisection, then sin/cos
        ref = float(np.asarray(getattr(pj, f)))
        assert abs(float(getattr(pt, f)) - ref) <= 1e-14 * abs(ref), f
    for f in STATIC_FIELDS:
        assert getattr(pt, f) == getattr(pj, f), f
    dj, dt = _derived(pj), _derived(pt)
    for k in dj:
        assert abs(dt[k] - dj[k]) <= 1e-14 * max(abs(dj[k]), 1e-300), k
    rng = np.random.default_rng(7)
    L = float(cfg["length"])
    eta = rng.uniform(-L, L, 64)
    eta_p = rng.uniform(-L, L, 64)
    te, tp = torch.tensor(eta), torch.tensor(eta_p)
    je, jp = jnp.asarray(eta), jnp.asarray(eta_p)
    for mine, ref in ((pt.g(te), pj.g(je)), (pt.bi(te), pj.bi(je)),
                      (pt.beta_1(te, tp), pj.beta_1(je, jp))):
        ref = np.asarray(ref)
        assert np.abs(mine.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_params_from_arrays_round_trip(tokamak_cfg, stellarator_cfg, dtype):
    """A JAX Params handed over as numpy arrays builds the same port Params
    as the port's own from_config, field for field."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for cfg in (tokamak_cfg, stellarator_cfg):
        pj = emme_tpu.from_config(cfg, dtype=jdt)
        fields = {f: np.asarray(getattr(pj, f)) for f in DYNAMIC_FIELDS}
        static = {f: getattr(pj, f) for f in STATIC_FIELDS}
        pc = convert.params_from_arrays(fields, static, dtype=tdt,
                                        device="cpu")
        pt = et.from_config(cfg, dtype=tdt, device="cpu")
        for f in DYNAMIC_FIELDS:
            assert getattr(pc, f).dtype == tdt
            assert torch.equal(getattr(pc, f), getattr(pt, f)), f
        for f in STATIC_FIELDS:
            assert getattr(pc, f) == getattr(pt, f), f
        assert _derived(pc) == _derived(pt)
    with pytest.raises(KeyError):
        convert.params_from_arrays({}, static, device="cpu")


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-15), ("float32", 1e-7)])
def test_grid_matches_emme_tpu(dtype, rtol):
    gj = emme_tpu.grid.Grid.create(20.0, 33, dtype=getattr(jnp, dtype))
    gt = Grid.create(20.0, 33, dtype=getattr(torch, dtype), device="cpu")
    assert gt.eta.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(gt.eta.numpy(), np.asarray(gj.eta),
                               rtol=0, atol=rtol * 20.0)
    assert float(gt.dx) == float(gj.dx)


def test_default_device_is_the_card_and_never_the_cpu_quietly(tokamak_cfg,
                                                              monkeypatch):
    """from_config, the convert functions and every constructor that takes
    a device land on the CUDA card when given none; with no CUDA device
    they raise and name device="cpu" instead of falling to the CPU."""
    from emme_tpu_torch.ops import singularity, sparse
    from emme_tpu_torch.solvers import arnoldi
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        et.from_config(tokamak_cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.state_from_arrays(0j, 0j, np.eye(2), np.eye(2))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.bdia_from_arrays(np.zeros((1, 1, 2, 2, 2)), (0,), 2, 2)
    for bare in (lambda: Grid.create(20.0, 33),
                 lambda: singularity.singularity_coeff_matrix(8),
                 lambda: singularity.singularity_coeff_band(8, 2),
                 lambda: sparse.bsr_from_dense(np.eye(4), block=2),
                 lambda: sparse.bdia_from_dense(np.eye(4), block=2),
                 lambda: sparse.load_bdia_dump("nowhere"),
                 lambda: arnoldi.arnoldi_factorization(lambda x: x, 4, 2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            bare()
    assert et.from_config(tokamak_cfg, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
