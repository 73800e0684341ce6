"""The fused PIC path of the port (emme_tpu_torch.solvers.cuda_pic) on CPU
tensors, where each wrapper runs its kernel's plain version: against the
JAX XLA path (pic.run) and, once, the Pallas kernels in interpret mode, at
the bars of tests/test_pallas_pic.py.  The CUDA kernels themselves are held
to these plain versions in test_torch_cuda.py."""
import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
from emme_tpu.solvers import pallas_pic
from emme_tpu.solvers import pic as jpic
import emme_tpu_torch as et
from emme_tpu_torch import _build, convert
from emme_tpu_torch.solvers import cuda_pic, pic

torch.set_num_threads(2)

CSRC = pathlib.Path(cuda_pic.__file__).resolve().parent.parent / "csrc"
BARS = {"eta": 2e-5, "weight": 2e-5, "field": 2e-5, "j0": 2e-5,
        "dc_pb": 1e-4}   # tests/test_pallas_pic.py:39-48


def _params(cfg, dc=True, n=128):
    cfg = dict(cfg, npoints=n, drift_center_transformation_switch=dc)
    return (emme_tpu.from_config(cfg, dtype=jnp.float32),
            et.from_config(cfg, dtype=torch.float32))


def _start(pj, mpc, key):
    s = jpic.init_state(pj, mpc, key, dtype=jnp.float32)
    return convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s, k)) for k in s.__dataclass_fields__},
        dtype=torch.float32)


def _assert_close(stats, state, stats_ref, state_ref):
    stats_ref = np.asarray(stats_ref)
    assert np.abs(stats.numpy() - stats_ref).max() \
        / np.abs(stats_ref).max() < 1e-5
    for name, bar in BARS.items():
        a = getattr(state, name).numpy()
        b = np.asarray(getattr(state_ref, name))
        assert a.dtype == b.dtype, name
        assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-30) < bar, name


@pytest.mark.parametrize("dc", [True, False])
def test_stages_match_jax_xla(tokamak_cfg, dc):
    """launch='stages' on the CPU (stage_ref), tok n=128, 8 markers per
    cell, 2 steps, f32, both weight equations: within the Pallas kernel's
    bars of JAX pic.run; no kernel is launched."""
    pj, pt = _params(tokamak_cfg, dc)
    key = jax.random.PRNGKey(3 if dc else 5)
    stats_j, s_j, _ = jpic.run(pj, 8, 2, 0.25, key=key)
    before = dict(cuda_pic.LAUNCHES)
    stats, s, extra = cuda_pic.run(pt, 8, 2, 0.25, state=_start(pj, 8, key),
                                   launch="stages")
    assert cuda_pic.LAUNCHES == before and cuda_pic.LAST_LAUNCH == "stages"
    assert extra is None and stats.shape == (2, 3)
    _assert_close(stats, s, stats_j, s_j)


def test_stages_match_pallas_interpret(tokamak_cfg):
    """The same bars against the Pallas kernels themselves (interpret mode,
    precision='highest'), drift-center on."""
    pj, pt = _params(tokamak_cfg)
    key = jax.random.PRNGKey(3)
    stats_p, s_p, _ = pallas_pic.run(pj, 8, 2, 0.25, key=key,
                                     precision="highest", interpret=True)
    stats, s, _ = cuda_pic.run(pt, 8, 2, 0.25, state=_start(pj, 8, key),
                               launch="stages")
    _assert_close(stats, s, stats_p, s_p)


def test_single_equals_stages(tokamak_cfg):
    """launch='single' (mega_ref) walks exactly the stages trajectory on
    the CPU (the test_pallas_pic.py:93-114 analogue); 'auto' takes it."""
    _, pt = _params(tokamak_cfg)
    s0 = pic.init_state(pt, 8, torch.Generator().manual_seed(2),
                        dtype=torch.float32)
    runs = {}
    for launch in ("stages", "single", "auto"):
        runs[launch] = cuda_pic.run(pt, 8, 3, 0.25, state=s0, launch=launch)
        want = "stages" if launch == "stages" else "single"
        assert cuda_pic.LAST_LAUNCH == want
    for launch in ("single", "auto"):
        assert torch.equal(runs[launch][0], runs["stages"][0])
        for name in ("eta", "weight", "field", "j0", "dc_pb"):
            assert torch.equal(getattr(runs[launch][1], name),
                               getattr(runs["stages"][1], name)), name


def test_failed_selfcheck_is_loud(tokamak_cfg, monkeypatch):
    """When the grid-sync self-check fails, 'auto' takes K2 with a warning
    and records it; 'single' raises."""
    _, pt = _params(tokamak_cfg)
    monkeypatch.setattr(cuda_pic, "grid_sync_selfcheck", lambda *a: (
        False, {"reason": "no cooperative launch"}))
    with pytest.warns(RuntimeWarning, match="no cooperative launch"):
        cuda_pic.run(pt, 8, 1, 0.25)
    assert cuda_pic.LAST_LAUNCH == "stages"
    with pytest.raises(RuntimeError, match="no cooperative launch"):
        cuda_pic.run(pt, 8, 1, 0.25, launch="single")


def test_run_from_generator(tokamak_cfg):
    """Without a state, run draws from the generator: one seed, one run."""
    _, pt = _params(tokamak_cfg)
    a = cuda_pic.run(pt, 8, 1, 0.25, generator=torch.Generator().manual_seed(4))
    b = cuda_pic.run(pt, 8, 1, 0.25, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a[0], b[0]) and bool(torch.isfinite(a[0]).all())


def test_guards(tokamak_cfg):
    """What the Pallas path refuses, the port refuses (test_pallas_pic.py:
    62-71, 103-106), plus its own shared-memory bound on npoints."""
    _, p96 = _params(tokamak_cfg, n=96)
    with pytest.raises(ValueError, match="npoints"):
        cuda_pic.run(p96, 16, 2, 0.25)
    _, pt = _params(tokamak_cfg)
    with pytest.raises(ValueError, match="markers"):
        cuda_pic.run(pt, 4, 2, 0.25)
    p64 = et.from_config(dict(tokamak_cfg, npoints=128))
    with pytest.raises(ValueError, match="f32"):
        cuda_pic.run(p64, 16, 2, 0.25)
    with pytest.raises(ValueError, match="launch"):
        cuda_pic.run(pt, 8, 2, 0.25, launch="nope")
    with pytest.raises(ValueError, match="precision"):
        cuda_pic.run(pt, 8, 2, 0.25, precision="bf16")
    _, big = _params(tokamak_cfg, n=cuda_pic.MAX_NF + 128)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_pic.run(big, 8, 2, 0.25)


def test_params_vec_matches_pallas(tokamak_cfg):
    """The float32 scalar block equals the Pallas one (pallas_pic.py:
    371-379), sub_dt per stage as the stage loop computes it (:393)."""
    pj, pt = _params(tokamak_cfg)
    mine = cuda_pic.FusedStep.params_vec(pt, 0.25)
    theirs, dtf = pallas_pic._FusedStep(pj, 128 * 8, 0.25).params_vec(pj, 0.25)
    theirs = np.asarray(theirs)[0]
    for k_mine, k_pallas in ((cuda_pic.P_L, pallas_pic._P_L),
                             (cuda_pic.P_CW, pallas_pic._P_CW),
                             (cuda_pic.P_VT, pallas_pic._P_VT),
                             (cuda_pic.P_BT, pallas_pic._P_BT),
                             (cuda_pic.P_SHAT, pallas_pic._P_SHAT),
                             (cuda_pic.P_ODB, pallas_pic._P_ODB),
                             (cuda_pic.P_QR, pallas_pic._P_QR),
                             (cuda_pic.P_I2CW, pallas_pic._P_I2CW)):
        assert mine[k_mine] == theirs[k_pallas]
    for s in range(3):
        sub = np.asarray(float(pallas_pic.RK_COEF[s][s + 1]) * dtf)
        assert mine[cuda_pic.P_SUBDT + s] == sub
    assert mine[cuda_pic.P_CPREV] == np.float32(pallas_pic.RK_COEF[2][1])
    assert mine[cuda_pic.P_CCUR] == np.float32(pallas_pic.RK_COEF[2][2])


def test_stage_wrapper_validates(tokamak_cfg):
    """The stage wrapper refuses variants and tensors the kernel does not
    take, before any launch."""
    _, pt = _params(tokamak_cfg)
    s0 = pic.init_state(pt, 8, torch.Generator().manual_seed(1),
                        dtype=torch.float32)
    fs = cuda_pic.FusedStep(pt, 1024, 0.25)
    arrs = cuda_pic.state_to_arrs(s0)
    fr, fi = s0.field.real.contiguous(), s0.field.imag.contiguous()
    qn = pic.quasi_neutrality_coef(pt, dtype=torch.float32)
    with pytest.raises(ValueError, match="variant"):
        cuda_pic.stage(1, True, True, fs.params, fr, fi, qn, arrs)
    with pytest.raises(ValueError, match="variant"):
        cuda_pic.stage(2, False, True, fs.params, fr, fi, qn, arrs)
    with pytest.raises(ValueError, match="float32"):
        cuda_pic.stage(0, True, True, fs.params, fr.double(), fi, qn, arrs)
    with pytest.raises(ValueError, match="float32"):
        cuda_pic.mega(True, fs.params, fr, fi, qn,
                      dict(arrs, eta=arrs["eta"][::2]), 1)


def test_grid_sync_probe_plain():
    """The plain probe is the rounds written out: block b reads block
    (b + s) mod n, doubles; on a CPU tensor the wrapper runs it and the
    self-check passes without a launch."""
    x = torch.rand((7, 32), generator=torch.Generator().manual_seed(0))
    bufs = [x.clone(), torch.empty_like(x)]
    for s in range(1, cuda_pic.PROBE_ROUNDS + 1):
        src, dst = bufs[(s - 1) % 2], bufs[s % 2]
        for b in range(7):
            dst[b] = 2.0 * src[(b + s) % 7]
    before = dict(cuda_pic.LAUNCHES)
    assert torch.equal(cuda_pic.grid_sync_probe(x),
                       bufs[cuda_pic.PROBE_ROUNDS % 2])
    assert cuda_pic.grid_sync_selfcheck("cpu", 1024, True)[0]
    assert cuda_pic.LAUNCHES == before


def test_kernel_source_matches_wrapper():
    """pic.cu cannot be compiled here: hold its layout constants to the
    wrapper's, and check the build keeps IEEE math and the eta advance is
    written without contraction."""
    src = (CSRC / "pic.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxNf") == cuda_pic.MAX_NF
    assert const("kThreads") == cuda_pic.THREADS
    assert const("kParams") == cuda_pic.N_PARAMS
    for name in ("L", "CW", "VT", "BT", "SHAT", "ODB", "QR", "I2CW", "SUBDT",
                 "CPREV", "CCUR"):
        assert const(f"kP_{name}") == getattr(cuda_pic, f"P_{name}"), name
    assert "grid.sync()" in src and "cudaLaunchCooperativeKernel" in src
    assert "__fdiv_rn(m, two_l)" in src
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
