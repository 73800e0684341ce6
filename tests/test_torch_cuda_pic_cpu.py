"""The fused PIC path of the port (emme_tpu_torch.solvers.cuda_pic) on CPU
tensors, where each wrapper runs its kernel's plain version: against the
JAX XLA path (pic.run) and, once, the Pallas kernels in interpret mode, at
the bars of tests/test_pallas_pic.py.  The CUDA kernels themselves are held
to these plain versions in test_torch_cuda.py."""
import pathlib
import re
from fractions import Fraction

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
            et.from_config(cfg, dtype=torch.float32, device="cpu"))


def _start(pj, mpc, key):
    s = jpic.init_state(pj, mpc, key, dtype=jnp.float32)
    return convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s, k)) for k in s.__dataclass_fields__},
        device="cpu", dtype=torch.float32)


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
    62-71, 103-106), and no more: npoints 16,384, past the shared-memory
    field of the small-grid form, is accepted."""
    _, p96 = _params(tokamak_cfg, n=96)
    with pytest.raises(ValueError, match="npoints"):
        cuda_pic.run(p96, 16, 2, 0.25)
    _, pt = _params(tokamak_cfg)
    with pytest.raises(ValueError, match="markers"):
        cuda_pic.run(pt, 4, 2, 0.25)
    p64 = et.from_config(dict(tokamak_cfg, npoints=128), device="cpu")
    with pytest.raises(ValueError, match="f32"):
        cuda_pic.run(p64, 16, 2, 0.25)
    with pytest.raises(ValueError, match="launch"):
        cuda_pic.run(pt, 8, 2, 0.25, launch="nope")
    with pytest.raises(ValueError, match="precision"):
        cuda_pic.run(pt, 8, 2, 0.25, precision="bf16")
    _, big = _params(tokamak_cfg, n=16384)
    fs = cuda_pic.FusedStep(big, 8 * 16384, 0.25)
    assert fs.nf == 16384 and cuda_pic.form(fs.nf) == cuda_pic.FORM_CLUSTER
    assert cuda_pic.cluster_size(fs.nf) == 1


@pytest.mark.parametrize("nf,want", [
    (128, cuda_pic.FORM_SHARED), (12288, cuda_pic.FORM_SHARED),
    (12416, cuda_pic.FORM_CLUSTER), (16384, cuda_pic.FORM_CLUSTER),
    (27648, cuda_pic.FORM_CLUSTER), (27776, cuda_pic.FORM_CLUSTER),
    (32768, cuda_pic.FORM_CLUSTER), (55296, cuda_pic.FORM_CLUSTER),
    (224256, cuda_pic.FORM_CLUSTER), (224384, cuda_pic.FORM_GLOBAL)])
def test_form_is_chosen_by_npoints(nf, want):
    """The kernels' form (where the field and the histogram live) is a
    function of npoints alone, with the thresholds of csrc/pic.cu: the
    cluster form from the first multiple of 128 past the small-grid form up
    to its cap, 224,256 points (8 ranks of 28,032 columns), the scratch row
    above it."""
    assert cuda_pic.form(nf) == want
    assert cuda_pic.CLUSTER_NF == 224256


def _cluster_rule(nf):
    """csrc/pic.cu's cluster size, from its byte count: the smallest of
    1, 2, 4, 8 blocks whose slice, two float planes of nf / cs columns, fits
    a block's shared memory beside the field reduce's static table (a double
    for each warp and column of a tile); None where the small-grid form
    takes nf (up to kSharedNf) or no cluster fits."""
    src = (CSRC / "pic.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    if nf <= const("kSharedNf"):
        return None
    per_block = const("kSmemPerBlock")
    reduce_bytes = const("kThreads") // 32 * const("kTile") * 8
    for cs in (1, 2, 4, 8):
        if 2 * (nf // cs) * 4 + reduce_bytes <= per_block:
            return cs
    return None


@pytest.mark.parametrize("nf", [128, 12288, 16384, 27648, 27776, 32768,
                                55296, 56064, 56192, 65536, 112128, 112256,
                                131072, 224256, 224384, 12416, 28032, 28160])
def test_cluster_size_and_slice_follow_the_byte_count(nf):
    """cuda_pic.cluster_size against a mirror of csrc/pic.cu's rule
    computed from the kernel's byte count: the smallest cluster of 1, 2, 4
    or 8 whose slice fits a block; a slice of nf / cs whole columns, each
    rank the same width, no wider than CLUSTER_SLICE_NF.  The small-grid
    form below and the scratch-row form past the cap launch no cluster."""
    cs = _cluster_rule(nf)
    if cs is None:
        assert cuda_pic.form(nf) != cuda_pic.FORM_CLUSTER
        assert cuda_pic.cluster_size(nf) == 1
        return
    assert cuda_pic.form(nf) == cuda_pic.FORM_CLUSTER
    assert cuda_pic.cluster_size(nf) == cs
    assert nf % cs == 0 and nf // cs <= cuda_pic.CLUSTER_SLICE_NF
    assert cs == 1 or nf // (cs // 2) > cuda_pic.CLUSTER_SLICE_NF


def test_large_grid_run_matches_jax_xla(tokamak_cfg, monkeypatch):
    """npoints 16,384 (past the small-grid form), 8 markers per cell, 2
    steps, dt 0.25, f32, drift-center: the fused run's plain version on the
    CPU (launch 'auto' takes mega_ref) against JAX pic.run from the same
    markers, at the Pallas kernel's bars.

    At this size a float32 run is ill-conditioned: a cell's field is the
    small sum of ~16 weights of both signs times a coefficient of 200-370,
    and over 131,072 markers the tails of v_para put the drift-center phase
    at 1e5-1e6 radians.  From this key JAX's own float32 run sits 2.7e-4
    (statistics) to 3.3e-3 (field) of scale from its float64 run and 1.4
    from it on dc_pb, while the port and JAX part by 1.1e-3 (weights,
    field) and 7.8e-3 (dc_pb).  So a quantity past its bar against JAX's
    float32 run must be no further from JAX's float64 run (the same
    markers, cast) than 1.5 times JAX's float32 run is: the port as
    accurate as the JAX package at this size.  eta never sees the field
    and is held to its bar alone."""
    _large_grid_vs_jax(tokamak_cfg, monkeypatch, 16384, 8)


def test_cluster_grid_run_matches_jax_xla(tokamak_cfg, monkeypatch):
    """npoints 65,536, the cluster form's size on the card (clusters of
    4), 4 markers per cell, 2 steps: the fused run's plain version against
    JAX pic.run from the same markers, held as at 16,384 (the Pallas bars,
    or no further from JAX's float64 run than 1.5 times JAX's own float32
    run; eta to its bar).  From this key the port and JAX's float32 run
    part by 2.1e-3 (weights), 2.6e-3 (field) and 7.8e-3 (dc_pb) of scale;
    JAX's float32 run sits 8.5e-3 and 6.1e-3 from its float64 run, the
    port 8.5e-3 and 7.1e-3.
    """
    assert cuda_pic.cluster_size(65536) == 4
    _large_grid_vs_jax(tokamak_cfg, monkeypatch, 65536, 4)


def _large_grid_vs_jax(tokamak_cfg, monkeypatch, n, mpc):
    """The fused run (launch 'auto', mega_ref on the CPU) against JAX
    pic.run at n grid points, mpc markers per cell, 2 steps, dt 0.25,
    float32, drift-center, with JAX's float64 run from the same markers as
    the judge where the float32 runs part past a bar."""
    pj, pt = _params(tokamak_cfg, n=n)
    pj64 = emme_tpu.from_config(dict(tokamak_cfg, npoints=n),
                                dtype=jnp.float64)
    key = jax.random.PRNGKey(3)
    stats_j, s_j, _ = jpic.run(pj, mpc, 2, 0.25, key=key)
    s32 = jpic.init_state(pj, mpc, key, dtype=jnp.float32)
    s64 = type(s32)(**{k: jnp.asarray(v, jnp.complex128 if jnp.iscomplexobj(v)
                                      else jnp.float64)
                       for k, v in vars(s32).items()})
    monkeypatch.setattr(jpic, "init_state", lambda *a, **k: s64)
    stats_64, s_64, _ = jpic.run(pj64, mpc, 2, 0.25, key=key)
    stats, s, _ = cuda_pic.run(pt, mpc, 2, 0.25, state=_start(pj, mpc, key))
    assert cuda_pic.LAST_LAUNCH == "single" and stats.shape == (2, 3)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    got = {"stats": (stats.numpy(), stats_j, stats_64)}
    for name in BARS:
        got[name] = tuple(np.asarray(getattr(x, name)) if x is not s
                          else getattr(s, name).numpy()
                          for x in (s, s_j, s_64))
    for name, (port, j32, j64) in got.items():
        bar = BARS.get(name, 1e-5)
        if name == "eta":
            assert rel(port, j32) < bar, name
        elif rel(port, j32) >= bar:
            assert rel(port, j64) <= 1.5 * rel(j32, j64), name


@pytest.mark.parametrize("dt,finite", [(0.25, False), (0.0625, True)])
def test_large_grid_growth_in_both_packages(tokamak_cfg, dt, finite):
    """The scheme itself, in both packages, is what limits a large grid:
    at npoints 4,096 (16 markers per cell, 40 steps) dt 0.25 lets the
    grid-scale mode, whose growth rate goes with 1 / cell width, carry the
    field's statistics past float32 in emme_tpu's pic.run and in the
    port's fused run alike; dt 0.25 x 1024 / 4096 keeps both finite.  So
    the card's large-grid checks scale dt with the cell width."""
    pj, pt = _params(tokamak_cfg, n=4096)
    key = jax.random.PRNGKey(1)
    stats_j, _, _ = jpic.run(pj, 16, 40, dt, key=key)
    stats, _, _ = cuda_pic.run(pt, 16, 40, dt, state=_start(pj, 16, key))
    assert bool(np.isfinite(np.asarray(stats_j)).all()) == finite
    assert bool(torch.isfinite(stats).all()) == finite


class _Reached(Exception):
    """Raised in place of a fused PIC run: the driver chose it."""


def _fused_reached(solve, cfg, **kw):
    try:
        solve(cfg, complex(*cfg["initial_guess"]), **kw)
    except _Reached:
        return True
    except ValueError as e:
        assert "pic_backend='fused'" in str(e)
        return False
    raise AssertionError("the driver neither ran nor refused the fused path")


@pytest.mark.parametrize("npoints", [16384, 16448])
def test_driver_fused_ok_matches_jax(tokamak_cfg, monkeypatch, npoints):
    """An input with "pic_backend": "fused" is taken or refused by the
    port's driver exactly as by emme_tpu's (emme_tpu/driver.py:368-373):
    npoints 16,384 runs the fused kernels, 16,448 (not a multiple of 128)
    is refused by both."""
    from emme_tpu import driver as jdriver
    from emme_tpu_torch import driver as tdriver

    def reached(*a, **k):
        raise _Reached

    monkeypatch.setattr(pallas_pic, "run", reached)
    monkeypatch.setattr(cuda_pic, "run", reached)
    cfg = dict(tokamak_cfg, npoints=npoints, method="PIC", marker_per_cell=8,
               step_number=2, time_step=0.25, pic_backend="fused",
               stream_fields=False)
    jax_ok = _fused_reached(jdriver.solve_once_pic, cfg, dtype=jnp.float32)
    port_ok = _fused_reached(tdriver.solve_once_pic, cfg,
                             dtype=torch.float32, device="cpu")
    assert port_ok == jax_ok == (npoints % 128 == 0)
    assert tdriver.fused_pic_ok(torch.float32, npoints, 8 * npoints) == jax_ok


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


@pytest.mark.parametrize("nf", [96, 128, 1024])
def test_tile_stats_are_the_plane_stats(nf):
    """K3's per-step statistics in numpy, in the kernel's order (csrc/pic.cu
    reduce_field, step_stats): each tile of 32 columns of the (2 nf,) field
    gives its sum and its sum of squares, the first half of the tiles is
    the real plane, lanes take tiles at a stride of 32 and a shuffle tree
    adds them.  With nf a multiple of the tile that is plane_stats."""
    rng = np.random.default_rng(nf)
    field = rng.normal(size=(2, nf)).astype(np.float32)
    tiles = field.reshape(-1, cuda_pic.TILE).astype(np.float64)
    n_tiles = tiles.shape[0]
    assert n_tiles == 2 * nf // cuda_pic.TILE and n_tiles % 2 == 0
    sums, squares = tiles.sum(axis=1), (tiles * tiles).sum(axis=1)
    lanes = np.zeros((32, 3))
    for t in range(n_tiles):
        lanes[t % 32, 0 if t < n_tiles // 2 else 1] += sums[t]
        lanes[t % 32, 2] += squares[t]
    a, b, c = lanes.sum(axis=0)
    got = np.array([a / nf, b / nf, np.sqrt(c / nf)], np.float32)
    want = cuda_pic.plane_stats(torch.as_tensor(field[0]),
                                torch.as_tensor(field[1])).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("nf", [16, 48, 80])
def test_wrappers_refuse_a_tile_across_planes(tokamak_cfg, nf):
    """npoints must be a multiple of the reduce's tile of 32 columns: at
    npoints = 48 a tile would span the end of the real plane and the start
    of the imaginary one, and the per-step statistics take whole tiles as
    one or the other.  K2's and K3's wrappers refuse such a field."""
    _, pt = _params(tokamak_cfg, n=nf)
    params = cuda_pic.FusedStep.params_vec(pt, 0.25)
    arrs = {k: torch.zeros(8 * nf) for k in cuda_pic.MARKERS}
    fr, fi, qn = torch.zeros(nf), torch.zeros(nf), torch.ones(nf)
    with pytest.raises(ValueError, match="npoints % 32"):
        cuda_pic.mega(True, params, fr, fi, qn, arrs, 1)
    with pytest.raises(ValueError, match="npoints % 32"):
        cuda_pic.stage(0, True, True, params, fr, fi, qn, arrs)


def _probe_model(x, rounds):
    """K4's rounds written out in numpy (csrc/pic.cu
    grid_sync_probe_kernel): x is read in place, the rounds alternate two
    scratch buffers."""
    nb = x.shape[0]
    bufs = [np.empty_like(x), np.empty_like(x)]
    for b in range(nb):       # round 1: the block's own slice
        bufs[0][b] = 2.0 * x[b]
    for s in range(2, rounds + 1):
        src, dst = bufs[s % 2], bufs[(s + 1) % 2]
        for b in range(nb):
            dst[b] = 2.0 * src[(b + cuda_pic.probe_rotation(s, nb)) % nb]
    return bufs[(rounds + 1) % 2]


def test_grid_sync_probe_plain():
    """The plain probe is the rounds written out: round 1 reads x, round
    s >= 2 reads block (b + rotation(s)) mod n of the round before, each
    doubles; on a CPU tensor the wrapper runs it and the self-check passes
    without a launch."""
    x = torch.rand((7, 32), generator=torch.Generator().manual_seed(0))
    before = dict(cuda_pic.LAUNCHES)
    np.testing.assert_array_equal(
        cuda_pic.grid_sync_probe(x).numpy(),
        _probe_model(x.numpy(), cuda_pic.PROBE_ROUNDS))
    assert cuda_pic.grid_sync_selfcheck("cpu", 1024, True)[0]
    assert cuda_pic.LAUNCHES == before


@pytest.mark.parametrize("nblocks,rounds", [
    (16, cuda_pic.PROBE_ROUNDS), (24, 2), (12, 5), (9, 1),
    (132, cuda_pic.PROBE_ROUNDS)])
def test_grid_sync_probe_ref_is_the_rounds(nblocks, rounds):
    """grid_sync_probe_ref against the numpy model of K4's rounds: round 1
    doubles the block's own slice, each later round reads a block across
    the grid; the default rounds read both scratch buffers after a barrier,
    the first of them from half the grid away."""
    x = torch.rand((nblocks, 4), generator=torch.Generator().manual_seed(1))
    got = cuda_pic.grid_sync_probe_ref(x, rounds)
    np.testing.assert_array_equal(got.numpy(),
                                  _probe_model(x.numpy(), rounds))
    assert cuda_pic.PROBE_ROUNDS >= 3    # a + b written, then each read
    assert cuda_pic.probe_rotation(2, nblocks) == (nblocks // 2 + 2) % nblocks
    with pytest.raises(ValueError, match="rounds"):
        cuda_pic.grid_sync_probe(x, rounds=0)


def _rn32(v: Fraction) -> Fraction:
    """v rounded to the nearest float32 (ties to even), exactly; normal
    range."""
    if v == 0:
        return v
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    assert -126 <= e <= 127
    ulp = Fraction(2) ** (e - 23)
    n, rem = divmod(a, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and n % 2):
        n += 1
    return (n * ulp) * (1 if v > 0 else -1)


def _div_const(a: Fraction, c: int) -> Fraction:
    """csrc/pic.cu div_const in exact arithmetic: r = RN(1/c), q = RN(a r),
    e = RN(a - c q) (one FMA), RN(q + e r) (one FMA)."""
    r = _rn32(Fraction(1, c))
    q = _rn32(a * r)
    e = _rn32(a - c * q)
    assert e == a - c * q          # the remainder is exact
    return _rn32(q + e * r)


@pytest.mark.parametrize("family", ["j0", "j1"])
def test_const_division_is_ieee(family):
    """The three-operation division by a compile-time constant equals the
    float32 IEEE quotient for each Taylor divisor (k^2 for J0, k (k + 1)
    for J1, k = 1..30), emulated in rational arithmetic, over numerators
    t q of |x| <= 8: random mantissas and the edges of the mantissa range
    at exponents from 2^-93 (far below the smallest q = -x^2 / 4 a marker
    produces, x ~ 2^-24 giving q ~ 2^-50) up to 2^12."""
    rng = np.random.default_rng(0 if family == "j0" else 1)
    edges = np.array([0, 1, 2, 3, 0x400000, 0x555555, 0x2AAAAA, 0x7FFFFD,
                      0x7FFFFE, 0x7FFFFF], dtype=np.int64)
    for k in range(1, 31):
        c = k * k if family == "j0" else k * (k + 1)
        mant = np.concatenate([edges, rng.integers(0, 1 << 23, 40)])
        for exp in (-93, -50, -20, -3, 0, 4, 12):
            for m in mant:
                a = Fraction(int((1 << 23) + m)) * Fraction(2) ** (exp - 23)
                if rng.integers(2):
                    a = -a
                want = _rn32(a / c)
                assert _div_const(a, c) == want, (c, float(a))
                # numpy's float32 division is the same IEEE quotient
                assert Fraction(float(np.float32(float(a))
                                      / np.float32(c))) == want


def test_const_division_tiny_numerators_round_away():
    """Below 2^-93 the remainder may be subnormal and the sequence is not
    held to the quotient; there both it and a true division stay under
    2^-25, so the Taylor step 1 + quotient gives 1 either way."""
    for c in (3 * 3, 30 * 31):
        for exp in (-94, -110, -126):
            a = Fraction(2) ** exp * Fraction(3, 2)
            for d in (a / c, a * _rn32(Fraction(1, c))):
                assert abs(d) < Fraction(1, 1 << 25)
                assert _rn32(1 + d) == 1


@pytest.mark.parametrize("dc", [True, False])
def test_hierarchical_reduce_matches_plain_deposit(tokamak_cfg, dc):
    """A numpy model of the kernels' two-level deposit sum, in their order
    (csrc/pic.cu deposit, write_partials, reduce_field): float32 histograms
    per block (markers to blocks by the grid stride), each written as one
    float64 partial; then per tile of 32 columns, warp w sums partials w,
    w + n_warps, ... and the warps' sums are added in warp order, rounded
    to float32, times qn.  It
    gives the plain deposit's field (stage_ref) to the stage bars: 1e-5 of
    scale (2e-5 is the kernels' bar)."""
    _, pt = _params(tokamak_cfg, dc)
    nf, mpc = 128, 32
    s0 = pic.init_state(pt, mpc, torch.Generator().manual_seed(7),
                        dtype=torch.float32)
    fs = cuda_pic.FusedStep(pt, nf * mpc, 0.25)
    qn = pic.quasi_neutrality_coef(pt, dtype=torch.float32)
    arrs = cuda_pic.state_to_arrs(s0)
    # one plain step first, so that weights and field are not trivial
    eta, wre, wim, fr, fi, _ = cuda_pic.mega_ref(
        dc, fs.params, s0.field.real.contiguous(),
        s0.field.imag.contiguous(), qn, arrs, 1)
    arrs = dict(arrs, eta=eta, w_re=wre, w_im=wim)
    _, dep = cuda_pic.marker_ref(0, False, dc, fs.params, fr, fi, arrs)
    want = cuda_pic.deposit_ref(*dep, qn)
    ref = cuda_pic.stage_ref(0, False, dc, fs.params, fr, fi, qn, arrs)
    assert torch.equal(want[0], ref[5]) and torch.equal(want[1], ref[6])

    denr, deni, i2, ir, w2 = (t.numpy() for t in dep)
    threads, n_blocks, n_warps = 64, 8, 3
    m = denr.shape[0]
    block_of = (np.arange(m) // threads) % n_blocks
    hist = np.zeros((n_blocks, 2, nf), np.float32)
    wl = np.float32(1.0) - w2
    for plane, den in enumerate((denr, deni)):
        for i in range(m):      # the order inside a block is free
            hist[block_of[i], plane, i2[i]] += den[i] * wl[i]
            hist[block_of[i], plane, ir[i]] += den[i] * w2[i]
    partials = hist.reshape(n_blocks, 2 * nf).astype(np.float64)
    warp_sums = np.zeros((n_warps, 2 * nf), np.float64)
    for w in range(n_warps):
        for q in range(w, partials.shape[0], n_warps):
            warp_sums[w] += partials[q]
    total = np.zeros(2 * nf, np.float64)
    for w in range(n_warps):
        total += warp_sums[w]
    field = total.astype(np.float32).reshape(2, nf) * qn.numpy()
    for got, ref_plane in zip(field, want):
        ref_plane = ref_plane.numpy()
        assert np.abs(got - ref_plane).max() / np.abs(ref_plane).max() < 1e-5


def test_kernel_source_matches_wrapper():
    """pic.cu cannot be compiled here: hold its layout constants to the
    wrapper's, and check the build keeps IEEE math and the eta advance is
    written without contraction."""
    src = (CSRC / "pic.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kSharedNf") == cuda_pic.SHARED_NF
    assert (const("kFormShared"), const("kFormCluster"),
            const("kFormGlobal")) \
        == (cuda_pic.FORM_SHARED, cuda_pic.FORM_CLUSTER, cuda_pic.FORM_GLOBAL)
    # the cluster form: a full slice fills a block exactly beside the
    # reduce's static 8 KB (232,448 bytes a block on an H100), 8 ranks at
    # most, one block (a plain launch) up to a full slice
    assert const("kClusterSliceNf") == cuda_pic.CLUSTER_SLICE_NF
    assert const("kClusterMax") == cuda_pic.CLUSTER_MAX
    assert const("kClusterNf") == cuda_pic.CLUSTER_NF
    assert 2 * cuda_pic.CLUSTER_SLICE_NF * 4 + 8192 == const("kSmemPerBlock")
    assert const("kPartNoDeposit") == cuda_pic.PART_NO_DEPOSIT
    # the cooperative launch carries the cluster attribute; peers' adds go
    # through distributed shared memory, fenced by cluster barriers
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "cudaOccupancyMaxActiveClusters" in src
    assert "map_shared_rank" in src and "cg::this_cluster().sync()" in src
    assert const("kThreads") == cuda_pic.THREADS
    assert const("kParams") == cuda_pic.N_PARAMS
    for name in ("L", "CW", "VT", "BT", "SHAT", "ODB", "QR", "I2CW", "SUBDT",
                 "CPREV", "CCUR"):
        assert const(f"kP_{name}") == getattr(cuda_pic, f"P_{name}"), name
    assert const("kTile") == cuda_pic.TILE
    assert "grid.sync()" in src and "cudaLaunchAttributeCooperative" in src
    assert "atomicAdd(part" not in src
    # a tile of the field reduce lies in one plane (the per-step statistics
    # take whole tiles as real or imaginary): nf is a multiple of the tile
    assert "nf < kTile || nf % kTile" in src
    # only builds made to count instructions take one Bessel branch
    assert "#define EMME_BESSEL_BRANCH 0" in src
    assert not any("EMME_BESSEL_BRANCH" in f for f in _build.NVCC_FLAGS)
    assert "__fdiv_rn(m, two_l)" in src
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
