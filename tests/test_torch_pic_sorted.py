"""The sorted-window marker path (emme_tpu_torch.solvers.pic.run_sorted)
and the 'matmul' / 'bf16' CIC forms against emme_tpu on the CPU in float64,
directly and through both drivers.  Both packages start from one JAX-built
state (convert.pic_state_from_arrays).  The JAX package's choice of the
re-sort interval R and the guard width G is read from its trace: the
length of its inner scan and the G its window bases are built with."""
import warnings

import numpy as np
import pytest
import torch
import jax

import emme_tpu
from emme_tpu import driver as jdriver
from emme_tpu.solvers import pic as jpic
import emme_tpu_torch as et
from emme_tpu_torch import convert, driver
from emme_tpu_torch.solvers import pic

torch.set_num_threads(2)

# (markers a cell, steps, resort_every, window, chunk_markers, violations):
# the JAX package's own case (tests/test_pic.py:251-273), and one whose
# single 256-marker chunk spans all 64 cells against a 16-cell window
CASES = {"no_violations": (32, 12, 4, 32, 256, 0),
         "violations": (4, 6, 3, 16, 256, 7307)}


def _to_port(s):
    return convert.pic_state_from_arrays(
        {k: np.asarray(getattr(s, k)) for k in s.__dataclass_fields__},
        device="cpu")


@pytest.fixture(scope="module")
def tok64(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=64)
    return emme_tpu.from_config(cfg), et.from_config(cfg, device="cpu")


def _jax_run_sorted(pj, mpc, steps, **kw):
    """emme_tpu's run_sorted, with what it chose: R (its inner scan's
    length) and G, W, quant, n_chunks (its window bases' arguments)."""
    seen = {}
    real_scan, real_bases = jax.lax.scan, jpic._window_bases

    def scan(f, init, xs=None, length=None, **skw):
        seen.setdefault(f.__name__, length)
        return real_scan(f, init, xs, length=length, **skw)

    def bases(p, eta, n_chunks, W, G, nfe, quant=1):
        seen.update(n_chunks=n_chunks, W=W, G=G, quant=quant)
        return real_bases(p, eta, n_chunks, W, G, nfe, quant)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "scan", scan)
        mp.setattr(jpic, "_window_bases", bases)
        stats, s, viols = jpic.run_sorted(pj, mpc, steps, 0.25,
                                          key=jax.random.PRNGKey(0), **kw)
    chosen = {"R": seen["inner"], "sorts": seen["outer"],
              **{k: seen[k] for k in ("G", "W", "quant", "n_chunks")}}
    return np.asarray(stats), s, int(viols), chosen


@pytest.fixture(scope="module")
def sorted_runs(tok64):
    """Both packages' run_sorted on each case, from one state."""
    pj, pt = tok64
    out = {}
    for name, (mpc, steps, every, window, chunk, _) in CASES.items():
        kw = dict(resort_every=every, window=window, chunk_markers=chunk)
        ref = _jax_run_sorted(pj, mpc, steps, **kw)
        s0 = _to_port(jpic.init_state(pj, mpc, jax.random.PRNGKey(0)))
        stats, s, viols = pic.run_sorted(pt, mpc, steps, 0.25, state=s0,
                                         **kw)
        out[name] = (ref, (stats.numpy(), s, int(viols),
                           dict(pic.LAST_SORTED)), s0)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_run_sorted_matches_jax(sorted_runs, case):
    """The same R, G, W, quantum, chunks and sorts; the same violation
    count (0, and 7,307 in the clamped case); per-step stats within 1e-12,
    the final field within 1e-12 of its scale + 1e-13 (the JAX package's
    bar against its plain run), the final sorted, unwrapped eta within
    1e-12."""
    (st_j, s_j, v_j, chose_j), (st, s, v, chose), _ = sorted_runs[case]
    assert chose == chose_j
    assert v == v_j == CASES[case][-1]
    assert st.shape == st_j.shape == (CASES[case][1], 3)
    assert np.abs(st - st_j).max() < 1e-12
    fj = np.asarray(s_j.field)
    assert np.abs(s.field.numpy() - fj).max() < 1e-12 * np.abs(fj).max() \
        + 1e-13
    assert np.abs(s.eta.numpy() - np.asarray(s_j.eta)).max() < 1e-12
    for k in ("weight", "v_para", "dc_pb"):
        ref = np.asarray(getattr(s_j, k))
        assert np.abs(getattr(s, k).numpy() - ref).max() \
            < 1e-12 * np.abs(ref).max()


def test_run_sorted_matches_port_run(tok64, sorted_runs):
    """Without violations the sorted path is the plain run reordered: the
    port's run_sorted against its own pic.run from the same state, stats
    and field within 1e-12."""
    _, pt = tok64
    _, (st, s, _, _), s0 = sorted_runs["no_violations"]
    mpc, steps = CASES["no_violations"][:2]
    st_r, s_r, _ = pic.run(pt, mpc, steps, 0.25, state=s0)
    assert np.abs(st - st_r.numpy()).max() < 1e-12
    fr = s_r.field.numpy()
    assert np.abs(s.field.numpy() - fr).max() < 1e-12 * np.abs(fr).max() \
        + 1e-13


def test_run_sorted_sorts_and_rejects_uneven_chunks(tok64):
    """sort_by_eta wraps eta and carries every marker field with it; 192
    markers in 5 chunks raise a ValueError naming both numbers (the JAX
    package fails at a reshape there)."""
    _, pt = tok64
    s = pic.init_state(pt, 3, torch.Generator().manual_seed(1))
    s.eta = s.eta + 2.0 * pt.length * torch.tensor([0.0, 1.0, -1.0]
                                                    ).repeat(64)
    srt = pic.sort_by_eta(pt, s)
    assert bool((srt.eta[1:] >= srt.eta[:-1]).all())
    assert bool((srt.eta >= -pt.length).all()) \
        and bool((srt.eta < pt.length).all())
    perm = torch.argsort(pic._wrap_eta(pt, s.eta), stable=True)
    for k in ("v_para", "weight", "p_weight", "omega_st"):
        assert torch.equal(getattr(srt, k), getattr(s, k)[perm])
    with pytest.raises(ValueError, match="192 markers .* 5 chunks"):
        pic.run_sorted(pt, 3, 2, 0.25, state=s, chunk_markers=35)


# ---------------------------------------------------------------------------
# through the drivers (npoints 32, 16 markers a cell, 8 steps)
# ---------------------------------------------------------------------------

SORTED_KEYS = dict(method="PIC", marker_per_cell=16, step_number=8,
                   time_step=0.25, initial_guess=[-0.8, 0.25],
                   pic_sorted=True)


@pytest.fixture
def same_markers(tokamak_cfg, monkeypatch):
    """The port's driver starts from the markers emme_tpu's draws (seed
    0)."""
    pj = emme_tpu.from_config(dict(tokamak_cfg, npoints=32))
    state = _to_port(jpic.init_state(pj, 16, jax.random.PRNGKey(0)))
    monkeypatch.setattr(pic, "initial_state",
                        lambda p, mpc, generator=None, state_=None: state)


def _both(cfg, tmp_path):
    out = []
    for name, run in (("port", lambda c, **kw: driver.run(c, device="cpu",
                                                          **kw)),
                      ("jax", jdriver.run)):
        doc = run(cfg, output_dir=tmp_path / name, verbose=False)
        res = doc["result"]["(None)"]["scan_result"][0]
        assert not (tmp_path / name / "eigenMatrics"
                    / "eigenMatrix.bin").exists()
        out.append(res)
    return out


def test_driver_pic_sorted_matches_jax(tmp_path, tokamak_cfg, same_markers):
    """"pic_sorted": true with a window of 16 cells and chunks of 64
    markers: no violation, the eigenvalue and the final field within 1e-10
    of emme_tpu's driver; neither writes a field dump."""
    cfg = dict(tokamak_cfg, npoints=32, pic_window=16, pic_chunk_markers=64,
               **SORTED_KEYS)
    mine, ref = _both(cfg, tmp_path)
    assert abs(complex(*mine["eigenvalue"]) - complex(*ref["eigenvalue"])) \
        <= 1e-10 * abs(complex(*ref["eigenvalue"]))
    fa, fb = (np.asarray(r["eigenvector"]) for r in (mine, ref))
    assert fa.shape == (32, 2)
    assert np.abs(fa - fb).max() <= 1e-10 * np.abs(fb).max()
    assert pic.LAST_SORTED["sorts"] == 8 and pic.LAST_SORTED["W"] == 16


@pytest.mark.parametrize("allow", [False, True])
def test_driver_pic_sorted_violations(tmp_path, tokamak_cfg, same_markers,
                                      allow):
    """The driver's defaults at npoints 32 (W = 32, one chunk of 512
    markers over the whole grid) clamp markers: both drivers raise the same
    RuntimeError, or with "pic_allow_window_violations" warn with it and
    give the same eigenvalue within 1e-10."""
    cfg = dict(tokamak_cfg, npoints=32, **SORTED_KEYS)
    if not allow:
        for run in (lambda: driver.run(cfg, output_dir=tmp_path / "p",
                                       device="cpu", verbose=False),
                    lambda: jdriver.run(cfg, output_dir=tmp_path / "j",
                                        verbose=False)):
            with pytest.raises(RuntimeError,
                               match=r"pic_sorted: 3287 marker-stage window "
                                     r"violations .* widen pic_window"):
                run()
        return
    cfg["pic_allow_window_violations"] = True
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mine, ref = _both(cfg, tmp_path)
    said = [str(w.message) for w in caught if "pic_sorted" in str(w.message)]
    assert len(said) == 2 and said[0] == said[1]
    assert "3287 marker-stage window violations" in said[0]
    assert abs(complex(*mine["eigenvalue"]) - complex(*ref["eigenvalue"])) \
        <= 1e-10 * abs(complex(*ref["eigenvalue"]))


# ---------------------------------------------------------------------------
# the CIC forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gather,deposit", [
    ("matmul", "matmul"), ("bf16", "bf16"), ("bf16", "segment"),
    ("take", "bf16")])
def test_cic_forms_match_jax(tok64, gather, deposit):
    """6 steps at 16 markers a cell with each named form against emme_tpu's
    pic.run with the same names: stats and field within 1e-12 relative
    (measured 1.1e-16 to 4.1e-16 for both forms: emme_tpu's one-hot product
    on the CPU sums its bf16 operands in float64, so only the order of the
    sums differs).  'matmul' equals 'take' / 'segment' to rounding; 'bf16'
    moves the field by the bfloat16 rounding of the table or the values,
    more than 1e-5 of scale."""
    pj, pt = tok64
    key = jax.random.PRNGKey(0)
    s0 = _to_port(jpic.init_state(pj, 16, key))
    st_j, s_j, _ = jpic.run(pj, 16, 6, 0.25, key=key, gather_method=gather,
                            deposit_method=deposit)
    st, s, _ = pic.run(pt, 16, 6, 0.25, state=s0, gather_method=gather,
                       deposit_method=deposit)
    st_j, fj = np.asarray(st_j), np.asarray(s_j.field)
    assert np.abs(st.numpy() - st_j).max() < 1e-12 * np.abs(st_j).max()
    assert np.abs(s.field.numpy() - fj).max() < 1e-12 * np.abs(fj).max()
    _, s_p, _ = pic.run(pt, 16, 6, 0.25, state=s0)
    moved = float((s.field - s_p.field).abs().max() / s_p.field.abs().max())
    if gather == deposit == "matmul":
        assert moved < 1e-13
    else:
        assert moved > 1e-5
