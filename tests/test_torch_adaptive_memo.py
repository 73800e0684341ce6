"""Kernel N1's memo of each node's omega-free half (``csrc/adaptive.cu``,
``csrc/adaptive_node.h``, ``ops/cuda_adaptive.Memo``) on the CPU.  The
kernel runs on a card only (``tests/test_torch_cuda.py`` holds its memo
launches to memo-free ones bit for bit); here:

* the wrapper's bookkeeping: the route of each launch of a solve (the
  first plain, the second filling, the later reading; plain where
  sign(Re omega) is not the first's; nothing once the second did not fill;
  refused for other rows or scalars), the places from the first launch's
  panel counts (a prefix under the budget, one record a panel), the memo's
  allocation and its share of free memory;
* the depth-first key order: the intervals an integral's adaptive rule
  visits, popped from a stack left child first, rise in the kernel's key
  (left end ascending, then right end descending), so the accepted ones
  come in the plain version's acceptance order (by left end) and sum to its
  values bit for bit; the kernel's walk of the records in that order
  (skip the records that sort before the popped interval, take the one
  equal to it) finds every panel both trees visit;
* the node halves themselves, from the kernel's own header built for the
  host with g++: the free half does not change with omega of one sign, and
  the omega half of a free half read back from a record gives the full
  integrand's value bit for bit at another omega.
"""
import ctypes
import json
import math
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import emme_tpu_torch as et
from emme_tpu_torch import native
from emme_tpu_torch.ops import adaptive, cuda_adaptive

torch.set_num_threads(2)

INPUTS = pathlib.Path(__file__).resolve().parent / "goldens" / "inputs"
CSRC = pathlib.Path(et.__file__).resolve().parent / "csrc"
GUESS = {"tokamak": -0.8 + 0.25j, "stellarator": -1.656 + 2.49j}


def _inputs(name, n=16):
    """N1's rows, moments and Phys of the upper triangle at npoints n."""
    with open(INPUTS / f"{name}.json") as f:
        p = et.from_config(dict(json.load(f), npoints=n), device="cpu")
    iu, ju = torch.triu_indices(n, n, 1)
    rows, m, _grid, ph = native.pair_integrals(p, iu, ju)
    return rows, m, ph


def _scalars(ph, omega):
    return adaptive.scalars(ph, omega)


def _near_pairs(name, k=6):
    """N1's rows of k seeded near pairs (d_eta from 1e-4 to 1e-1, which
    split into 3 to 39 panels), moments 0, 1, 2 in turn on the stellarator,
    and Phys."""
    _rows, _m, ph = _inputs(name, 8)
    g = torch.Generator().manual_seed(7)
    eta = -ph.length * torch.rand(k, generator=g, dtype=torch.float64)
    d_eta = 10.0 ** (torch.rand(k, generator=g, dtype=torch.float64) * 3 - 4)
    m = torch.arange(k, dtype=torch.int32) % (3 if name == "stellarator"
                                               else 1)
    return adaptive.pair_rows(ph, eta, eta + d_eta), m, ph


# ---------------------------------------------------------------------------
# the wrapper's bookkeeping
# ---------------------------------------------------------------------------

def _drive(memo, rows, sc, panels, budget=10 ** 9):
    """One launch's bookkeeping as ``integrate`` does it, without the
    kernel: the route, the places for a fill, the state left behind."""
    route = memo.route(rows, sc)
    if route == "fill" and not memo.place(budget):
        route = "plain"
    memo.done(route, rows, sc, panels)
    return route


@pytest.mark.parametrize("case", ["reuse", "sign_at_fill", "sign_at_read",
                                  "no_room"])
def test_memo_routes_along_a_solve(case):
    """A solve's launches on one plan: the first plain, the second fills,
    the later read; a launch whose sign(Re omega) is not the first's runs
    plain (at the fill: no memo for the solve); a budget that holds no
    integral makes no memo; the memo refuses other rows or scalars."""
    rows, m, ph = _inputs("tokamak", 8)
    panels = torch.arange(1, rows.shape[0] + 1, dtype=torch.int32)
    oms = [0.99 * GUESS["tokamak"], GUESS["tokamak"], -0.83 + 0.26j,
           -0.832 + 0.2565j]
    budget = 0 if case == "no_room" else 10 ** 9
    if case == "sign_at_fill":
        oms[1] = 0.5 + 0.25j
    if case == "sign_at_read":
        oms[2] = 0.1 + 0.26j
    memo = cuda_adaptive.Memo()
    routes = [_drive(memo, rows, _scalars(ph, w), panels, budget)
              for w in oms]
    want = {"reuse": ["first", "fill", "read", "read"],
            "sign_at_fill": ["first", "plain", "plain", "plain"],
            "sign_at_read": ["first", "fill", "plain", "read"],
            "no_room": ["first", "plain", "plain", "plain"]}[case]
    assert routes == want
    assert memo.launches == 4 and memo.last == want[-1]
    assert memo.n == (rows.shape[0] if "fill" in want else 0)
    assert memo.panels is None or "fill" not in want
    with pytest.raises(ValueError, match="first launch"):
        memo.route(rows[:-1], _scalars(ph, oms[0]))
    other = adaptive.Scalars(**{**_scalars(ph, oms[0]).__dict__,
                                "rel_tol": 1e-3})
    with pytest.raises(ValueError, match="first launch"):
        memo.route(rows, other)


def test_memo_engages_only_on_a_plan_on_the_card():
    """The plan made on the CPU carries no memo and the CPU's integrate
    ignores one (the plain version runs): single assemblies, ``kappa_batch``
    and the CPU launch as before."""
    rows, m, ph = _inputs("tokamak", 8)
    with open(INPUTS / "tokamak.json") as f:
        p = et.from_config(dict(json.load(f), npoints=8), device="cpu")
    plan = native.assembly_plan(p, torch.zeros(8, 8, dtype=torch.float64))
    assert plan.n1_memo is None
    memo = cuda_adaptive.Memo()
    sc = _scalars(ph, GUESS["tokamak"])
    got = cuda_adaptive.integrate(rows, m, sc, memo=memo)
    ref = adaptive.integrate_ref(rows, m, sc)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert memo.launches == 0 and memo.last is None


@pytest.mark.parametrize("order", [15, 31])
@pytest.mark.parametrize("budget", ["all", "prefix", "one", "none"])
def test_memo_places_from_panel_counts(order, budget):
    """The places: integral k's records start at the sum of the first
    launch's panel counts before it; the prefix of integrals whose places
    fit the budget (in panels) is memoised, read in one host read; the
    memo holds a record (21 fields at a slot's lane stride) and a key a
    panel, in one allocation rounded up to a power of ``MEMO_GROWTH``."""
    g = torch.Generator().manual_seed(order)
    panels = torch.randint(1, 40, (1001,), generator=g, dtype=torch.int32)
    cum = torch.cumsum(panels, 0, dtype=torch.int64)
    total = int(cum[-1])
    cap = {"all": total, "prefix": int(cum[600]) + 3, "one": int(cum[0]),
           "none": int(cum[0]) - 1}[budget]
    want_n = {"all": 1001, "prefix": 601, "one": 1, "none": 0}[budget]
    rows, _m, ph = _inputs("stellarator" if order == 31 else "tokamak", 4)
    sc = adaptive.Scalars(**{**_scalars(ph, -0.8 + 0.25j).__dict__,
                             "order": order})
    memo = cuda_adaptive.Memo()
    memo.done("first", rows, sc, panels)
    assert memo.place(cap) == want_n == memo.n
    assert memo.panels is None
    if want_n == 0:
        assert memo.rec is None and memo.bytes == 0
        return
    used = int(cum[want_n - 1])
    lanes = 32 if order == 31 else 16
    assert cuda_adaptive.record_doubles(order) == 21 * lanes
    assert torch.equal(memo.cum, cum[:want_n])
    assert memo.nrec.shape == (want_n,) and memo.nrec.dtype == torch.int32
    assert memo.rec.numel() == used * 21 * lanes
    assert memo.keys.numel() == 2 * used
    assert memo.keys.data_ptr() == memo.rec.data_ptr() + 8 * memo.rec.numel()
    assert memo.keys.data_ptr() % 16 == 0
    elems = memo.bytes // 8
    assert used * (21 * lanes + 2) <= elems
    assert elems < cuda_adaptive.MEMO_GROWTH * used * (21 * lanes + 2) + 2
    assert used * cuda_adaptive.panel_bytes(order) <= 8 * elems


def test_memo_capacity_is_a_share_of_free_memory(monkeypatch):
    """A memo may take ``MEMO_SHARE`` of the free bytes, its rounding up
    included: the panels it may hold, by order; a share of 0 holds none."""
    free = 80 * 2 ** 30
    for order in (15, 31):
        cap = cuda_adaptive.memo_capacity(free, order)
        size = cap * cuda_adaptive.panel_bytes(order)
        assert size * cuda_adaptive.MEMO_GROWTH <= \
            cuda_adaptive.MEMO_SHARE * free
        assert (cap + 1) * cuda_adaptive.panel_bytes(order) \
            * cuda_adaptive.MEMO_GROWTH > cuda_adaptive.MEMO_SHARE * free - 1
    assert cuda_adaptive.panel_bytes(15) == 8 * (21 * 16 + 2)
    assert cuda_adaptive.panel_bytes(31) == 8 * (21 * 32 + 2)
    monkeypatch.setattr(cuda_adaptive, "MEMO_SHARE", 0.0)
    assert cuda_adaptive.memo_capacity(free, 15) == 0


# ---------------------------------------------------------------------------
# the depth-first key order
# ---------------------------------------------------------------------------

def _key(iv):
    """The kernel's record key (key_before): left end ascending, then right
    end descending."""
    return (iv[0], -iv[1])


def _depth_first(row, m, sc):
    """One integral through the engine's stack, left child popped first, on
    the plain version's panel: (the popped intervals, the accepted ones,
    the sum in pop order)."""
    scale = math.ldexp(1.0, sc.max_subdivide)
    stack = [(0.0, adaptive.HALF_PI)]
    popped, accepted = [], []
    sr = si = 0.0
    abs_tol = None
    while stack:
        lo, hi = stack.pop()
        popped.append((lo, hi))
        ir, ii, err, _it, mid, half = (
            float(v[0]) for v in adaptive._panel(
                torch.tensor([lo], dtype=torch.float64),
                torch.tensor([hi], dtype=torch.float64), row[None], m[None],
                sc))
        cur = math.hypot(sc.rel_tol * ir, sc.rel_tol * ii)
        if abs_tol is None:
            abs_tol = cur
        if (half * scale > 0.99 * adaptive.HALF_PI
                and err > abs_tol * (2.0 / adaptive.HALF_PI)
                + sc.precision_goal and err > cur + sc.precision_goal):
            stack += [(mid, hi), (lo, mid)]
        else:
            accepted.append((lo, hi))
            sr, si = sr + ir, si + ii
    return popped, accepted, (sr, si)


def _walk(records, popped):
    """The kernel's read walk (csrc/adaptive.cu, kRead): per popped
    interval, skip the records whose key comes before it, take the next
    record if its key equals it; returns the intervals served."""
    cur, hits = 0, []
    for iv in popped:
        while cur < len(records) and _key(records[cur]) < _key(iv):
            cur += 1
        if cur < len(records) and records[cur] == iv:
            hits.append(iv)
            cur += 1
    return hits


@pytest.mark.parametrize("name", ["tokamak", "stellarator"])
def test_depth_first_key_order_is_the_acceptance_order(name):
    """On integrals that split (near pairs), the stack's pop order rises
    strictly in the kernel's key, the accepted intervals in it rise by left
    end (the plain version's acceptance order), and their sum in pop order
    is the plain version's value bit for bit, with its panel count."""
    rows, m, ph = _near_pairs(name)
    sc = _scalars(ph, GUESS[name])
    vals, panels, _miller = adaptive.integrate_ref(rows, m, sc)
    assert int(panels.min()) > 1
    for k in range(rows.shape[0]):
        popped, accepted, (sr, si) = _depth_first(rows[k], m[k], sc)
        keys = [_key(iv) for iv in popped]
        assert keys == sorted(keys) and len(set(keys)) == len(keys)
        assert [iv[0] for iv in accepted] == sorted(iv[0] for iv in accepted)
        assert len(popped) == int(panels[k])
        assert (sr, si) == (float(vals[k, 0]), float(vals[k, 1]))


@pytest.mark.parametrize("name", ["tokamak", "stellarator"])
def test_memo_walk_finds_every_common_panel(name):
    """The kernel's walk of an integral's records, filled at one omega,
    beside the pops at another: it serves exactly the intervals both trees
    visit, also when the trees differ (near pairs at a far omega) and when
    the fill recorded only the first intervals its place held."""
    rows, m, ph = _near_pairs(name)
    fill = _scalars(ph, GUESS[name])
    far = _scalars(ph, -0.3 + 0.6j)
    moved = 0
    for k in range(rows.shape[0]):
        records = _depth_first(rows[k], m[k], fill)[0]
        popped = _depth_first(rows[k], m[k], far)[0]
        moved += set(records) != set(popped)
        for room in (len(records), len(records) // 2):
            kept = records[:room]
            assert _walk(kept, popped) == [iv for iv in popped
                                           if iv in set(kept)]
    assert moved > 0


# ---------------------------------------------------------------------------
# the node halves, from the kernel's own header built for the host
# ---------------------------------------------------------------------------

HARNESS = r"""
#include "adaptive_node.h"

static Scal scal_of(const double* s, int order, int max_sub) {
  return Scal{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], order,
              max_sub};
}

// the free halves of nodes x at scal, each as its record (stride 1)
extern "C" void n1_free(const double* x, const double* rows, const int* m,
                        long long n, const double* s, double* rec,
                        int* steps) {
  const Scal sc = scal_of(s, 15, 20);
  for (long long k = 0; k < n; ++k) {
    const double* r = rows + 4 * k;
    const Pair pr = {r[0], r[1], r[2], r[3], sqrt(r[2] * r[3])};
    store_half(rec + kHalfFields * k, 1,
               free_half(x[k], pr, m[k], sc, steps[k]));
  }
}

// the omega half at scal of the records
extern "C" void n1_omega(const double* rec, long long n, const double* s,
                         double* out) {
  const Scal sc = scal_of(s, 15, 20);
  for (long long k = 0; k < n; ++k) {
    const C v = omega_half(load_half(rec + kHalfFields * k, 1), sc);
    out[2 * k] = v.r;
    out[2 * k + 1] = v.i;
  }
}

// the integrand in one pass, as the kernel's plain launch evaluates it
extern "C" void n1_full(const double* x, const double* rows, const int* m,
                        long long n, const double* s, double* out) {
  const Scal sc = scal_of(s, 15, 20);
  for (long long k = 0; k < n; ++k) {
    const double* r = rows + 4 * k;
    const Pair pr = {r[0], r[1], r[2], r[3], sqrt(r[2] * r[3])};
    int st;
    const C v = omega_half(free_half(x[k], pr, m[k], sc, st), sc);
    out[2 * k] = v.r;
    out[2 * k + 1] = v.i;
  }
}

extern "C" int n1_key_before(double alo, double ahi, double blo, double bhi) {
  return key_before(alo, ahi, blo, bhi);
}

extern "C" int n1_fields() { return kHalfFields; }
"""


@pytest.fixture(scope="module")
def halves(tmp_path_factory):
    """csrc/adaptive_node.h compiled for the host with g++, without FMA
    contraction (as nvcc --fmad=false builds the kernel)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's node halves for the host")
    tmp = tmp_path_factory.mktemp("n1_node")
    (tmp / "harness.cc").write_text(HARNESS)
    lib = tmp / "libn1_node.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(CSRC),
                    "-o", str(lib), str(tmp / "harness.cc")], check=True)
    so = ctypes.CDLL(str(lib))
    vp, ll, d = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
    so.n1_free.argtypes = [vp, vp, vp, ll, vp, vp, vp]
    so.n1_omega.argtypes = [vp, ll, vp, vp]
    so.n1_full.argtypes = [vp, vp, vp, ll, vp, vp]
    so.n1_key_before.argtypes = [d, d, d, d]
    so.n1_key_before.restype = ctypes.c_int
    return so


def _nodes(name):
    """Every node of the root panel and of its two halves for each
    integral of the 16-point assembly: (x, rows, m) as numpy arrays."""
    rows, m, ph = _inputs(name)
    X = adaptive.gk_rule(15)[0]
    xs = []
    for lo, hi in ((0.0, adaptive.HALF_PI), (0.0, adaptive.HALF_PI / 2),
                   (adaptive.HALF_PI / 2, adaptive.HALF_PI)):
        mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        xs += [mid] + [mid + s * half * xi for xi in X[1:] for s in (1, -1)]
    x = np.repeat(np.array(xs)[None], rows.shape[0], 0).reshape(-1)
    r = rows.numpy().repeat(len(xs), 0)
    mm = m.numpy().astype(np.int32).repeat(len(xs))
    return x, np.ascontiguousarray(r), np.ascontiguousarray(mm), ph


def _scal(sc):
    return np.array([sc.om_r, sc.om_i, sc.arc, sc.qR, sc.vt, sc.wsi,
                     sc.eta_i, sc.rel_tol, sc.precision_goal], np.float64)


def _free(halves, x, r, mm, sc):
    rec = np.empty((x.size, 21))
    steps = np.empty(x.size, np.int32)
    halves.n1_free(x.ctypes.data, r.ctypes.data, mm.ctypes.data, x.size,
                   _scal(sc).ctypes.data, rec.ctypes.data, steps.ctypes.data)
    return rec, steps


@pytest.mark.parametrize("name", ["tokamak", "stellarator"])
def test_record_serves_another_omega_bit_for_bit(halves, name):
    """The free half at omega and at another omega of the same sign of Re
    omega is the same, field for field and bit for bit, with the same
    Miller steps; read back from its record, its omega half at the other
    omega is the one-pass integrand's value there bit for bit (signs of
    zero included); the other sign of Re omega changes the free half."""
    x, r, mm, ph = _nodes(name)
    assert halves.n1_fields() == cuda_adaptive.MEMO_FIELDS
    w0, w1 = GUESS[name], GUESS[name] * (1.07 - 0.05j)
    rec0, st0 = _free(halves, x, r, mm, _scalars(ph, w0))
    rec1, st1 = _free(halves, x, r, mm, _scalars(ph, w1))
    assert np.array_equal(rec0.view(np.int64), rec1.view(np.int64))
    assert np.array_equal(st0, st1) and st0.min() > 0
    got = np.empty((x.size, 2))
    full = np.empty((x.size, 2))
    s1 = _scal(_scalars(ph, w1))
    halves.n1_omega(rec0.ctypes.data, x.size, s1.ctypes.data, got.ctypes.data)
    halves.n1_full(x.ctypes.data, r.ctypes.data, mm.ctypes.data, x.size,
                   s1.ctypes.data, full.ctypes.data)
    assert np.array_equal(got.view(np.int64), full.view(np.int64))
    assert (full == 0).all(1).mean() < 0.9
    flip, _ = _free(halves, x, r, mm, _scalars(ph, -w0.conjugate()))
    assert not np.array_equal(flip, rec0)


@pytest.mark.parametrize("name", ["tokamak", "stellarator"])
def test_node_halves_are_the_plain_integrand(halves, name):
    """The halves give the plain version's integrand (``adaptive.integrand``)
    at each node and the same Miller steps; the host's libm and torch's may
    round tan, atan, cos, sin and exp apart, so the values agree to 1e-12 of
    the largest, not bit for bit."""
    x, r, mm, ph = _nodes(name)
    sc = _scalars(ph, GUESS[name])
    rec, steps = _free(halves, x, r, mm, sc)
    full = np.empty((x.size, 2))
    halves.n1_full(x.ctypes.data, r.ctypes.data, mm.ctypes.data, x.size,
                   _scal(sc).ctypes.data, full.ctypes.data)
    fr, fi, it = adaptive.integrand(torch.from_numpy(x), torch.from_numpy(r),
                                    torch.from_numpy(mm), sc)
    ref = np.stack([fr.numpy(), fi.numpy()], 1)
    assert np.array_equal(steps, it.numpy())
    assert np.abs(full - ref).max() <= 1e-12 * np.abs(ref).max()


def test_key_before_is_the_depth_first_order(halves):
    """The kernel's key_before against the tuple order of ``_key`` on the
    intervals of a bisection tree, equal intervals included."""
    ivs = [(0.0, adaptive.HALF_PI)]
    for _ in range(4):
        ivs += [c for lo, hi in ivs for c in ((lo, 0.5 * (lo + hi)),
                                              (0.5 * (lo + hi), hi))]
    ivs = sorted(set(ivs))
    for a in ivs:
        for b in ivs:
            assert bool(halves.n1_key_before(*a, *b)) == (_key(a) < _key(b))
