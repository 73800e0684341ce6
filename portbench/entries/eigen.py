"""The eigen entry: each request is one eigenpair through the driver,
``emme_tpu_torch.driver.solve_once_eigen``, as a scan point hands it.

The traffic file gives:

* ``set``: input keys the mix fixes (npoints, the backend and its knobs,
  ``iteration_precision``), laid over the configuration's input;
* ``dtype`` ("float32" or "float64"), the driver's own argument;
* ``draw``: input keys drawn a request, ``{key: [lo, hi]}``, and
  ``guess_offset``: the largest shift of the starting guess in Re and in
  Im.  Every seed draws the same stratified set (``STRATA`` strata of each
  range, one value in each, at a seeded place) in its own order, so seeds
  change the order of the work and not its amount;
* ``guess``: the starting omega, or "input" for the input's
  ``initial_guess``;
* ``warmup``: requests run in set-up;
* ``branch``: the mode the scan follows, worked out by the plain
  reference (``reference/operator.trace_secant`` from the mix's guess,
  ``calibrate.py --branch``): ``omega`` at the nodes ``at`` of the drawn
  key, or one ``omega`` where nothing is drawn;
* ``check``: ``requests`` sampled from the window and ``rows`` sampled a
  request, and the ``limits`` of the numbers compared.

What is compared: for each sampled eigenpair (omega and eigenvector as the
driver returned them), on ``rows`` seeded rows of the plain float64
operator rebuilt by ``reference/operator.py`` from the request's own input
(``operator.row_check``), its backward error there (``residual``) and the
relative shift of omega those rows ask for (``omega_gap``); and for every
eigenpair of the window, its relative distance from the branch, the
polynomial through the table at the request's drawn value
(``branch_gap``): a root of det M = 0 other than the scan's mode reads as
far as the two modes lie apart.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.harness import percentile
from portbench.reference import operator as ref


STRATA = 64          # strata of each drawn range
ROW_CHUNK = 512      # pairs a reference kernel call in the row check


def stratified(rng, lo: float, hi: float, count: int):
    """``count`` values: one in each of ``STRATA`` equal strata of [lo,
    hi) at a seeded place, in a seeded order, repeated as needed."""
    out = []
    while len(out) < count:
        u = rng.random(STRATA)
        order = rng.permutation(STRATA)
        out += list(lo + (order + u[order]) / STRATA * (hi - lo))
    return out[:count]


def branch_omega(branch: dict, x: float | None) -> complex:
    """The branch's omega at the drawn value ``x``: the polynomial through
    the table's nodes (the one omega where the table has no nodes)."""
    om = np.array([complex(*w) for w in branch["omega"]])
    if "at" not in branch:
        return complex(om[0])
    at = np.asarray(branch["at"], dtype=np.float64)
    mid, half = 0.5 * (at.max() + at.min()), 0.5 * (at.max() - at.min())
    c = np.polynomial.polynomial.polyfit((at - mid) / half, om,
                                         len(at) - 1)
    return complex(np.polynomial.polynomial.polyval((x - mid) / half, c))


class Entry:
    MAX_REQUESTS = 4096

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch
        self.torch = torch
        self.traffic = traffic
        self.device = device
        self.seed = seed
        self.input = dict(config["input"], **traffic.get("set", {}))
        self.dtype = {"float32": torch.float32,
                      "float64": torch.float64}[traffic["dtype"]]
        guess = traffic.get("guess", "input")
        if guess == "input":
            guess = self.input["initial_guess"]
        self.guess = complex(*guess)
        rng = np.random.default_rng([seed, 1])
        n = self.MAX_REQUESTS
        self.draws = {k: stratified(rng, lo, hi, n)
                      for k, (lo, hi) in traffic.get("draw", {}).items()}
        off = float(traffic.get("guess_offset", 0.0))
        self.offsets = list(zip(stratified(rng, -off, off, n),
                                stratified(rng, -off, off, n))) \
            if off else [(0.0, 0.0)] * n
        self.check_rng = np.random.default_rng([seed, 2])
        self.limit = int(self.input.get("iteration_step_limit", 20))

    # -- the request ------------------------------------------------------

    def inputs(self, k: int):
        """Input dict and starting guess of request ``k`` (-1: the
        warm-up's, the middle of every range)."""
        cfg = dict(self.input)
        if k < 0:
            for key, (lo, hi) in self.traffic.get("draw", {}).items():
                cfg[key] = 0.5 * (lo + hi)
            return cfg, self.guess
        for key, vals in self.draws.items():
            cfg[key] = float(vals[k % self.MAX_REQUESTS])
        dre, dim = self.offsets[k % self.MAX_REQUESTS]
        return cfg, self.guess + complex(dre, dim)

    def before(self, k: int):
        """Work of request ``k`` made before its clock starts: none."""

    def request(self, k: int) -> dict:
        from emme_tpu_torch import driver
        from emme_tpu_torch.solvers import eigen
        torch = self.torch
        cfg, guess = self.inputs(k)
        t0 = time.perf_counter()
        try:
            res, omega = driver.solve_once_eigen(
                cfg, guess, dtype=self.dtype, device=self.device)
            torch.cuda.synchronize(self.device) \
                if self.device.type == "cuda" else None
            t1 = time.perf_counter()
        except (RuntimeError, ValueError, ArithmeticError) as e:
            t1 = time.perf_counter()
            return {"k": k, "t0": t0, "t1": t1, "failed": True,
                    "reason": f"{type(e).__name__}: {e}"}
        loop_steps = eigen.LAST_SOLVE.get("steps", res["iteration_steps"])
        ok = (math.isfinite(abs(omega))
              and loop_steps <= self.limit)
        return {"k": k, "t0": t0, "t1": t1, "failed": not ok,
                "omega": omega, "vec": res["eigenvector"],
                "steps": int(res["iteration_steps"]),
                "loop_steps": int(loop_steps)}

    def setup(self):
        """The warm-up requests; a failed one is the window's to report."""
        for _ in range(int(self.traffic.get("warmup", 2))):
            self.request(-1)

    def free(self):
        """Drop what the program keeps between calls."""
        import gc
        gc.collect()

    # -- the numbers --------------------------------------------------------

    def metrics(self, records, window: float) -> dict:
        done = [r for r in records if not r["failed"]]
        return {"eigenpairs_per_s": len(done) / window,
                "solve_p90_s": percentile([r["t1"] - r["t0"]
                                           for r in records], 90)}

    def branch_gap(self, record) -> float:
        """Relative distance of a record's omega from the branch."""
        branch = self.traffic["branch"]
        key = next(iter(self.traffic.get("draw", {})), None)
        x = self.inputs(record["k"])[0][key] if key else None
        want = branch_omega(branch, x)
        return abs(record["omega"] - want) / abs(want)

    def check(self, records) -> list[dict]:
        spec = self.traffic["check"]
        limits = spec["limits"]
        done = [r for r in records if not r["failed"]]
        worst = {k: (math.inf if not done else 0.0) for k in limits}
        for r in done:
            gap = self.branch_gap(r)
            worst["branch_gap"] = max(worst["branch_gap"],
                                      gap if math.isfinite(gap) else math.inf)
        pick = self.check_rng.choice(len(done), min(len(done),
                                                    spec["requests"]),
                                     replace=False) if done else []
        n = self.input["npoints"] * (2 if float(self.input["beta_e"]) else 1)
        for i in sorted(pick):
            r = done[int(i)]
            cfg, _ = self.inputs(r["k"])
            rows = self.check_rng.choice(n, spec["rows"], replace=False)
            vec = np.array(r["vec"], dtype=np.float64)
            vec = vec[:, 0] + 1j * vec[:, 1]
            got = ref.row_check(cfg, r["omega"], vec, rows,
                                device=self.device,
                                chunk=ROW_CHUNK)
            for k in got:
                v = got[k]
                worst[k] = max(worst[k], v if math.isfinite(v) else math.inf)
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in worst.items()]

    # -- tracing -------------------------------------------------------------

    def spans(self):
        """(module, attribute, span, keep) of the layers this mix drives."""
        from portbench.roofline import k1
        sparse = self.input.get("eigen_backend", "dense") == "sparse"
        solver = ("emme_tpu_torch.solvers.sparse_eigen" if sparse
                  else "emme_tpu_torch.solvers.eigen")
        assembly = "assemble_bdia" if sparse else "assemble_matrix"

        def keep_k1(phase, args, kwargs, out):
            mid, halfw, pair, scal, order, ms = args
            shape = (int(mid.shape[0]), int(mid.shape[1]), int(order),
                     len(ms))
            if phase != "window":
                # a sample of the inputs, out of the window, for the share
                # of nodes on each side of the Bessel split
                return {"shape": shape,
                        "asym": k1.asymptotic_share(mid, halfw, pair, scal,
                                                    int(order))}
            return {"shape": shape}

        table = [(solver, "solve", "solver", None),
                 (solver, assembly, "assembly", None)]
        if self.device.type == "cuda":   # K1 launches on CUDA tensors only
            table.append(("emme_tpu_torch.ops.cuda_kappa", "_launch", "k1",
                          keep_k1))
        return table
