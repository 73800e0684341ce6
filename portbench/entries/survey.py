"""The survey entry: each request is one multi-shift survey at a scan
point, ``emme_tpu_torch.solvers.arnoldi.solve_shifts_batched``, as a
caller hands it: the parameters made from the request's input, then the
survey over the mix's shifts, timed from issue to a
``torch.cuda.synchronize()`` after its estimates.

The traffic file gives:

* ``set``: input keys the mix fixes (npoints), laid over the
  configuration's input; ``dtype`` ("float32" or "float64");
* ``draw``: the one input key drawn a request, ``{key: [lo, hi]}``, by the
  eigen entry's ``stratified`` (seeds change the order of the work, not
  its amount);
* ``shifts``: the survey's shifts as [re, im] pairs, the same every
  request; ``m_krylov``: the Arnoldi steps;
* ``warmup``: requests run in set-up at the middle of the drawn range;
* ``branch``: the scan's mode as the eigen entry reads it
  (``eigen.branch_omega``);
* ``check``: ``requests`` sampled from the window, ``shifts`` sampled a
  request, the reference's panel ``mesh`` (a key of
  ``reference/operator.MESH``) and the ``limits`` of the numbers compared.

A request fails where it raises or where any of its estimates is not
finite.  What is compared:

* ``estimate_gap``: on the sampled shifts of the sampled requests, the
  relative distance of the program's estimate from the plain reference's
  survey at that shift (``reference/survey.estimate``: the whole operator
  in float64 arithmetic on the check's panel mesh), the largest;
* ``mode_gap``: for every request, the least relative distance of its
  estimates from the branch's omega at its drawn value (the survey found
  the scan's mode), the largest.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.entries import eigen
from portbench.harness import percentile
from portbench.reference import operator as ref_op
from portbench.reference import survey as ref


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
        (self.key, (lo, hi)), = traffic["draw"].items()
        self.range = (lo, hi)
        rng = np.random.default_rng([seed, 1])
        self.draws = eigen.stratified(rng, lo, hi, self.MAX_REQUESTS)
        self.shifts = np.array([complex(*s) for s in traffic["shifts"]])
        self.m_krylov = int(traffic["m_krylov"])
        self.check_rng = np.random.default_rng([seed, 2])

    # -- the request ------------------------------------------------------

    def inputs(self, k: int) -> dict:
        """Input dict of request ``k`` (-1: the warm-up's, the middle of
        the drawn range)."""
        x = 0.5 * sum(self.range) if k < 0 \
            else float(self.draws[k % self.MAX_REQUESTS])
        return dict(self.input, **{self.key: x})

    def before(self, k: int):
        """Work of request ``k`` made before its clock starts: none."""

    def survey(self, cfg: dict, shifts, m_krylov: int):
        """The program's survey of ``cfg`` at ``shifts``."""
        from emme_tpu_torch import params
        from emme_tpu_torch.solvers import arnoldi
        p = params.from_config(cfg, dtype=self.dtype, device=self.device)
        return arnoldi.solve_shifts_batched(p, shifts, m_krylov=m_krylov)

    def request(self, k: int) -> dict:
        torch = self.torch
        cfg = self.inputs(k)
        t0 = time.perf_counter()
        try:
            ests = self.survey(cfg, self.shifts, self.m_krylov)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
        except (RuntimeError, ValueError, ArithmeticError) as e:
            t1 = time.perf_counter()
            return {"k": k, "t0": t0, "t1": t1, "failed": True,
                    "reason": f"{type(e).__name__}: {e}"}
        ests = [complex(e) for e in np.asarray(ests).reshape(-1)]
        ok = (len(ests) == len(self.shifts)
              and all(math.isfinite(abs(e)) for e in ests))
        return {"k": k, "t0": t0, "t1": t1, "failed": not ok,
                "estimates": ests, "shifts": len(ests)}

    def setup(self):
        """The warm-up requests; the first that fails ends the run."""
        for _ in range(int(self.traffic.get("warmup", 2))):
            r = self.request(-1)
            if r["failed"]:
                raise RuntimeError(f"warm-up survey failed: "
                                   f"{r.get('reason', 'an estimate is not finite')}")

    def free(self):
        """Drop what the program keeps between calls."""
        import gc
        gc.collect()

    # -- the numbers --------------------------------------------------------

    def metrics(self, records, window: float) -> dict:
        return {"solve_p90_s": percentile([r["t1"] - r["t0"]
                                           for r in records], 90)}

    def mode_gap(self, record) -> float:
        """The least relative distance of a record's estimates from the
        branch's omega at its drawn value."""
        want = eigen.branch_omega(self.traffic["branch"],
                                  self.inputs(record["k"])[self.key])
        gap = min(abs(e - want) for e in record["estimates"]) / abs(want)
        return gap if math.isfinite(gap) else math.inf

    def reference_estimate(self, cfg: dict, sigma: complex) -> complex:
        """The plain reference's survey estimate at ``sigma``: float64
        arithmetic on the check's panel mesh."""
        spec = self.traffic["check"]
        return ref.estimate(cfg, sigma, self.m_krylov,
                            dtype=self.torch.float64, device=self.device,
                            mesh=ref_op.MESH[spec.get("mesh", "float64")])

    def check(self, records) -> list[dict]:
        spec = self.traffic["check"]
        limits = spec["limits"]
        done = [r for r in records if not r["failed"]]
        worst = {k: (math.inf if not done else 0.0) for k in limits}
        for r in done:
            worst["mode_gap"] = max(worst["mode_gap"], self.mode_gap(r))
        pick = self.check_rng.choice(len(done), min(len(done),
                                                    spec["requests"]),
                                     replace=False) if done else []
        for i in sorted(pick):
            r = done[int(i)]
            cfg = self.inputs(r["k"])
            for j in sorted(self.check_rng.choice(len(self.shifts),
                                                  spec["shifts"],
                                                  replace=False)):
                want = self.reference_estimate(cfg, self.shifts[j])
                gap = abs(r["estimates"][j] - want) / abs(want)
                worst["estimate_gap"] = max(
                    worst["estimate_gap"],
                    gap if math.isfinite(gap) else math.inf)
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in worst.items()]

    # -- tracing -------------------------------------------------------------

    def spans(self):
        """(module, attribute, span, keep) of the layers this mix drives:
        the survey, the dense assembly and, on a card, K1's launch with
        the eigen entry's keep (``k1_roofline.eigen``)."""
        def keep_survey(phase, args, kwargs, out):
            if phase != "window":
                return None
            return {"shifts": len(np.asarray(args[1]).reshape(-1)),
                    "n": int(args[0].npoints)}

        # the eigen entry's K1 row: its keep reads self.input and
        # self.device alone, which this entry has too
        k1 = [t for t in eigen.Entry.spans(self) if t[2] == "k1"]
        return [("emme_tpu_torch.solvers.arnoldi", "solve_shifts_batched",
                 "solver", keep_survey),
                ("emme_tpu_torch.solvers.eigen", "assemble_matrix",
                 "assembly", None)] + k1
