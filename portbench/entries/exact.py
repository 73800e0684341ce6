"""The exact entry: each request is one eigenpair through the driver's
reference-exact backend (``eigen_backend`` "exact": the float64 adaptive
assembly, kernel N1 on the card, complex128 linear algebra), as a scan
point hands it.

The traffic file is the eigen entry's (``entries/eigen.py``): the request,
its draws, the warm-up and the metrics are that entry's.  What differs:

* a request counts as failed when its Newton loop used more than
  ``iteration_step_limit`` steps (the engine's loop runs one more before it
  gives up), or its omega is not finite;
* a warm-up request that fails stops the run: a program without the
  backend fails at once and cleanly, instead of timing 40 s of refusals;
* ``check`` holds each sampled eigenpair to ``rows`` seeded rows of the
  plain adaptive operator (``reference/adaptive.row_check``: the same
  integrals to the same tolerances, so a sound answer reads at its own
  rounding and Newton floor), and every eigenpair of the window to the
  branch (``branch_gap``, as the eigen entry);
* the traced run wraps ``eigen_native.solve`` (``solver``),
  ``native.assemble`` (``assembly``) and, on a card, kernel N1's launch
  (``n1``), whose keep stores the launch's panel and Miller-step sums as
  device scalars, read after the window.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.entries import eigen
from portbench.reference import adaptive as ref


class Entry(eigen.Entry):

    def request(self, k: int) -> dict:
        from emme_tpu_torch import driver
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
        steps = int(res["iteration_steps"])
        ok = math.isfinite(abs(omega)) and steps <= self.limit
        return {"k": k, "t0": t0, "t1": t1, "failed": not ok,
                "omega": omega, "vec": res["eigenvector"], "steps": steps}

    def setup(self):
        """The warm-up requests; the first that fails ends the run."""
        for _ in range(int(self.traffic.get("warmup", 2))):
            r = self.request(-1)
            if r["failed"]:
                raise RuntimeError(f"warm-up request failed: "
                                   f"{r.get('reason', 'not converged')}")

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
        n = int(self.input["npoints"])
        for i in sorted(pick):
            r = done[int(i)]
            cfg, _ = self.inputs(r["k"])
            rows = self.check_rng.choice(n, spec["rows"], replace=False)
            vec = np.array(r["vec"], dtype=np.float64)
            got = ref.row_check(cfg, r["omega"], vec[:, 0] + 1j * vec[:, 1],
                                rows, device=self.device)
            for key, v in got.items():
                worst[key] = max(worst[key], v if math.isfinite(v)
                                 else math.inf)
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in worst.items()]

    def spans(self):
        """(module, attribute, span, keep) of the layers this mix drives."""
        def keep_n1(phase, args, kwargs, out):
            if phase != "window":
                return None
            _vals, panels, miller = out
            return {"panels": panels.sum(), "miller": miller.sum(),
                    "order": int(args[2].order)}

        table = [("emme_tpu_torch.solvers.eigen_native", "solve", "solver",
                  None),
                 ("emme_tpu_torch.native", "assemble", "assembly", None)]
        if self.device.type == "cuda":   # N1 launches on CUDA tensors only
            table.append(("emme_tpu_torch.ops.cuda_adaptive", "_launch", "n1",
                          keep_n1))
        return table
