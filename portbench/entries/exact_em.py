"""The electromagnetic exact entry: the exact entry's request (one
eigenpair through the driver's reference-exact backend, ``entries/exact.py``)
on an electromagnetic input, whose operator is 2N x 2N (phi and A_par).

What differs from the exact entry:

* ``check`` holds each sampled eigenpair to ``rows`` seeded rows of the
  plain adaptive electromagnetic operator
  (``reference/adaptive_em.row_check``: each (pair, moment) integral to the
  file's tolerances, the electron closed forms, the 2N x 2N layout), half
  drawn from the phi block and half from the A_par block, and every
  eigenpair of the window to the branch (``branch_gap``);
* the N1 keep also stores each launch's integral count, for
  ``n1_panels_per_integral.eigen``.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.entries import exact
from portbench.reference import adaptive_em as ref


class Entry(exact.Entry):

    def check_rows(self):
        """``rows`` seeded rows of the 2N x 2N operator: half of the phi
        block's, half of the A_par block's."""
        n = int(self.input["npoints"])
        half = int(self.traffic["check"]["rows"]) // 2
        return np.concatenate([self.check_rng.choice(n, half, replace=False),
                               n + self.check_rng.choice(n, half,
                                                         replace=False)])

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
        for i in sorted(pick):
            r = done[int(i)]
            cfg, _ = self.inputs(r["k"])
            vec = np.array(r["vec"], dtype=np.float64)
            got = ref.row_check(cfg, r["omega"], vec[:, 0] + 1j * vec[:, 1],
                                self.check_rows(), device=self.device)
            for key, v in got.items():
                worst[key] = max(worst[key], v if math.isfinite(v)
                                 else math.inf)
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in worst.items()]

    def spans(self):
        """The exact entry's table; N1's keep adds the launch's integral
        count."""
        def with_count(keep):
            def keep_n1(phase, args, kwargs, out):
                kept = keep(phase, args, kwargs, out)
                if kept is not None:
                    kept["integrals"] = int(args[0].shape[0])
                return kept
            return keep_n1

        return [(mod, attr, name, with_count(keep) if name == "n1" else keep)
                for mod, attr, name, keep in super().spans()]
