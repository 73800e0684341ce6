"""The PIC entry: each request is one delta-f PIC run of the configuration
on fresh marker draws, as an ensemble of marker-noise realisations of one
case: ``pic.state_from_draws`` -> ``cuda_pic.run(state=...)`` ->
``pic.calculate_omega`` (the driver's default fit).

The draws (eta uniform on [-L, L), z_para and z_perp standard normal with
no exact zero, w0 uniform on [0, 0.001)) are made by the benchmark on the
device from the seed and the request's number, before the request's
clock starts.  The traffic file gives ``set`` (input keys laid over the
configuration's), ``dtype``, ``warmup`` and ``check``: ``requests``
sampled from the window and the ``limits``.

What is compared, for each sampled run (``compare``):

* against the plain float64 run of ``reference/pic.py`` from the same
  draws: the field's statistics series (mean Re, mean Im, rms a step) as
  the largest gap over the steps, each step's gap taken against that
  step's reference rms (``field_gap``), and the fitted growth rate gamma
  as a relative gap (``gamma_gap``);
* the fit: the growth rate gamma the program returned against the
  reference's fit of the run's own series (``fit_gap``, relative): the same
  formula on the same numbers, apart from the program's float32 logarithms.
  The frequency is not held: it counts peaks, so a rounding that moves one
  peak moves it by a whole peak spacing.

``compare`` also gives the frequency's gap (``omega_gap``) and each step's
gap (kept for ``calibrate.py``); the traffic's ``limits`` name the numbers
held.
"""

from __future__ import annotations

import math
import time

import numpy as np

from portbench.harness import percentile
from portbench.reference import pic as ref


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import torch
        self.torch = torch
        self.traffic = traffic
        self.device = device
        self.seed = seed
        self.input = dict(config["input"], **traffic.get("set", {}))
        self.dtype = {"float32": torch.float32,
                      "float64": torch.float64}[traffic["dtype"]]
        self.mpc = int(self.input["marker_per_cell"])
        self.n_steps = int(self.input["step_number"])
        self.dt = float(self.input["time_step"])
        self.markers = self.mpc * int(self.input["npoints"])
        self.check_rng = np.random.default_rng([seed, 2])
        self.p = None
        self._draws = None
        self.last_gaps = []      # each checked run's gaps a step

    def draws(self, k: int, dtype=None):
        """The marker draws of request ``k`` (-1: the warm-up's), on the
        device."""
        torch = self.torch
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.SeedSequence([self.seed, 3, k + 1])
                          .generate_state(1, np.uint64)[0] >> np.uint64(1)))
        kw = dict(generator=g, dtype=dtype or self.dtype, device=self.device)
        n = self.markers
        L = float(self.input["length"])
        eta = torch.rand(n, **kw) * (2.0 * L) - L

        def normal():
            z = torch.randn(n, **kw)
            zero = z == 0
            while bool(zero.any()):
                z[zero] = torch.randn(int(zero.sum()), **kw)
                zero = z == 0
            return z

        z_para = normal()
        z_perp = normal()
        w0 = torch.rand(n, **kw) * 0.001
        return eta, z_para, z_perp, w0

    def before(self, k: int):
        self._draws = self.draws(k)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def request(self, k: int) -> dict:
        from emme_tpu_torch.solvers import cuda_pic, pic
        torch = self.torch
        draws, self._draws = self._draws, None
        t0 = time.perf_counter()
        try:
            state = pic.state_from_draws(self.p, *draws, dtype=self.dtype)
            stats, _state, _ = cuda_pic.run(
                self.p, self.mpc, self.n_steps, self.dt, state=state)
            omega = pic.calculate_omega(stats, self.dt)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
        except (RuntimeError, ValueError, ArithmeticError) as e:
            t1 = time.perf_counter()
            return {"k": k, "t0": t0, "t1": t1, "failed": True,
                    "reason": f"{type(e).__name__}: {e}"}
        stats = stats.detach().cpu().numpy().astype(np.float64)
        ok = bool(np.isfinite(stats).all()) and math.isfinite(abs(omega))
        return {"k": k, "t0": t0, "t1": t1, "failed": not ok,
                "stats": stats, "omega": omega,
                "path": cuda_pic.LAST_LAUNCH}

    def setup(self):
        from emme_tpu_torch import from_config
        self.p = from_config(self.input, dtype=self.dtype, device=self.device)
        # a failed warm-up run is the window's to report
        for _ in range(int(self.traffic.get("warmup", 2))):
            self.before(-1)
            self.request(-1)

    def free(self):
        import gc
        self._draws = None
        gc.collect()

    # -- the numbers --------------------------------------------------------

    def metrics(self, records, window: float) -> dict:
        done = [r for r in records if not r["failed"]]
        return {"pic_marker_steps_per_s":
                len(done) * self.markers * self.n_steps / window,
                "pic_run_p90_s": percentile([r["t1"] - r["t0"]
                                             for r in records], 90)}

    def check(self, records) -> list[dict]:
        spec = self.traffic["check"]
        limits = spec["limits"]
        done = [r for r in records if not r["failed"]]
        worst = {k: (math.inf if not done else 0.0) for k in limits}
        pick = self.check_rng.choice(len(done), min(len(done),
                                                    spec["requests"]),
                                     replace=False) if done else []
        self.last_gaps = []
        for i in sorted(pick):
            r = done[int(i)]
            gaps = compare(r["stats"], r["omega"], *self.reference(r["k"]),
                           dt=self.dt)
            self.last_gaps.append(gaps["per_step"])
            for key in worst:
                worst[key] = max(worst[key], gaps[key])
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in worst.items()]

    def reference(self, k: int):
        """The plain float64 run of request ``k``'s draws: (stats, fit)."""
        draws = tuple(d.to(self.torch.float64) for d in self.draws(k))
        stats, _field = ref.run(self.input, draws, self.n_steps, self.dt)
        return stats, ref.fit(stats, self.dt)

    # -- tracing -------------------------------------------------------------

    def spans(self):
        return [("emme_tpu_torch.solvers.pic", "state_from_draws",
                 "pic_state", None),
                ("emme_tpu_torch.solvers.cuda_pic", "run", "pic_run", None),
                ("emme_tpu_torch.solvers.pic", "calculate_omega", "pic_fit",
                 None)]


def step_gaps(stats, ref_stats) -> np.ndarray:
    """Each step's largest gap of the statistics from the reference's, over
    that step's reference rms."""
    stats = np.asarray(stats, dtype=np.float64)
    if not np.isfinite(stats).all():
        return np.full(len(ref_stats), math.inf)
    rms = np.asarray(ref_stats)[:, 2:3]
    return np.max(np.abs(stats - ref_stats) / rms, axis=1)


def compare(stats, omega: complex, ref_stats, ref_omega: complex,
            dt: float) -> dict:
    """Gaps of a run's statistics and fit from the reference's."""
    gaps = step_gaps(stats, ref_stats)

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a - b)
    own = ref.fit(stats, dt).imag if np.isfinite(gaps).all() else math.nan
    fit = rel(omega.imag, own)
    return {"field_gap": float(gaps.max()),
            "fit_gap": fit if math.isfinite(fit) else math.inf,
            "gamma_gap": rel(omega.imag, ref_omega.imag),
            "omega_gap": rel(omega.real, ref_omega.real),
            "per_step": gaps}
