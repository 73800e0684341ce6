"""Simulation parameters as a frozen dataclass of torch scalars.

The reference holds these in a virtual-dispatch ``struct Parameters``
(``include/Parameters.h:10-120``, ``src/Parameters.cpp:10-74``).
Counterpart of ``emme_tpu/params.py``.

Scalar choice: every physical field is a 0-d tensor of the working ``dtype``
on the working ``device`` (as the JAX ``Params`` holds its leaves in the
working dtype).  So on the float32 main path the derived scalars
(``omega_s_i``, ``omega_d_bar``, ...) are computed in float32, exactly as in
``emme_tpu``, and no step of the solve reads a scalar back to the host.
Structural settings (grid size, geometry, quadrature controls) are plain
Python values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from . import geometry

DYNAMIC_FIELDS = (
    "q", "shat", "tau", "epsilon_n", "epsilon_r", "eta_i", "eta_e",
    "b_theta", "beta_e", "R", "vt", "omega_d_coeff", "length", "theta",
    "arc_coeff", "water_bag_weight_vpara", "water_bag_weight_vperp",
    "eta_k", "lh", "mh", "epsilon_h_t", "alpha_0", "r_over_R",
    "cyl_shat_coeff",
)

STATIC_FIELDS = (
    "conf", "npoints", "iteration_step_limit", "integration_precision",
    "integration_accuracy", "integration_iteration_limit",
    "integration_start_points", "drift_center_transformation_switch",
    "electromagnetic",
)


@dataclass(frozen=True)
class Params:
    # --- physical scalars (0-d tensors of the working dtype) ---
    q: Any
    shat: Any
    tau: Any
    epsilon_n: Any
    epsilon_r: Any
    eta_i: Any
    eta_e: Any
    b_theta: Any          # k_rho^2 (Parameters.cpp:44)
    beta_e: Any
    R: Any
    vt: Any
    omega_d_coeff: Any
    length: Any
    theta: Any
    arc_coeff: Any
    water_bag_weight_vpara: Any
    water_bag_weight_vperp: Any
    # stellarator extras (zero for other geometries)
    eta_k: Any
    lh: Any
    mh: Any
    epsilon_h_t: Any
    alpha_0: Any
    r_over_R: Any
    # cylinder geometry's precomputed <cos + a x sin> average (the reference
    # Cylinder ctor computes it once, Parameters.cpp:395-402)
    cyl_shat_coeff: Any = 0.0
    # --- static structure ---
    conf: str = "tokamak"
    npoints: int = 128
    iteration_step_limit: int = 20
    integration_precision: float = 1e-6
    integration_accuracy: float = 1e-6
    integration_iteration_limit: int = 100
    integration_start_points: int = 15
    drift_center_transformation_switch: bool = False
    electromagnetic: bool = False   # beta_e != 0 at build time (solver.h:406)

    @property
    def dtype(self) -> torch.dtype:
        return self.length.dtype

    @property
    def device(self) -> torch.device:
        return self.length.device

    # -- derived quantities --
    @property
    def alpha(self):
        return geometry.alpha_f(self)

    @property
    def omega_s_i(self):
        return geometry.omega_s_i_f(self)

    @property
    def omega_s_e(self):
        return geometry.omega_s_e_f(self)

    @property
    def omega_d_bar(self):
        return geometry.omega_d_bar_f(self)

    def g(self, eta):
        return geometry.g_integration_f(self, eta)

    def bi(self, eta):
        return geometry.bi_f(self, eta)

    def beta_1(self, eta, eta_p):
        """Reference Parameters.cpp:87-90."""
        return (self.q * self.R) / self.vt * self.omega_d_bar * (
            self.g(eta) - self.g(eta_p))

    def beta_1_e(self, eta, eta_p):
        """Reference Parameters.cpp:92-95."""
        return (self.q * self.R) / self.vt * (
            self.omega_d_bar * self.omega_s_e / self.omega_s_i) * (
            self.g(eta) - self.g(eta_p))


_DEFAULTS = {
    "epsilon_r": 0.0,
    "theta": 0.0,
    "arc_coeff": 100.0,
    "omega_d_coeff": 1.0,
    "water_bag_weight_vpara": 1.0,
    "water_bag_weight_vperp": 1.0,
    "eta_k": 0.0,
    "lh": 1.0,
    "mh": 1.0,
    "epsilon_h_t": 0.0,
    "alpha_0": 0.0,
    "r_over_R": 0.0,
    "iteration_step_limit": 20,
    "integration_precision": 1e-6,
    "integration_accuracy": 1e-6,
    "integration_iteration_limit": 100,
    "integration_start_points": 15,
    "drift_center_transformation_switch": False,
}


def from_config(cfg: dict, dtype=torch.float64, device="cpu") -> Params:
    """Build ``Params`` from a parsed input dict (reference input.json schema,
    ``Parameters.cpp:36-66``).  ``k_rho`` maps to ``b_theta = k_rho**2``.
    Missing optional keys fall back to reference-compatible defaults; the
    required physical keys raise KeyError just as the reference's
    ``input.at()`` throws (JsonParser.h:63-65).
    """
    conf = cfg["conf"]
    if conf not in geometry.GEOMETRIES:
        raise ValueError("Input configuration not supported yet.")

    def get(key, required=True):
        if key in cfg:
            return cfg[key]
        if not required and key in _DEFAULTS:
            return _DEFAULTS[key]
        raise KeyError(f"Failed to accessing key: {key}")

    def arr(v):
        return torch.as_tensor(float(v), dtype=dtype, device=device)

    beta_e = float(get("beta_e"))
    kwargs = dict(
        q=arr(get("q")),
        shat=arr(get("shat")),
        tau=arr(get("tau")),
        epsilon_n=arr(get("epsilon_n")),
        epsilon_r=arr(get("epsilon_r", required=False)),
        eta_i=arr(get("eta_i")),
        eta_e=arr(get("eta_e")),
        b_theta=arr(float(get("k_rho")) ** 2),
        beta_e=arr(beta_e),
        R=arr(get("R")),
        vt=arr(get("vt")),
        omega_d_coeff=arr(get("omega_d_coeff", required=False)),
        length=arr(get("length")),
        theta=arr(get("theta", required=False)),
        arc_coeff=arr(get("arc_coeff", required=False)),
        water_bag_weight_vpara=arr(get("water_bag_weight_vpara", required=False)),
        water_bag_weight_vperp=arr(get("water_bag_weight_vperp", required=False)),
        eta_k=arr(get("eta_k", required=False)),
        lh=arr(get("lh", required=False)),
        mh=arr(get("mh", required=False)),
        epsilon_h_t=arr(get("epsilon_h_t", required=False)),
        alpha_0=arr(get("alpha_0", required=False)),
        r_over_R=arr(get("r_over_R", required=False)),
        cyl_shat_coeff=arr(0.0),
        conf=conf,
        npoints=int(get("npoints")),
        iteration_step_limit=int(get("iteration_step_limit", required=False)),
        integration_precision=float(get("integration_precision", required=False)),
        integration_accuracy=float(get("integration_accuracy", required=False)),
        integration_iteration_limit=int(get("integration_iteration_limit", required=False)),
        integration_start_points=int(get("integration_start_points", required=False)),
        drift_center_transformation_switch=bool(
            get("drift_center_transformation_switch", required=False)),
        electromagnetic=(beta_e != 0.0),
    )
    if conf == "stellarator":
        # stellarator-required keys (Parameters.cpp:211-223)
        for key in ("eta_k", "lh", "mh", "epsilon_h_t", "alpha_0", "r_over_R"):
            kwargs[key] = arr(get(key))
    if conf == "cylinder":
        # precompute the <cos + a x sin> average once, like the reference
        # Cylinder ctor (Parameters.cpp:395-402)
        kwargs["cyl_shat_coeff"] = geometry.cylinder_shat_coeff(
            arr(get("shat")))
    return Params(**kwargs)
