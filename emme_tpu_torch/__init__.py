"""emme_tpu_torch: the PyTorch / CUDA port of emme_tpu.

The dense nonlinear eigensolve of the gyrokinetic kernel-integral operator
M(omega), in PyTorch, with the transit-time kernel integral as a CUDA C++
kernel for Hopper (``ops/cuda_kappa.py``, ``csrc/kappa.cu``); and the delta-f
PIC initial-value run (``solvers/pic.py``), with its fused marker pass as
CUDA C++ kernels (``solvers/cuda_pic.py``, ``csrc/pic.cu``).  Imports torch
and numpy only.
"""
__version__ = "0.1.0"

from . import params, geometry  # noqa: F401
from .params import Params, from_config  # noqa: F401
