"""emme_tpu_torch: the PyTorch / CUDA port of emme_tpu.

The nonlinear eigensolve of the gyrokinetic kernel-integral operator
M(omega), dense (``solvers/eigen.py``) or never-dense block-banded
(``solvers/sparse_eigen.py``), with the transit-time kernel integral and the
block-sparse matvec as CUDA C++ kernels for Hopper (``ops/cuda_kappa.py``,
``ops/cuda_spmv.py``, ``csrc/``); and the delta-f PIC initial-value run
(``solvers/pic.py``), with its fused marker pass as CUDA C++ kernels
(``solvers/cuda_pic.py``, ``csrc/pic.cu``).  ``driver.run`` takes a job from
an input file (single solve, parameter scan with eigenvalue continuation,
multi-shift) to ``output.json``; ``python -m emme_tpu_torch.cli input.json``
is its command line.  Imports torch and numpy only.
"""
__version__ = "0.1.0"

from . import params, geometry  # noqa: F401
from .params import Params, from_config  # noqa: F401
