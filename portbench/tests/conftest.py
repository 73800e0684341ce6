"""Torch keeps to one thread a test process: pytest-xdist runs several
workers, and torch's CPU thread pools in each of them starve one another
(the eigen runs here took minutes instead of seconds with the default)."""

import torch

torch.set_num_threads(1)
