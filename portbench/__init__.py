"""The benchmark of emme_tpu_torch on one CUDA card (see harness.py)."""
