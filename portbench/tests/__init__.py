"""Part of the benchmark of emme_tpu_torch."""
