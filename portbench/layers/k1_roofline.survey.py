"""``k1_roofline.eigen`` read in the survey cell, whose end-to-end metric is
``solve_p90_s`` (one survey), not an eigenpair rate: the same reading of
the same trace."""

from portbench import harness

read = harness.load_module(harness.PKG / "layers" / "k1_roofline.eigen.py",
                           "portbench_layer_k1_roofline_eigen").read
