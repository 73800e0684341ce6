"""``assembly_idle_share.eigen`` read in the survey cell, whose end-to-end metric is
``solve_p90_s`` (one survey), not an eigenpair rate: the same reading of
the same trace."""

from portbench import harness

read = harness.load_module(harness.PKG / "layers" / "assembly_idle_share.eigen.py",
                           "portbench_layer_assembly_idle_share_eigen").read
