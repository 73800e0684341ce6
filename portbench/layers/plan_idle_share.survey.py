"""``plan_idle_share.eigen`` read in the survey cell (a plan a shift),
whose end-to-end metric is ``solve_p90_s`` (one survey): the same reading
of the same trace."""

from portbench import harness

read = harness.load_module(harness.PKG / "layers" / "plan_idle_share.eigen.py",
                           "portbench_layer_plan_idle_share_eigen").read
