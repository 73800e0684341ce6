"""emme_tpu_torch.utils (timer, provenance, debug) against emme_tpu.utils on
the CPU: the same report for the same entries, thread safety, the
provenance formats, the input validation and the finiteness checks."""
import concurrent.futures
import re
import time

import numpy as np
import pytest
import torch

from emme_tpu.utils import debug as jdebug
from emme_tpu.utils import provenance as jprovenance
from emme_tpu.utils import timer as jtimer
import emme_tpu
import emme_tpu_torch as et
from emme_tpu_torch.ops.sparse import BDIAOperator
from emme_tpu_torch.utils import debug, provenance, timer
from emme_tpu_torch.utils.timer import Timer, section


class TestTimer:
    def test_accumulates_and_reports(self):
        t = Timer()
        t.start_timing("A")
        time.sleep(0.01)
        t.pause_timing("A")
        t.start_timing("A")
        time.sleep(0.01)
        t.pause_timing("A")
        assert t.timings()["A"] >= 0.02
        rep = t.report()
        assert "Time consumption" in rep and "| A" in rep

    def test_report_layout_equals_jax_package(self):
        """The same entries with the same seconds give the same table,
        character for character; an empty timer the same placeholder."""
        mine, ref = Timer(), jtimer.Timer()
        assert mine.report() == ref.report() == "(no timings)"
        for t in (mine, ref):
            for name, secs in (("All", 12.3456789), (" - linear solve", 0.5),
                               ("Output", 1.25e-4)):
                t.start_timing(name)
                t.pause_timing(name)
                t._acc[name] = secs
        assert mine.report() == ref.report()
        assert mine.entries == ref.entries
        assert mine.timings() == ref.timings()

    def test_pause_and_start_switches_section(self):
        t = Timer()
        t.start_timing("x")
        t.pause_and_start("y")
        time.sleep(0.005)
        t.pause_timing("y")
        assert set(t.timings()) == {"x", "y"}
        assert t.timings()["y"] > 0
        t.pause_timing("never started")   # a lost race is a no-op
        t.reset()
        assert t.timings() == {} and t.entries == []

    def test_section_context_manager(self):
        assert Timer.get_timer() is Timer.get_timer()
        Timer.get_timer().reset()
        with section("ctx"):
            time.sleep(0.005)
        assert Timer.get_timer().timings()["ctx"] > 0
        with pytest.raises(RuntimeError):
            with section("raises"):
                raise RuntimeError("passes through")
        assert "raises" in Timer.get_timer().timings()

    def test_concurrent_sections_thread_safe(self):
        """scan_workers > 1 enters and leaves the SAME section names from
        several threads (tests/test_utils.py:44)."""
        Timer.get_timer().reset()
        errors = []

        def worker(_):
            try:
                for _ in range(200):
                    with section("Iteration"):
                        pass
                    with section("Output"):
                        pass
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            list(ex.map(worker, range(4)))
        assert not errors
        assert Timer.get_timer().timings()["Iteration"] >= 0

    def test_sync_is_a_no_op_for_cpu_tensors(self):
        timer.sync(torch.ones(2))


class TestProvenance:
    ISO = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}[+-]\d{2}:\d{2}$")

    def test_date_string_iso_with_colon_tz(self):
        assert self.ISO.match(provenance.date_string())
        assert provenance.date_string()[:13] == jprovenance.date_string()[:13]

    def test_build_time_format(self):
        assert self.ISO.match(provenance.build_time())

    def test_git_hash_is_the_checkouts(self):
        h = provenance.git_commit_hash()
        assert h is None or re.match(r"^[0-9a-f]{40}$", h)
        assert h == jprovenance.git_commit_hash()


BAD_CASES = [
    (dict(eigen_backend="sparse", band_block=7), "band_block"),
    (dict(method="PIC", marker_per_cell=-4), "marker_per_cell"),
    (dict(method="PIC", marker_per_cell=4, time_step=0.0), "time_step"),
    (dict(npoints=31), "npoints must be even"),
    (dict(vt=-1.0), "vt must be > 0"),
    (dict(mesh={"rows": 5}), "mesh rows"),
]


@pytest.mark.parametrize("extra,match", BAD_CASES,
                         ids=[m for _, m in BAD_CASES])
def test_validate_problem_matches_jax_package(tokamak_cfg, extra, match):
    """The good input passes both; each bad one raises the same message in
    both packages."""
    good = dict(tokamak_cfg, npoints=32)
    debug.validate_problem(et.from_config(good, device="cpu"), good)
    jdebug.validate_problem(emme_tpu.from_config(good), good)
    cfg = dict(good, **extra)
    with pytest.raises(ValueError, match=match) as mine:
        debug.validate_problem(et.from_config(cfg, device="cpu"), cfg)
    with pytest.raises(ValueError, match=match) as ref:
        jdebug.validate_problem(emme_tpu.from_config(cfg), cfg)
    assert str(mine.value) == str(ref.value)


def test_check_finite():
    """Off by default and a no-op; once enabled it names the stage and
    counts the bad values, for tensors, arrays, numbers and block
    operators."""
    bad = torch.tensor([1.0, float("nan"), float("inf")])
    assert not debug.nan_checks_enabled()
    debug.check_finite("off", bad)
    debug.enable_nan_checks()
    try:
        assert debug.nan_checks_enabled()
        debug.check_finite("fine", torch.ones(3, dtype=torch.complex64))
        debug.check_finite("omega", -0.8 + 0.25j)
        debug.check_finite("stats", np.ones((2, 3)))
        with pytest.raises(FloatingPointError, match="PIC field holds 2"):
            debug.check_finite("PIC field", bad)
        with pytest.raises(FloatingPointError, match="omega"):
            debug.check_finite("omega", complex(float("nan"), 0.0))
        data = torch.ones((1, 2, 2, 2), dtype=torch.complex128)
        op = BDIAOperator(data=data, offsets=(0,), n=4, block=2)
        debug.check_finite("operator", op)
        data[0, 1, 0, 0] = complex(0.0, float("inf"))
        with pytest.raises(FloatingPointError, match="operator"):
            debug.check_finite("operator", op)
    finally:
        debug.disable_nan_checks()
    assert not debug.nan_checks_enabled()
    debug.check_finite("off again", bad)
