"""The readers of the set-up spans (``layers/pic_setup_idle_ms.pic.py``,
``pic_setup_launches_per_run.pic.py``, ``pic_host_reads_per_run.pic.py``,
``solve_setup_idle_share.eigen.py``, ``plan_idle_share.eigen.py``,
``plan_idle_share.survey.py``) on small summaries built by hand, in the
form ``tracing.summarize`` gives: times in ns on the profiler's clock,
spans as (k, 2) arrays of starts and ends."""

import numpy as np
import pytest

from portbench import harness, tracing

NEW = ("layer.pic.params", "layer.pic.qn", "layer.pic.arrs",
       "layer.solve.setup", "layer.assembly.plan")


def reader(name):
    return harness.load_module(harness.PKG / "layers" / f"{name}.py",
                               f"portbench_layer_{name.replace('.', '_')}")


def iv(*pairs):
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def summary():
    """Two requests, 0-1000 and 2000-3000 ns.  Five device operations,
    with idle gaps of 50 ns at 100, 250 ns at 250, 1450 ns at 600 and
    350 ns at 2150; launched at 50, 120, 390, unknown (-1) and 2300."""
    return {
        "window_s": 1e-5,
        "starts": np.array([0, 150, 500, 2050, 2500], dtype=np.int64),
        "durs": np.array([100, 100, 100, 100, 10], dtype=np.int64),
        "launch": np.array([50, 120, 390, -1, 2300], dtype=np.int64),
        "spans": {
            "portbench.request": iv((0, 1000), (2000, 3000)),
            # PIC: the set-up holds the gaps at 100, 250 and 2150 and the
            # launches at 120, 390 and 2300; four reads in requests
            "layer.pic.setup": iv((100, 400), (2100, 2400)),
            "layer.pic.params": iv((100, 200), (2100, 2200)),
            "layer.pic.qn": iv((200, 300), (2200, 2300)),
            "layer.pic.arrs": iv((300, 400), (2300, 2400)),
            "layer.host_read": iv((110, 120), (130, 140), (2110, 2120),
                                  (900, 910), (5000, 5010)),
            # eigen: the gaps at 100 and 2150 in the set-up, 250 in a plan
            "layer.solve.setup": iv((90, 120), (2140, 2160)),
            "layer.assembly.plan": iv((200, 300)),
        }}


RECORDS = [{"failed": False}, {"failed": False}, {"failed": True}]
WANT = {
    "pic_setup_idle_ms.pic": (50 + 250 + 350) * 1e-6 / 2,
    "pic_setup_launches_per_run.pic": 3 / 2,
    "pic_host_reads_per_run.pic": 4 / 2,
    "solve_setup_idle_share.eigen": 100.0 * (50 + 350) * 1e-9 / 1e-5,
    "plan_idle_share.eigen": 100.0 * 250 * 1e-9 / 1e-5,
    "plan_idle_share.survey": 100.0 * 250 * 1e-9 / 1e-5,
}
READS = {"pic_setup_idle_ms.pic": ["layer.pic.setup"],
         "pic_setup_launches_per_run.pic": ["layer.pic.setup"],
         "pic_host_reads_per_run.pic": ["layer.pic.params",
                                        "layer.host_read"],
         "solve_setup_idle_share.eigen": ["layer.solve.setup"],
         "plan_idle_share.eigen": ["layer.assembly.plan"],
         "plan_idle_share.survey": ["layer.assembly.plan"]}
# what a program from before the set-up spans reads: the PIC set-up's
# readers read its ``layer.pic.setup`` as they read this program's
PARENT = {name: (WANT[name] if name.startswith("pic_setup_") else None)
          for name in WANT}


def ctx(s=None):
    s = summary() if s is None else s
    return tracing.Context(cell=None, entry=None, records=RECORDS, summary=s,
                           spans=None, window_s=s["window_s"])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    assert reader(name).read(ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_the_parent_program(name, monkeypatch):
    """A program whose ``SPANS`` lacks the new names reads a number from
    its ``layer.pic.setup`` and nothing else: no reader raises, and no
    count of spans it never opens reads as zero."""
    from emme_tpu_torch.utils import timer
    monkeypatch.setattr(timer, "SPANS", tuple(s for s in timer.SPANS
                                              if s not in NEW))
    s = summary()
    for span in NEW:
        del s["spans"][span]
    got = reader(name).read(ctx(s))
    assert got == (None if PARENT[name] is None
                   else pytest.approx(PARENT[name], rel=1e-12))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_from_a_program_without_spans(name,
                                                           monkeypatch):
    from emme_tpu_torch.utils import timer
    monkeypatch.delattr(timer, "SPANS")
    assert reader(name).read(ctx()) is None


@pytest.mark.parametrize("name,span", [(n, s) for n in sorted(READS)
                                       for s in READS[n]])
def test_reader_raises_where_a_named_span_never_opened(name, span):
    c = ctx()
    del c.summary["spans"][span]
    with pytest.raises(RuntimeError, match=span.replace(".", r"\.")):
        reader(name).read(c)


def test_idle_counts_a_gap_inside_a_child_span():
    """A gap that begins inside ``layer.pic.params`` counts for the
    set-up that holds it: containment, not the innermost span."""
    s = summary()
    s["spans"]["layer.pic.setup"] = iv((0, 3000))
    s["spans"]["layer.pic.params"] = iv((240, 260))
    assert reader("pic_setup_idle_ms.pic").read(ctx(s)) == pytest.approx(
        (50 + 250 + 1450 + 350) * 1e-6 / 2, rel=1e-12)


def test_benchmark_lists_each_reader_where_its_span_opens():
    """The banded solve makes no assembly plan: ``plan_idle_share.eigen``
    leaves its cell out, and each cell listed reports the metric moved."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    assert "tokamak_itg.banded_f32.eta_scan.n8192" in \
        per_layer["solve_setup_idle_share.eigen"]["workloads"]
    assert "tokamak_itg.banded_f32.eta_scan.n8192" not in \
        per_layer["plan_idle_share.eigen"]["workloads"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in WANT:
        m = per_layer[name]
        assert set(m["workloads"]) <= set(cells)
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_nothing_from_a_window_without_device_work(name):
    """A traced run on the CPU sees no device operations: the device
    readers read nothing there, whichever spans opened (the survey makes
    no plan off the card's kernel route)."""
    s = summary()
    s.update(starts=s["starts"][:0], durs=s["durs"][:0],
             launch=s["launch"][:0])
    del s["spans"]["layer.assembly.plan"]
    got = reader(name).read(ctx(s))
    assert (got is None) == (name != "pic_host_reads_per_run.pic")
