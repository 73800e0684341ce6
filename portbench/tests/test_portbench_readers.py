"""The readers of the program's spans (``layers/guard_share.eigen.py``,
``assembly_idle_share.eigen.py``, ``linalg_share.eigen.py``,
``host_reads_per_eigenpair.eigen.py``, ``pic_prelaunch_ms.pic.py``) on small
summaries built by hand, in the form ``tracing.summarize`` gives: times in
ns on the profiler's clock, spans as (k, 2) arrays of starts and ends."""

import numpy as np
import pytest

from portbench import harness, tracing

READERS = ("guard_share.eigen", "assembly_idle_share.eigen",
           "linalg_share.eigen", "host_reads_per_eigenpair.eigen",
           "pic_prelaunch_ms.pic")


def reader(name):
    return harness.load_module(harness.PKG / "layers" / f"{name}.py",
                               f"portbench_layer_{name.replace('.', '_')}")


def iv(*pairs):
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def eigen_summary():
    """Two requests, 0-1000 and 1000-3000 ns, and five device operations:
    gaps of 50 ns at 100 (inside ``layer.assembly.pairs``), 100 ns at 200
    (in no assembly span) and 100 ns at 400 (inside
    ``layer.assembly.place``); operations launched at 250 (inside
    ``layer.linalg.step``), 320 (``layer.linalg.arnoldi``) and 700
    (``layer.linalg.vector``)."""
    starts = np.array([0, 150, 300, 350, 500], dtype=np.int64)
    durs = np.array([100, 50, 100, 10, 100], dtype=np.int64)
    return {
        "window_s": 1e-6,
        "starts": starts, "durs": durs,
        "launch": np.array([-1, 250, 320, 700, 10], dtype=np.int64),
        "spans": {
            "portbench.request": iv((0, 1000), (1000, 3000)),
            "layer.driver.guard": iv((600, 800), (2500, 2900), (5000, 5100)),
            "layer.assembly.pairs": iv((90, 120)),
            "layer.assembly.place": iv((390, 410)),
            "layer.linalg.step": iv((240, 260)),
            "layer.linalg.vector": iv((690, 710)),
            "layer.linalg.arnoldi": iv((315, 325)),
            "layer.host_read": iv((100, 110), (200, 210), (1500, 1600),
                                  (4000, 4100)),
        }}


def pic_summary():
    """Three requests; K3's span opens 4 ms into the first (and again at
    7 ms), 6 ms into the second, not in the third, and once outside."""
    ms = 1_000_000
    return {
        "window_s": 0.06, "starts": np.zeros(0, np.int64),
        "durs": np.zeros(0, np.int64), "launch": np.zeros(0, np.int64),
        "spans": {
            "portbench.request": iv((0, 10 * ms), (20 * ms, 30 * ms),
                                    (40 * ms, 50 * ms)),
            "layer.pic.k3": iv((4 * ms, 5 * ms), (7 * ms, 8 * ms),
                               (26 * ms, 28 * ms), (60 * ms, 61 * ms)),
        }}


RECORDS = [{"failed": False}, {"failed": False}, {"failed": True}]
WANT = {
    "guard_share.eigen": 100.0 * (200 + 400) / 3000,
    "assembly_idle_share.eigen": 100.0 * 150e-9 / 1e-6,
    "linalg_share.eigen": 100.0 * (50 + 100 + 10) / 360,
    "host_reads_per_eigenpair.eigen": 3 / 2,
    "pic_prelaunch_ms.pic": (4.0 + 6.0) / 2,
}
READS = {"guard_share.eigen": ["layer.driver.guard"],
         "assembly_idle_share.eigen": ["layer.assembly.pairs",
                                       "layer.assembly.place"],
         "linalg_share.eigen": ["layer.linalg.step", "layer.linalg.vector"],
         "host_reads_per_eigenpair.eigen": ["layer.host_read"],
         "pic_prelaunch_ms.pic": ["layer.pic.k3"]}


def ctx(name, summary=None):
    if summary is None:
        summary = pic_summary() if name.endswith(".pic") else eigen_summary()
    return tracing.Context(cell=None, entry=None, records=RECORDS,
                           summary=summary, spans=None,
                           window_s=summary["window_s"])


@pytest.mark.parametrize("name", READERS)
def test_reader_value(name):
    assert reader(name).read(ctx(name)) == pytest.approx(WANT[name],
                                                          rel=1e-12)


@pytest.mark.parametrize("name,span", [(n, s) for n in READERS
                                       for s in READS[n]])
def test_reader_raises_naming_an_absent_span(name, span):
    c = ctx(name)
    del c.summary["spans"][span]
    with pytest.raises(RuntimeError, match=span.replace(".", r"\.")):
        reader(name).read(c)


@pytest.mark.parametrize("name", READERS)
def test_reader_raises_on_a_span_the_program_does_not_name(name,
                                                           monkeypatch):
    from emme_tpu_torch.utils import timer
    monkeypatch.setattr(timer, "SPANS", ())
    with pytest.raises(RuntimeError, match="never opened"):
        reader(name).read(ctx(name))


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_spans(name,
                                                           monkeypatch):
    """A program that opens no spans of its own (no ``SPANS``) reads as no
    value: the metric is left out of the line, and the run goes on."""
    from emme_tpu_torch.utils import timer
    monkeypatch.delattr(timer, "SPANS")
    assert reader(name).read(ctx(name)) is None


def test_linalg_share_holds_the_banded_arnoldi_stage():
    """Without the Arnoldi span (the dense cells) its operation counts as
    any other; the reader needs only the step and vector spans."""
    c = ctx("linalg_share.eigen")
    del c.summary["spans"]["layer.linalg.arnoldi"]
    assert reader("linalg_share.eigen").read(c) == pytest.approx(
        100.0 * (50 + 10) / 360, rel=1e-12)


def test_pic_prelaunch_needs_a_launch_inside_a_request():
    c = ctx("pic_prelaunch_ms.pic")
    c.summary["spans"]["layer.pic.k3"] = iv((60_000_000, 61_000_000))
    with pytest.raises(RuntimeError, match="no request"):
        reader("pic_prelaunch_ms.pic").read(c)
