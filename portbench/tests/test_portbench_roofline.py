"""The yardstick's operation and byte counts against hand counts."""

import pytest

from portbench.roofline import common, k1, k3, n1


def test_tally_counts_each_operation_once():
    T = common.Tally()
    a, b = T.v(), T.v()
    _ = (a * b - a / b) + 2.0 * T.fn(a) - (-a)
    assert T.ops == 7   # *, /, -, fn, *, +, -  (a negation is free)


def test_k1_bessel_branches_by_hand():
    # Taylor: q (6), 26 terms x 2 series x (complex product 6, 2 scalings,
    # 1 add) = 468, I0 and the e^-w product (6, 6), I1 (2 + 6) -> 494.
    # Asymptotic: 1/w (6), 4 series x 10 x (6 + 1) = 280, sqrt(2 pi w)
    # (4 + 4), its inverse (2 + 6), e^-2w (6), two recessive terms
    # (6 + 2 each), the two sums times the prefactor (8 each) -> 340.
    for m in (1, 2, 3):
        assert k1.node_ops(False, m) - k1.node_ops(True, m) == 494 - 340


def test_k1_moments_add_a_product_and_a_sum():
    # each further moment: one complex product (6) and the Kronrod sum of
    # its two parts (2 products, 2 adds) = 10; the first moment's sum 4
    assert k1.node_ops(False, 2) - k1.node_ops(False, 1) == 10
    assert k1.node_ops(True, 3) - k1.node_ops(True, 2) == 10


@pytest.mark.parametrize("asym", [0.0, 0.25, 1.0])
def test_k1_call_work_at_a_small_shape(asym):
    npairs, panels, order, ms = 3, 4, 15, 2
    flop, nbytes = k1.call_work(npairs, panels, order, ms, asym)
    per = (1 - asym) * k1.node_ops(False, ms) + asym * k1.node_ops(True, ms)
    assert flop == pytest.approx(npairs * panels * order * per)
    # mids and half-widths, 4 pair floats, 8 scalars; 2 floats a moment
    assert nbytes == 4 * (2 * 3 * 4 + 4 * 3 + 8 + 2 * 2 * 3)


def test_k3_bessel_branches_by_hand():
    # J0 Taylor: q (2) + 30 x 3 = 92, J1 two more; the Hankel form: 8 / x,
    # its square, P (8), Q (9), x - x0, sqrt(c / x) (2), cos, sin and the
    # combination (6) = 28.  A stage after the first evaluates J1 and J0
    # at eta and J0 at the new eta; the first stage J1 and the new J0.
    assert (k3.stage_ops("0", False) - k3.stage_ops("0", True)
            == (94 - 28) + 2 * (92 - 28))
    assert (k3.stage_ops("0_first", False) - k3.stage_ops("0_first", True)
            == (94 - 28) + (92 - 28))
    # stage 2 combines two RK velocities: 2 x (2 products + 1 add)
    assert k3.stage_ops("2", False) - k3.stage_ops("1", False) == 6


def test_k3_run_work_at_a_small_shape():
    markers, steps, nf = 1024, 3, 128
    flop, nbytes = k3.run_work(markers, steps, nf, 0.0)
    per = [k3.stage_ops(v, False) for v in ("0_first", "0", "1", "2")]
    assert flop == markers * (per[0] + 2 * per[1] + 3 * (per[2] + per[3]))
    # the state fits the L2: each input once, each output once
    assert nbytes == markers * 44 + 4 * 2 * nf * 3 + 4 * 3 * steps
    # past the L2, every stage's loads and stores, less the L2's share
    big = 4 * 10**6
    _f, b = k3.run_work(big, steps, nf, 0.0)
    staged = big * (44 + 2 * 44 + 3 * (52 + 52))
    assert b == pytest.approx(staged * (1 - common.L2_BYTES / (big * 40)))


def test_n1_flop_by_hand():
    # one G7K15 panel of 15 nodes and 10 Miller steps
    assert n1.flop(1, 10, 15) == 16 * 10 + (176 + 5) * 15 + 19


def test_bound_takes_the_larger_side():
    t, side = common.bound_s(67e12, 1.0)
    assert t == pytest.approx(1.0) and side == "operations"
    t, side = common.bound_s(1.0, 3.35e12)
    assert t == pytest.approx(1.0) and side == "bytes"
