"""Exhaustive check of the constant division of csrc/pic.cu (div_const).

    python3 emme_tpu_torch/tools/div_const_check.py

For each of the 60 Taylor divisors of J0 (k^2) and J1 (k (k + 1)), k = 1..30,
and every one of the 2^23 float32 mantissas, the three-operation sequence
r = RN(1 / c), q = RN(a r), e = a - c q (one FMA), RN(q + e r) (one FMA) is
compared with the IEEE quotient RN(a / c).  Runs on the CPU with numpy, in
about a minute; prints one JSON line and exits non-zero on a mismatch.

The emulation is exact: a product of two float32 values is exact in
float64; the remainder e is a float32 value (asserted); and q + e r is held
as an unevaluated float64 sum (TwoSum), which rounds to float32 like its
leading term except where that term is a float32 tie, decided by the
trailing term's sign.  The exponent does not matter while no subnormal is
involved, so the mantissas of [1, 2) stand for all numerators.
"""

import json
import sys
import time

import numpy as np

DIVISORS = sorted({k * k for k in range(1, 31)}
                  | {k * (k + 1) for k in range(1, 31)})
CHUNK = 1 << 21


def two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def rn32(s, t):
    """RN to float32 of the exact value s + t (s = RN64(s + t))."""
    f = s.astype(np.float32)
    f64 = f.astype(np.float64)
    other = np.where(f64 > s, np.nextafter(f, np.float32(-np.inf)),
                     np.nextafter(f, np.float32(np.inf)))
    tie = ((f64 != s) & (t != 0)
           & (np.abs(f64 - s) == np.abs(s - other.astype(np.float64))))
    toward = np.where(t > 0, np.maximum(f, other), np.minimum(f, other))
    return np.where(tie, toward, f)


def div_const(a, c):
    c32 = np.float32(c)
    r = np.float64(np.float32(1) / c32)
    a64 = a.astype(np.float64)
    q = (a64 * r).astype(np.float32).astype(np.float64)
    e = a64 - np.float64(c32) * q
    if not np.array_equal(e.astype(np.float32).astype(np.float64), e):
        raise AssertionError(f"remainder not a float32 value, c = {c}")
    return rn32(*two_sum(q, e * r))


def main():
    t0 = time.perf_counter()
    bad = {}
    for c in DIVISORS:
        for lo in range(0, 1 << 23, CHUNK):
            bits = np.arange(lo, lo + CHUNK, dtype=np.uint32)
            a = (bits | np.uint32(0x3F800000)).view(np.float32)
            n = int((div_const(a, c) != a / np.float32(c)).sum())
            if n:
                bad[c] = bad.get(c, 0) + n
    print(json.dumps({"divisors": len(DIVISORS), "mantissas": 1 << 23,
                      "mismatches": bad,
                      "seconds": time.perf_counter() - t0}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
