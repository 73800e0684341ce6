"""emme_tpu_torch.ops.banded (block-banded LU, solves, selected inverse and
trace) vs emme_tpu's ops/banded.py and vs numpy's dense algebra on the CPU,
on tests/test_banded.py's random banded matrices and its near-singular
shift."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from emme_tpu.ops import banded as jbanded
from emme_tpu.ops import sparse as jsparse
from emme_tpu_torch.ops import banded, sparse

torch.set_num_threads(2)

CASES = [(64, 16, 1), (96, 16, 2), (128, 32, 3)]


def _random_banded(n, block, h, seed=0, diag_boost=2.0):
    """tests/test_banded.py::_random_banded: random complex banded matrix
    with a boosted diagonal (the operator's 1 + 1/tau identity term)."""
    rng = np.random.default_rng(seed)
    nb = n // block
    M = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))) / np.sqrt(n)
    keep = np.abs(np.subtract.outer(np.arange(nb), np.arange(nb))) <= h
    M = np.where(np.kron(keep, np.ones((block, block), bool)), M, 0.0)
    return M + diag_boost * np.eye(n)


def _symmetric(M):
    """The complex-symmetric part (M + M^T) / 2: the selected inverse and
    the trace product assume the operator's symmetry."""
    return 0.5 * (M + M.T)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n,block,h", CASES)
def test_solve_matches_jax_and_dense(n, block, h):
    """LU + solve (vector and 3 right-hand sides): within 1e-12 relative of
    emme_tpu's, within 1e-10 of numpy's dense solve."""
    M = _random_banded(n, block, h)
    op = sparse.bdia_from_dense(M, block=block, device="cpu")
    lu = banded.banded_lu(op)
    assert lu.h == h and lu.W.shape == (n // block + h, 2 * h + 1, block,
                                        block)
    jlu = jbanded.banded_lu(jsparse.bdia_from_dense(M, block=block))
    rng = np.random.default_rng(1)
    for shape in ((n,), (n, 3)):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        z = banded.banded_solve(lu, torch.as_tensor(x)).numpy()
        assert z.shape == shape
        zr, zi = jbanded.banded_solve(jlu, jnp.asarray(x.real),
                                      jnp.asarray(x.imag))
        assert _rel(z, np.asarray(zr) + 1j * np.asarray(zi)) < 1e-12
        assert _rel(z, np.linalg.solve(M, x)) < 1e-10
    W = lu.W.numpy()
    jW = np.asarray(jlu.W)
    assert _rel(W, jW[:, :, 0] + 1j * jW[:, :, 1]) < 1e-12


@pytest.mark.parametrize("n,block,h", CASES)
def test_selected_inverse_and_trace(n, block, h):
    """Selected inverse (band blocks of M^{-1}) and tr(M^{-1} A) for complex
    symmetric M, A: within 1e-12 relative of emme_tpu's, within 1e-10 of
    numpy's dense inverse and trace."""
    M = _symmetric(_random_banded(n, block, h, seed=2))
    A = _symmetric(_random_banded(n, block, h, seed=3, diag_boost=0.5))
    op, opA = (sparse.bdia_from_dense(X, block=block, device="cpu")
               for X in (M, A))
    Zu = banded.banded_selected_inverse(banded.banded_lu(op))
    tr = complex(banded.banded_trace_product(Zu, opA))
    jop, jopA = (jsparse.bdia_from_dense(X, block=block) for X in (M, A))
    jZu = np.asarray(jbanded.banded_selected_inverse(jbanded.banded_lu(jop)))
    jtr_r, jtr_i = jbanded.banded_trace_product(jZu, jopA)
    jtr = complex(float(jtr_r), float(jtr_i))
    assert _rel(Zu.numpy(), jZu[:, :, 0] + 1j * jZu[:, :, 1]) < 1e-12
    assert abs(tr - jtr) / abs(jtr) < 1e-12

    Z = np.linalg.inv(M)
    nb = n // block
    Zu = Zu.numpy()
    for i in range(nb):
        for d in range(h + 1):
            want = Z[i * block:(i + 1) * block,
                     (i + d) * block:(i + d + 1) * block] if i + d < nb \
                else np.zeros((block, block))
            assert np.abs(Zu[i, d] - want).max() <= 1e-10 * np.abs(Z).max()
    want = np.trace(np.linalg.solve(M, A))
    assert abs(tr - want) / abs(want) < 1e-10


def test_near_singular_shift():
    """Shift-invert use: M - sigma I with sigma 1e-4 from an eigenvalue.
    The solve agrees with numpy's within 1e-8 (tests/test_banded.py:50-68)
    and aligns with the near-null eigenvector.  Against emme_tpu's solve
    the bar is cond(M - sigma I) * eps (2.1e-11 here) and not 1e-12: the
    system amplifies each solver's rounding by its condition number 9.3e4,
    so two backward-stable solves part by up to that much (emme_tpu's own
    solve sits 8.8e-12 from numpy's, the port's 5.8e-12)."""
    M = _random_banded(64, 16, 1, seed=5)
    evals, evecs = np.linalg.eig(M)
    k = np.argmin(np.abs(evals - 2.0))
    Ms = M - (evals[k] + 1e-4) * np.eye(64)
    x = np.ones(64) + 0.1j
    z = banded.banded_solve(banded.banded_lu(
        sparse.bdia_from_dense(Ms, block=16, device="cpu")),
        torch.as_tensor(x)).numpy()
    zr, zi = jbanded.banded_solve(
        jbanded.banded_lu(jsparse.bdia_from_dense(Ms, block=16)),
        jnp.asarray(x.real), jnp.asarray(x.imag))
    bar = np.linalg.cond(Ms) * np.finfo(np.float64).eps
    assert _rel(z, np.asarray(zr) + 1j * np.asarray(zi)) < bar
    assert _rel(z, np.linalg.solve(Ms, x)) < 1e-8
    v = evecs[:, k]
    assert np.abs(v.conj() @ z) / np.linalg.norm(z) > 0.99


def test_rowmajor_from_bdia():
    """Band storage: W[i, h + d] is block (i, i + d); h zero rows pad the
    end."""
    M = _random_banded(64, 16, 2, seed=7)
    op = sparse.bdia_from_dense(M, block=16, device="cpu")
    W, h = banded.rowmajor_from_bdia(op)
    assert h == 2 and W.shape == (6, 5, 16, 16)
    for i in range(4):
        for d in range(-2, 3):
            blk = W[i, h + d].numpy()
            if 0 <= i + d < 4:
                np.testing.assert_array_equal(
                    blk, M[i * 16:(i + 1) * 16, (i + d) * 16:(i + d + 1) * 16])
            else:
                assert not blk.any()
    assert not W[4:].any()
