"""emme_tpu_torch.ops.sparse (BDIA / BSR storage, the matvecs, K5's plain
version through its wrapper) and the banded singularity coefficients vs
emme_tpu on the CPU.  Inputs are made with numpy from a seed and given to
both packages."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from emme_tpu.ops import sparse as jsparse
from emme_tpu.ops.singularity import singularity_coeff_band as jcoeff_band
from emme_tpu_torch import convert
from emme_tpu_torch.ops import cuda_spmv, sparse
from emme_tpu_torch.ops.singularity import (singularity_coeff_band,
                                            singularity_coeff_matrix)

torch.set_num_threads(2)


def _banded_dense(n, block, h, seed=0, drop=()):
    """Random complex matrix whose blocks lie within block offset h, with
    the block diagonals in ``drop`` zeroed."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    nb = n // block
    off = np.subtract.outer(np.arange(nb), np.arange(nb))   # row - col
    keep = (np.abs(off) <= h) & ~np.isin(-off, list(drop))
    return np.where(np.kron(keep, np.ones((block, block), bool)), M, 0.0)


def _planes(t):
    return np.stack([t.real.numpy(), t.imag.numpy()], axis=-3)


def test_coeff_band_matches_jax_and_dense():
    """n=64, h=9: equal to emme_tpu's band, and to the port's dense matrix
    inside the band, exactly."""
    n, h = 64, 9
    cb = singularity_coeff_band(n, h, device="cpu")
    assert cb.shape == (n, 2 * h + 1) and cb.dtype == torch.float64
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcoeff_band(n, h)))
    cm = singularity_coeff_matrix(n, device="cpu").numpy()
    for i in range(n):
        for dj in range(-h, h + 1):
            if 0 <= i + dj < n:
                assert cb[i, dj + h] == cm[i, i + dj]
    cb32 = singularity_coeff_band(n, h, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(
        cb32.numpy(), np.asarray(jcoeff_band(n, h, dtype=jnp.float32)))


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_structures_match_jax(threshold):
    """bdia_from_dense, bsr_from_dense and bdia_to_bsr: the same offsets,
    row_ptr, col_idx, row_of and block data as emme_tpu, exactly."""
    M = _banded_dense(64, 8, 3, seed=1, drop=(2,))
    M[:8, 8:16] *= 1e-3     # one small block for the threshold to drop
    op = sparse.bdia_from_dense(M, block=8, threshold=threshold,
                                device="cpu")
    jop = jsparse.bdia_from_dense(M, block=8, threshold=threshold)
    assert op.offsets == jop.offsets and 2 not in op.offsets
    assert op.data.dtype == torch.complex128
    np.testing.assert_array_equal(_planes(op.data), np.asarray(jop.data))
    assert op.nnzb == jop.nnzb and op.nnz == jop.nnz

    for got, want in ((sparse.bdia_to_bsr(op), jsparse.bdia_to_bsr(jop)),
                      (sparse.bsr_from_dense(M, 8, threshold, device="cpu"),
                       jsparse.bsr_from_dense(M, 8, threshold))):
        for name in ("row_ptr", "col_idx", "row_of"):
            t = getattr(got, name)
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(_planes(got.data), np.asarray(want.data))
        assert (got.n, got.block, got.nnzb) == (want.n, want.block, want.nnzb)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("r", [1, 3, 16])
def test_bsr_matvec_matches_pallas_and_bdia(bs, r):
    """bsr_matvec on CPU tensors (the plain version of K5; no launch) vs
    emme_tpu's Pallas kernel in interpret mode and vs bdia_matvec, float64:
    within 1e-12 of the scale."""
    n = 64
    M = _banded_dense(n, bs, 2, seed=bs + r)
    op = sparse.bdia_from_dense(M, block=bs, device="cpu")
    bsr = sparse.bdia_to_bsr(op)
    rng = np.random.default_rng(7)
    shape = (n,) if r == 1 else (n, r)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    before = cuda_spmv.LAUNCHES
    y = sparse.bsr_matvec(bsr, torch.as_tensor(x))
    assert cuda_spmv.LAUNCHES == before and y.shape == shape
    y = y.numpy()
    yr, yi = jsparse.bsr_matvec_pallas(jsparse.bdia_to_bsr(
        jsparse.bdia_from_dense(M, block=bs)), jnp.asarray(x.real),
        jnp.asarray(x.imag), interpret=True)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    scale = np.abs(want).max()
    assert np.abs(y - want).max() <= 1e-12 * scale
    y_bdia = sparse.bdia_matvec(op, torch.as_tensor(x)).numpy()
    assert np.abs(y_bdia - want).max() <= 1e-12 * scale
    assert np.abs(y - M @ x).max() <= 1e-12 * scale


def test_bdia_matvec_matches_jax():
    """bdia_matvec vs emme_tpu's bdia_matvec with dropped diagonals and a
    multivector: within 1e-12 of the scale."""
    M = _banded_dense(96, 16, 3, seed=4, drop=(-1, 2))
    op = sparse.bdia_from_dense(M, block=16, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(96, 4)) + 1j * rng.normal(size=(96, 4))
    yr, yi = jsparse.bdia_matvec(jsparse.bdia_from_dense(M, block=16),
                                 jnp.asarray(x.real), jnp.asarray(x.imag))
    want = np.asarray(yr) + 1j * np.asarray(yi)
    y = sparse.bdia_matvec(op, torch.as_tensor(x)).numpy()
    assert np.abs(y - want).max() <= 1e-12 * np.abs(want).max()


def test_bsr_ref_complex64():
    """The plain version in complex64 agrees with the complex128 product
    at float32 rounding."""
    M = _banded_dense(64, 16, 1, seed=9)
    bsr = sparse.bsr_from_dense(M.astype(np.complex64), block=16,
                                device="cpu")
    assert bsr.data.dtype == torch.complex64
    x = np.random.default_rng(3).normal(size=64).astype(np.complex64)
    y = sparse.bsr_matvec_ref(bsr, torch.as_tensor(x)).numpy()
    want = M.astype(np.complex64).astype(np.complex128) @ x
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


def test_pick_spmv_routes():
    """pick_spmv: both routes give the same product; auto is BDIA on the
    CPU; a wrong name raises."""
    M = _banded_dense(64, 16, 1, seed=2)
    op = sparse.bdia_from_dense(M, block=16, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).normal(size=64) + 0j)
    mv_a, route_a = sparse.pick_spmv(op)
    mv_b, route_b = sparse.pick_spmv(op, "bsr")
    assert (route_a, route_b) == ("bdia", "bsr")
    assert torch.allclose(mv_a(x), mv_b(x), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        sparse.pick_spmv(op, "csr")


def test_bsr_wrapper_rejects_other_devices():
    M = _banded_dense(32, 8, 1, seed=3)
    bsr = sparse.bsr_from_dense(M, block=8, device="cpu")
    with pytest.raises(ValueError):
        cuda_spmv.bsr_matvec(bsr, torch.zeros(32, dtype=torch.complex128,
                                              device="meta"))


def test_dumps_move_between_packages(tmp_path):
    """A dump written by either package reads back in the other."""
    M = _banded_dense(48, 16, 1, seed=6)
    op = sparse.bdia_from_dense(M, block=16, device="cpu")
    sparse.save_bdia_dump(op, tmp_path / "port.bin")
    jop = jsparse.load_bdia_dump(tmp_path / "port.bin")
    assert jop.offsets == op.offsets and (jop.n, jop.block) == (48, 16)
    np.testing.assert_array_equal(np.asarray(jop.data), _planes(op.data))
    jsparse.save_bdia_dump(jsparse.bdia_from_dense(M, block=16),
                           tmp_path / "jax.bin")
    back = sparse.load_bdia_dump(tmp_path / "jax.bin", device="cpu")
    assert back.offsets == op.offsets
    assert torch.equal(back.data, op.data)


def test_convert_bdia_from_arrays():
    """convert.bdia_from_arrays of a JAX operator: the same blocks,
    exactly, in the planes' precision."""
    M = _banded_dense(64, 16, 2, seed=8)
    jop = jsparse.bdia_from_dense(M, block=16)
    op = convert.bdia_from_arrays(np.asarray(jop.data), jop.offsets, jop.n,
                                  jop.block, device="cpu")
    assert op.offsets == jop.offsets and op.data.dtype == torch.complex128
    np.testing.assert_array_equal(_planes(op.data), np.asarray(jop.data))
    jop32 = jsparse.bdia_from_dense(M.astype(np.complex64), block=16)
    op32 = convert.bdia_from_arrays(np.asarray(jop32.data), jop32.offsets,
                                    jop32.n, jop32.block, device="cpu")
    assert op32.data.dtype == torch.complex64
    np.testing.assert_array_equal(_planes(op32.data), np.asarray(jop32.data))
