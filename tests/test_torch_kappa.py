"""Kernel K1 (emme_tpu_torch.ops.cuda_kappa): its plain PyTorch version vs the
Pallas kernel (interpret mode) and the JAX float32 integrand on the CPU.  The
CUDA kernel itself is held to the plain version in test_torch_cuda.py."""
import pathlib
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import emme_tpu
import emme_tpu.grid
from emme_tpu.ops import kernels as jkernels
from emme_tpu.ops import pallas_kappa, quadrature as jquadrature
import emme_tpu_torch as et
from emme_tpu_torch import _build
from emme_tpu_torch.ops import cuda_kappa

torch.set_num_threads(2)

CSRC = pathlib.Path(cuda_kappa.__file__).resolve().parent.parent / "csrc"


def _pairs(cfg, n, dtype=jnp.float32):
    cfg = dict(cfg, npoints=n)
    pj = emme_tpu.from_config(cfg, dtype=dtype)
    pt = et.from_config(cfg, dtype=torch.float32)
    iu, ju = np.triu_indices(n, k=1)
    eta = np.asarray(emme_tpu.grid.Grid.create(pj.length, n, dtype=dtype).eta)
    return pj, pt, eta[iu], eta[ju]


@pytest.fixture(scope="module")
def tok32(tokamak_cfg):
    return _pairs(tokamak_cfg, 32)


@pytest.fixture(scope="module")
def stel24(stellarator_cfg):
    return _pairs(stellarator_cfg, 24)


def test_plain_matches_pallas_interpret_tok32(tok32):
    """All 496 tok32 pairs, ms=(0,): within 5e-7 absolute of the Pallas
    kernel, the bar tests/test_pallas_kappa.py:35 puts on that kernel."""
    pj, pt, ea, eb = tok32
    om = -0.574227 + 0.274304j
    ref, = pallas_kappa.kappa_pairs_fused(
        pj, jnp.asarray(ea), jnp.asarray(eb), jnp.complex64(om), ms=(0,),
        interpret=True)
    mine, = cuda_kappa.kappa_pairs_ref(pt, torch.tensor(ea), torch.tensor(eb),
                                       om, ms=(0,))
    assert mine.dtype == torch.complex64 and mine.shape == (496,)
    assert np.abs(mine.numpy() - np.asarray(ref)).max() < 5e-7


def test_plain_em_moments_match_jax_f32_stel24(stel24):
    """ms=(0,1,2) on the stellarator at n=24 vs the JAX XLA float32
    integrand: within 5e-6 max(scale, 1) (tests/test_pallas_kappa.py:53)."""
    pj, pt, ea, eb = stel24
    om = -1.656 + 2.49j
    vals, _ = jax.jit(lambda a, b: jkernels.kappa_f_tau(
        pj, a, b, jnp.complex64(om), ms=(0, 1, 2)))(jnp.asarray(ea),
                                                   jnp.asarray(eb))
    mine = cuda_kappa.kappa_pairs_ref(pt, torch.tensor(ea), torch.tensor(eb),
                                      om, ms=(0, 1, 2))
    for m in range(3):
        ref = np.asarray(vals[m])
        scale = np.abs(ref).max()
        assert np.abs(mine[m].numpy() - ref).max() < 5e-6 * max(scale, 1.0)


def test_cpu_tensor_takes_plain_version(tok32):
    """On CPU tensors the wrapper runs the plain version (identical values,
    chunked or not) and launches nothing."""
    _, pt, ea, eb = tok32
    before = cuda_kappa.LAUNCHES
    om = -0.8 + 0.25j
    fused = cuda_kappa.kappa_pairs_fused(pt, torch.tensor(ea), torch.tensor(eb),
                                         om, ms=(0, 2))
    ref = cuda_kappa.kappa_pairs_ref(pt, torch.tensor(ea), torch.tensor(eb),
                                     om, ms=(0, 2), chunk=100)
    assert cuda_kappa.LAUNCHES == before
    for a, b in zip(fused, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        cuda_kappa.kappa_pairs_fused(pt, torch.tensor(ea), torch.tensor(eb),
                                     om, ms=(2, 0))


def test_kernel_tables_match_pallas_constants():
    """The constants handed to the kernel are the Pallas kernel's float32
    constants (pallas_kappa.py:101-124, 174-212)."""
    for order in (15, 31):
        tab = cuda_kappa._table_views(cuda_kappa.kernel_tables(order))
        x, wk, _ = jquadrature.gk_rule(order)
        assert np.array_equal(tab["x"][:order], x.astype(np.float32))
        assert np.array_equal(tab["wk"][:order], wk.astype(np.float32))
    for k in range(1, pallas_kappa._TAYLOR_TERMS + 1):
        assert tab["c0"][k - 1] == np.float32(1.0 / (k * k))
        assert tab["c1"][k - 1] == np.float32(1.0 / (k * (k + 1)))
    a0, a1 = np.ones(10), np.ones(10)
    for k in range(1, 10):
        odd2 = (2 * k - 1) ** 2
        a0[k] = a0[k - 1] * (0.0 - odd2) / (k * 8.0)
        a1[k] = a1[k - 1] * (4.0 - odd2) / (k * 8.0)
    for k in range(10):
        sg = -1.0 if k % 2 else 1.0
        assert tab["a0m"][k] == np.float32(sg * a0[k])
        assert tab["a0p"][k] == np.float32(a0[k])
        assert tab["a1m"][k] == np.float32(sg * a1[k])
        assert tab["a1p"][k] == np.float32(a1[k])


def test_kernel_source_layout_matches_wrapper():
    """The CUDA source cannot be compiled here: hold its table layout and
    term counts to the wrapper's, which the plain version uses."""
    src = (CSRC / "kappa.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxOrder") == cuda_kappa.MAX_ORDER
    assert const("kTaylorTerms") == cuda_kappa._TAYLOR_TERMS
    assert const("kAsymTerms") == cuda_kappa._ASYM_TERMS
    assert cuda_kappa._TAYLOR_TERMS == pallas_kappa._TAYLOR_TERMS
    assert cuda_kappa._ASYM_TERMS == pallas_kappa._ASYM_TERMS
    assert "kSplit2 = 144.0f" in src and "kSafeExpCutoff = -40.0f" in src
    assert not any("fast_math" in f for f in _build.NVCC_FLAGS)
