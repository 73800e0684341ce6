"""Block-sparse complex operators and their matvecs.

Counterpart of ``emme_tpu/ops/sparse.py``.  The banded kernel-integral
operator is stored as complex blocks:

* ``BDIAOperator`` -- block diagonals, (ndiag, nb, bs, bs), each diagonal
  zero-padded where it leaves the matrix.  ``bdia_matvec`` contracts every
  diagonal in one batched complex ``torch.matmul`` against rolled x
  segments (the JAX package computes this outside any Pallas kernel too).
* ``BSROperator`` -- block-sparse rows, (nnzb, bs, bs) with int32
  ``col_idx``/``row_of``/``row_ptr`` in row-major block order.
  ``bsr_matvec`` is the wrapper of the CUDA kernel K5
  (``ops/cuda_spmv.py``, ``csrc/spmv.cu``); ``bsr_matvec_ref`` is its plain
  version (a gather, a batched matmul and ``index_add_``).

Complex tensors replace the JAX package's (re, im) planes.  The on-disk
dump format stays the JAX package's, so dumps move between the packages.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..params import default_device
from . import cuda_spmv

DEFAULT_BLOCK = 128


@dataclass(frozen=True)
class BSROperator:
    """Block-sparse row operator.

    data: (nnzb, bs, bs) complex
    col_idx: (nnzb,) int32 -- column block of each stored block
    row_of: (nnzb,) int32  -- row block of each stored block (row-major)
    row_ptr: (n_row_blocks + 1,) int32
    """
    data: Any
    col_idx: Any
    row_of: Any
    row_ptr: Any
    n: int
    block: int

    @property
    def nnzb(self) -> int:
        return self.data.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block * self.block


@dataclass(frozen=True)
class BDIAOperator:
    """Block-diagonal operator: the band structure the kernel-integral
    operator has (kappa decays in |eta - eta'|; the singularity handler adds
    a width-5 band, singularity_handler.cpp:3-24).

    data: (ndiag, nb, bs, bs) complex; data[k, i] is block (i, i +
    offsets[k]), zero where that block lies outside the matrix.
    offsets: tuple of block-diagonal offsets (col_block - row_block).
    """
    data: Any
    offsets: tuple
    n: int
    block: int

    @property
    def nnzb(self) -> int:
        """Stored (non-padding) blocks."""
        nb = self.n // self.block
        return sum(nb - abs(d) for d in self.offsets)

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block * self.block


def _complex_dtype(M: np.ndarray):
    return torch.complex128 if M.dtype == np.complex128 else torch.complex64


def _row_ptr(row_of: np.ndarray, nb: int) -> np.ndarray:
    row_ptr = np.zeros(nb + 1, np.int32)
    np.add.at(row_ptr[1:], row_of, 1)
    return np.cumsum(row_ptr).astype(np.int32)


def _dense_blocks(M, block: int):
    M = np.asarray(M)
    n = M.shape[0]
    if n % block:
        raise ValueError(f"block {block} does not divide n = {n}")
    nb = n // block
    return M, n, nb, M.reshape(nb, block, nb, block).transpose(0, 2, 1, 3)


def bsr_from_dense(M, block: int = DEFAULT_BLOCK, threshold: float = 0.0,
                   device=None) -> BSROperator:
    """Host-side conversion: keep blocks whose max |entry| > threshold *
    max|M| (threshold 0 keeps every block).  The operator lands on
    ``device`` (None: the CUDA card, ``params.default_device``)."""
    device = default_device(device)
    M, n, nb, blocks = _dense_blocks(M, block)
    mags = np.abs(blocks).max(axis=(2, 3))
    keep = mags > threshold * (np.abs(M).max() + 1e-300)
    row_of, col_idx = np.nonzero(keep)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return BSROperator(
        data=t(np.ascontiguousarray(blocks[row_of, col_idx]),
               _complex_dtype(M)),
        col_idx=t(col_idx.astype(np.int32), torch.int32),
        row_of=t(row_of.astype(np.int32), torch.int32),
        row_ptr=t(_row_ptr(row_of, nb), torch.int32), n=n, block=block)


def bdia_from_dense(M, block: int = DEFAULT_BLOCK, threshold: float = 0.0,
                    device=None) -> BDIAOperator:
    """Host-side conversion: keep every block diagonal holding at least one
    block whose max |entry| > threshold * max|M|.  The operator lands on
    ``device`` (None: the CUDA card, ``params.default_device``)."""
    device = default_device(device)
    M, n, nb, blocks = _dense_blocks(M, block)
    mags = np.abs(blocks).max(axis=(2, 3))
    cut = threshold * (np.abs(M).max() + 1e-300)
    offsets = [d for d in range(-(nb - 1), nb)
               if (np.diagonal(mags, offset=d) > cut).any()]
    rows = np.arange(nb)
    data = np.zeros((len(offsets), nb, block, block), M.dtype)
    for k, d in enumerate(offsets):
        r = rows[(rows + d >= 0) & (rows + d < nb)]
        data[k, r] = blocks[r, r + d]
    return BDIAOperator(
        data=torch.as_tensor(data, dtype=_complex_dtype(M), device=device),
        offsets=tuple(int(d) for d in offsets), n=n, block=block)


def bdia_to_bsr(op: BDIAOperator) -> BSROperator:
    """BDIA -> BSR: structure from the offsets (row-major block order),
    one gather for the data.  Zero-padding blocks are not referenced."""
    nb = op.n // op.block
    blocks = [(i, i + d, k) for i in range(nb)
              for k, d in enumerate(op.offsets) if 0 <= i + d < nb]
    row_of, col_idx, diag_of = \
        np.asarray(blocks, np.int32).reshape(-1, 3).T.copy()
    dev = op.data.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    return BSROperator(data=op.data[t(diag_of).long(), t(row_of).long()],
                       col_idx=t(col_idx), row_of=t(row_of),
                       row_ptr=t(_row_ptr(row_of, nb)), n=op.n,
                       block=op.block)


def bdia_matvec(op: BDIAOperator, x):
    """Block-diagonal complex matvec y = A x for x of shape (n,) or (n, r).

    For each stored diagonal d the needed x segment is x rolled by -d
    blocks; wrapped segments meet the zero-padding blocks, so nothing is
    masked.  Every diagonal contracts in one batched matmul over
    (ndiag * nb) blocks, then the diagonals are summed."""
    bs = op.block
    nb = op.n // bs
    vec = x.dim() == 1
    x2 = (x[:, None] if vec else x).reshape(nb, bs, -1)
    gx = torch.stack([torch.roll(x2, -d, dims=0) for d in op.offsets])
    y = torch.matmul(op.data, gx).sum(dim=0).reshape(op.n, -1)
    return y[:, 0] if vec else y


def bsr_matvec_ref(op: BSROperator, x):
    """The plain version of K5: y = A x for x of shape (n,) or (n, r), by
    a gather of x segments, one batched product and ``index_add_`` into
    the block rows."""
    bs = op.block
    nb = op.n // bs
    vec = x.dim() == 1
    x2 = (x[:, None] if vec else x).reshape(nb, bs, -1)
    prod = torch.matmul(op.data, x2[op.col_idx.long()])
    y = torch.zeros((nb, bs, x2.shape[-1]), dtype=prod.dtype,
                    device=prod.device)
    y.index_add_(0, op.row_of.long(), prod)
    y = y.reshape(op.n, -1)
    return y[:, 0] if vec else y


# y = A x through K5 on a CUDA tensor (counted in ``cuda_spmv.LAUNCHES``),
# its plain version on a CPU tensor
bsr_matvec = cuda_spmv.bsr_matvec


def spmv_route(op: BDIAOperator, method: str | None = None) -> str:
    """The SpMV route ``pick_spmv`` takes for a banded operator.

    ``method``: "bdia" (the batched block-diagonal matmul), "bsr" (kernel
    K5 through ``bsr_matvec``) or None = auto.  The auto rule comes from
    H100 runs at the tok8192 operator (``PERF.md``): one complex64 matvec
    took 0.085 ms through K5 against 0.30 ms through ``bdia_matvec``, so
    auto takes "bsr" for an operator on a CUDA device.  On the CPU the
    "bsr" route is the plain ``bsr_matvec_ref``, and auto keeps the JAX
    package's "bdia"."""
    if method is None:
        method = "bsr" if op.data.is_cuda else "bdia"
    if method not in ("bdia", "bsr"):
        raise ValueError(
            f"spmv method must be 'bdia' or 'bsr', got {method!r}")
    return method


def pick_spmv(op: BDIAOperator, method: str | None = None):
    """Select the SpMV route for a banded operator (``spmv_route``);
    returns (matvec(x) -> y, name)."""
    method = spmv_route(op, method)
    if method == "bdia":
        return (lambda x: bdia_matvec(op, x)), "bdia"
    bsr = bdia_to_bsr(op)
    return (lambda x: bsr_matvec(bsr, x)), "bsr"


def save_bdia_dump(op: BDIAOperator, path):
    """Write a BDIA operator dump in the JAX package's format: float64
    planes (ndiag, nb, re/im, bs, bs) to ``path`` plus a JSON sidecar
    ``path + '.json'`` holding offsets/n/block/dtype/shape."""
    d = op.data.detach().cpu().to(torch.complex128)
    data = np.ascontiguousarray(
        np.stack([d.real.numpy(), d.imag.numpy()], axis=2))
    data.tofile(path)
    with open(str(path) + ".json", "w") as f:
        json.dump({
            "format": "bdia",
            "offsets": list(op.offsets),
            "n": int(op.n),
            "block": int(op.block),
            "dtype": "float64",
            "shape": list(data.shape),
            "layout": "(ndiag, nb, re/im, bs, bs)",
        }, f, indent=1)


def load_bdia_dump(path, device=None) -> BDIAOperator:
    """Read back a ``save_bdia_dump`` pair (either package's) as a
    complex128 operator on ``device`` (None: the CUDA card)."""
    device = default_device(device)
    with open(str(path) + ".json") as f:
        meta = json.load(f)
    if meta.get("format") != "bdia":
        raise ValueError(f"{path}.json is not a BDIA sidecar")
    data = np.fromfile(path, dtype=meta["dtype"]).reshape(meta["shape"])
    cplx = data[:, :, 0] + 1j * data[:, :, 1]
    return BDIAOperator(
        data=torch.as_tensor(cplx, dtype=torch.complex128, device=device),
        offsets=tuple(meta["offsets"]), n=meta["n"], block=meta["block"])
