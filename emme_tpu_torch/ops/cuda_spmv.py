"""Complex BSR SpMV / SpMM y = A x: CUDA kernel K5 and its wrapper.

Counterpart of ``emme_tpu/ops/sparse.py::bsr_matvec_pallas`` (the Pallas TPU
kernel ``_spmv_kernel``).  The kernels (``csrc/spmv.cu``) give each CTA a
tile of rows inside one block row, walk that row's stored blocks from
``row_ptr`` and write their y rows once: no atomics, a deterministic
result.  Which shape takes which kernel:

* one right-hand side: ``bsr_spmv_vec_kernel`` (16 rows a CTA for
  complex64, 32 for complex128; element-sized loads for an odd block or an
  unaligned pointer);
* several right-hand sides, complex64, an even block size up to 176 and
  16-byte aligned blocks: ``bsr_spmm_ring_kernel``, one pass over the
  blocks per 16 right-hand sides through a shared-memory ring of bulk
  copies (64 rows a CTA, 2 stages, 8 warps); x is first
  repacked to (ceil(r / 16), n, 18) by ``bsr_pack_x_kernel`` into scratch
  that the wrapper allocates;
* several right-hand sides otherwise (complex128, an odd block size, a
  block above 176, an unaligned operator): ``bsr_spmv_tile_kernel``, 8
  right-hand sides a pass.

``bsr_matvec`` launches the kernel for CUDA tensors and counts each call
in ``LAUNCHES`` (a call that takes the ring kernel is two launches, the
repack and the kernel, counted as one); for CPU tensors it runs the plain
version ``ops.sparse.bsr_matvec_ref``.  A failed build or launch raises:
nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# calls of bsr_matvec that launched K5 (one per call on a CUDA tensor; the
# ring kernel's call is two launches, bsr_pack_x_kernel and the kernel)
LAUNCHES = 0

_DTYPE_CODE = {torch.complex64: 0, torch.complex128: 1}


def _library():
    lib = _build.load("spmv")[0]
    fn = lib.bsr_spmv_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
        lib.bsr_spmv_max_block.argtypes = []
        lib.bsr_spmv_max_block.restype = ci
        lib.bsr_spmm_scratch_elems.argtypes = [ci, vp, ci, ci, ci]
        lib.bsr_spmm_scratch_elems.restype = ctypes.c_longlong
    return lib


def _check(op, x2):
    """Raise unless the operator and the (n, r) right-hand sides are what
    the kernel takes."""
    dev = op.data.device
    bs, n = op.block, op.n
    nb = n // bs
    if op.data.dtype not in _DTYPE_CODE:
        raise ValueError(f"bsr kernel: data must be complex64 or complex128, "
                         f"got {op.data.dtype}")
    if n % bs:
        raise ValueError(f"bsr kernel: block {bs} does not divide n = {n}")
    checks = (("data", op.data, op.data.dtype, (op.nnzb, bs, bs)),
              ("col_idx", op.col_idx, torch.int32, (op.nnzb,)),
              ("row_ptr", op.row_ptr, torch.int32, (nb + 1,)),
              ("x", x2, op.data.dtype, (n, x2.shape[1])))
    for name, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"bsr kernel: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape} on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")


def _launch(op, x2):
    """Run K5 on the card: (n, r) complex, same dtype as the operator."""
    global LAUNCHES
    _check(op, x2)
    lib = _library()
    if op.block > lib.bsr_spmv_max_block():
        raise ValueError(f"bsr kernel: block {op.block} above "
                         f"{lib.bsr_spmv_max_block()}")
    y = torch.empty_like(x2)
    # the ring kernel's repacked x, where it takes this shape
    elems = lib.bsr_spmm_scratch_elems(
        _DTYPE_CODE[op.data.dtype], op.data.data_ptr(), op.n // op.block,
        op.block, x2.shape[1])
    xp = torch.empty(elems, dtype=x2.dtype, device=x2.device) if elems \
        else None
    dev = op.data.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bsr_spmv_launch(
            _DTYPE_CODE[op.data.dtype], op.data.data_ptr(),
            op.col_idx.data_ptr(), op.row_ptr.data_ptr(), x2.data_ptr(),
            None if xp is None else xp.data_ptr(), y.data_ptr(),
            op.n // op.block, op.block, x2.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"bsr kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def bsr_matvec(op, x):
    """y = A x for a ``BSROperator`` and x of shape (n,) or (n, r).

    On CUDA tensors this launches K5 (and counts it in ``LAUNCHES``); x
    must be contiguous and of the operator's complex dtype.  On CPU tensors
    it runs the plain version ``sparse.bsr_matvec_ref``."""
    vec = x.dim() == 1
    x2 = x[:, None] if vec else x
    if x.device.type == "cuda":
        y = _launch(op, x2)
    elif x.device.type == "cpu":
        from .sparse import bsr_matvec_ref
        y = bsr_matvec_ref(op, x2)
    else:
        raise ValueError(f"bsr_matvec: no kernel for device {x.device}")
    return y[:, 0] if vec else y
