"""BLAS dispatch boundary — the offload plugin point of the port.

The port's copy of ``cycloneml_tpu/linalg/blas.py``, which mirrors the
reference's ``ml.linalg.BLAS`` (ref: mllib-local/src/main/scala/org/apache/
spark/ml/linalg/BLAS.scala:27-55): the level-1-3 routines with the
reference API's in-place semantics on the numpy-backed local types (axpy,
gemv and gemm write into ``y``/``C``), and the products behind one
size-based dispatch. ``device_gemm`` and ``device_gemv`` run a product of
at least :data:`DEVICE_FLOPS_THRESHOLD` operations (``CYCLONE_BLAS_DEVICE_
THRESHOLD``) as one ``torch.matmul`` on the active mesh's device
(``mesh.get_or_create``, the card by default) at the accumulator width
(``cyclone.compute.dtype``), operands copied over and the result copied
back as float64; smaller ones stay numpy on the host. Each call counts its
route in ``device_gemm.routes``/``device_gemv.routes``.

The reference's accelerator path falls back to numpy in silence when jax
fails to import (``_maybe_jax``, ref BLAS.scala:45). The port has no such
fallback: on ``cyclone.master=cuda`` with no card a device product raises;
only ``cyclone.master=cpu`` runs it on the CPU.

Routines covered (ref file:line): axpy:61, dot:122, copy, scal:237, spr, syr,
gemm, gemv, pack_upper/unpack_upper — plus the raw entry points
(``device_*``) used where arrays are host-resident.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cycloneml_tpu_torch.linalg.vectors import DenseVector, SparseVector, Vector
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix, Matrix, SparseMatrix

# Size-based dispatch mirrors getBLAS(256) (ref BLAS.scala:50), but the
# crossover for a host<->device hop is operations, not elements: offload
# only when the card's rate amortises the copies. Overridable for testing.
DEVICE_FLOPS_THRESHOLD = int(os.environ.get("CYCLONE_BLAS_DEVICE_THRESHOLD", 1 << 22))

DEVICE, HOST = "device", "host"


def _device_product(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` as one ``torch.matmul`` on the active mesh's device at the
    accumulator width, returned as float64 on the host. A CUDA master with
    no card raises (``mesh.resolve_device``)."""
    from cycloneml_tpu_torch import mesh
    from cycloneml_tpu_torch.conf import MASTER
    from cycloneml_tpu_torch.dataset.instance import compute_dtype
    rt = mesh.active() or mesh.get_or_create(MASTER.default)
    dt = compute_dtype()
    ta = torch.from_numpy(np.ascontiguousarray(a)).to(rt.device, dt)
    tb = torch.from_numpy(np.ascontiguousarray(b)).to(rt.device, dt)
    return torch.matmul(ta, tb).cpu().numpy().astype(np.float64)


def device_gemm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` for host-resident operands: on the device past the
    threshold (counted in ``device_gemm.routes``), else numpy."""
    flops = a.shape[0] * a.shape[1] * (b.shape[1] if b.ndim > 1 else 1)
    if flops >= DEVICE_FLOPS_THRESHOLD:
        out = _device_product(a, b)
        device_gemm.routes[DEVICE] += 1
        return out
    device_gemm.routes[HOST] += 1
    return a @ b


def device_gemv(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``a @ x`` for host-resident operands, routed as :func:`device_gemm`
    by ``a``'s size (counted in ``device_gemv.routes``)."""
    if a.size >= DEVICE_FLOPS_THRESHOLD:
        out = _device_product(a, x)
        device_gemv.routes[DEVICE] += 1
        return out
    device_gemv.routes[HOST] += 1
    return a @ x


def reset_route_counts() -> None:
    """Set the device and host routing counts to 0."""
    device_gemm.routes = {DEVICE: 0, HOST: 0}
    device_gemv.routes = {DEVICE: 0, HOST: 0}


reset_route_counts()


# ---------------------------------------------------------------------------
# Level 1
# ---------------------------------------------------------------------------

def axpy(a: float, x: Vector, y: DenseVector) -> None:
    """y += a * x (ref BLAS.scala:61). Mutates ``y`` in place."""
    if x.size != y.size:
        raise ValueError(f"size mismatch: {x.size} vs {y.size}")
    if isinstance(x, SparseVector):
        y.values[x.indices] += a * x.values
    else:
        y.values += a * np.asarray(x.to_array())


def dot(x: Vector, y: Vector) -> float:
    """x . y (ref BLAS.scala:122), with sparse/dense specialisations."""
    if x.size != y.size:
        raise ValueError(f"size mismatch: {x.size} vs {y.size}")
    if isinstance(x, SparseVector) and isinstance(y, DenseVector):
        return float(np.dot(x.values, y.values[x.indices]))
    if isinstance(x, DenseVector) and isinstance(y, SparseVector):
        return dot(y, x)
    if isinstance(x, SparseVector) and isinstance(y, SparseVector):
        common, ix, iy = np.intersect1d(x.indices, y.indices, return_indices=True)
        return float(np.dot(x.values[ix], y.values[iy]))
    xv, yv = x.to_array(), y.to_array()
    return float(np.dot(xv, yv))


def copy(x: Vector, y: DenseVector) -> None:
    """y := x (ref BLAS.scala copy)."""
    if x.size != y.size:
        raise ValueError("size mismatch")
    np.copyto(y.values, x.to_array())


def scal(a: float, x: Vector) -> None:
    """x *= a in place (ref BLAS.scala:237)."""
    x.values *= a  # both Dense and Sparse carry .values


# ---------------------------------------------------------------------------
# Level 2
# ---------------------------------------------------------------------------

def gemv(alpha: float, a: Matrix, x: Vector, beta: float, y: DenseVector) -> None:
    """y := alpha * A @ x + beta * y (ref BLAS.scala gemv). Mutates y."""
    if a.num_cols != x.size or a.num_rows != y.size:
        raise ValueError("dimension mismatch")
    if isinstance(a, SparseMatrix):
        out = alpha * (a.to_scipy() @ x.to_array())
    else:
        arr = a.to_array()
        if isinstance(x, SparseVector):
            out = alpha * (arr[:, x.indices] @ x.values)
        else:
            out = alpha * device_gemv(arr, x.to_array())
    y.values *= beta
    y.values += out


def spr(alpha: float, v: Vector, u: np.ndarray) -> None:
    """Packed symmetric rank-1 update: U += alpha * v vᵀ (upper triangle,
    column-major packed — ref BLAS.scala spr, used by RowMatrix Gramian
    ref RowMatrix.scala:147). ``u`` is the packed length n(n+1)/2 array."""
    n = v.size
    if u.shape[0] != n * (n + 1) // 2:
        raise ValueError("packed array size mismatch")
    if isinstance(v, SparseVector):
        idx, vals = v.indices, v.values
        # column-major upper-triangular packed: col j starts at j(j+1)/2
        for jj in range(len(idx)):
            j = int(idx[jj])
            col_start = j * (j + 1) // 2
            av = alpha * vals[jj]
            sel = idx[: jj + 1]
            u[col_start + sel] += av * vals[: jj + 1]
    else:
        vv = v.to_array()
        outer = np.outer(vv, vv)
        # upper col-major packed order [(i,j) for j in 0..n-1 for i in 0..j]
        # equals row-major tril enumeration of the transpose
        u += alpha * outer.T[np.tril_indices(n)]


def unpack_upper(u: np.ndarray, n: int) -> np.ndarray:
    """Expand a column-major upper-packed array into a full symmetric matrix."""
    a = np.zeros((n, n))
    k = 0
    for j in range(n):
        a[: j + 1, j] = u[k: k + j + 1]
        k += j + 1
    return a + np.triu(a, 1).T


def pack_upper(a: np.ndarray) -> np.ndarray:
    """Pack a symmetric matrix into column-major upper-packed storage."""
    n = a.shape[0]
    out = np.empty(n * (n + 1) // 2)
    k = 0
    for j in range(n):
        out[k: k + j + 1] = a[: j + 1, j]
        k += j + 1
    return out


def syr(alpha: float, x: Vector, a: DenseMatrix) -> None:
    """A += alpha * x xᵀ (ref BLAS.scala syr). Mutates A."""
    n = x.size
    if a.num_rows != n or a.num_cols != n:
        raise ValueError("dimension mismatch")
    if isinstance(x, SparseVector):
        arr = a.to_array()
        ix = x.indices
        arr[np.ix_(ix, ix)] += alpha * np.outer(x.values, x.values)
    else:
        a.to_array()[...] += alpha * np.outer(x.to_array(), x.to_array())


# ---------------------------------------------------------------------------
# Level 3
# ---------------------------------------------------------------------------

def gemm(alpha: float, a: Matrix, b: Matrix, beta: float, c: DenseMatrix) -> None:
    """C := alpha * A @ B + beta * C (ref BLAS.scala gemm). Mutates C."""
    if a.num_cols != b.num_rows or a.num_rows != c.num_rows or b.num_cols != c.num_cols:
        raise ValueError("dimension mismatch")
    if isinstance(a, SparseMatrix):
        prod = np.asarray((a.to_scipy() @ b.to_array()))
    elif isinstance(b, SparseMatrix):
        prod = np.asarray((b.to_scipy().T @ a.to_array().T)).T
    else:
        prod = device_gemm(a.to_array(), b.to_array())
    carr = c.to_array()
    carr *= beta
    carr += alpha * prod
