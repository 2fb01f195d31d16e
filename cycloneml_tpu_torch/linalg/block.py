"""2-D distributed matrices: BlockMatrix / CoordinateMatrix / IndexedRowMatrix.

The port's counterpart of ``cycloneml_tpu/linalg/block.py`` (ref:
BlockMatrix.scala, CoordinateMatrix.scala, IndexedRowMatrix.scala). The
reference's BlockMatrix is an RDD of ((blockRow, blockCol) -> Matrix) with
a GridPartitioner, and multiply is a hand-built block-join + shuffle +
per-block gemm + reduce; the JAX package makes it one grid-sharded device
array. Here, on the port's one-device mesh, a BlockMatrix is **one padded
tensor on the mesh's device** at the accumulator width
(``cyclone.compute.dtype``), rows and columns padded with zeros to
multiples of 8 (the reference's per-device shard multiple on one device),
and ``multiply`` is one ``torch.matmul`` (TF32 off, as the mesh sets it:
the reference's ``Precision.HIGHEST``). "Blocks" (rowsPerBlock x
colsPerBlock) are the per-device shards: here the whole padded tensor.

CoordinateMatrix keeps host COO entries (the ingest form) and converts;
IndexedRowMatrix pairs an int64 row-index vector with a ``RowMatrix``
(``linalg/distributed.py``), whose Gramian, SVD and column similarities
run there (K4 or S2 on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cycloneml_tpu_torch.linalg.distributed import RowMatrix
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix

PAD = 8  # rows and columns padded to a multiple of this (one device)


def _pad_to(arr: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """``arr`` zero-padded at the end to (m, n); itself when it has that
    shape."""
    if tuple(arr.shape) == (m, n):
        return arr
    return F.pad(arr, (0, n - arr.shape[1], 0, m - arr.shape[0]))


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


class BlockMatrix:
    """Dense distributed matrix, one padded tensor (ref BlockMatrix.scala:132)."""

    def __init__(self, ctx, arr: torch.Tensor, num_rows: int, num_cols: int):
        self.ctx = ctx
        self._arr = arr  # (m_pad, n_pad) on the mesh's device
        self._num_rows = num_rows
        self._num_cols = num_cols

    # -- construction ----------------------------------------------------------
    @classmethod
    def from_numpy(cls, ctx, a: np.ndarray, dtype=None) -> "BlockMatrix":
        from cycloneml_tpu_torch.dataset.instance import compute_dtype
        rt = ctx.mesh_runtime
        dtype = dtype or compute_dtype(getattr(ctx, "conf", None))
        a = np.asarray(a)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(rt.device, dtype)
        rows_mult = rt.data_parallelism * PAD
        arr = _pad_to(t, _round_up(a.shape[0], rows_mult),
                      _round_up(a.shape[1], PAD))
        return cls(ctx, arr, a.shape[0], a.shape[1])

    @property
    def rows_per_block(self) -> int:
        """Per-device shard height — the physical block size (metadata parity
        with ref rowsPerBlock)."""
        return self._arr.shape[0] // self.ctx.mesh_runtime.data_parallelism

    @property
    def cols_per_block(self) -> int:
        return self._arr.shape[1]

    def num_rows(self) -> int:
        return self._num_rows

    def num_cols(self) -> int:
        return self._num_cols

    def validate(self) -> None:
        """(ref validate:199) — shape invariants."""
        if self._arr.shape[0] < self._num_rows or \
                self._arr.shape[1] < self._num_cols:
            raise ValueError(f"BlockMatrix: storage {tuple(self._arr.shape)} "
                             f"is smaller than {self._num_rows} x "
                             f"{self._num_cols}")

    # -- algebra ---------------------------------------------------------------
    def _ewise(self, other: "BlockMatrix", op) -> "BlockMatrix":
        if (self._num_rows, self._num_cols) != (other._num_rows, other._num_cols):
            raise ValueError("dimension mismatch")
        # physical pads can differ between construction paths (from_numpy
        # pads to multiples of 8; transpose/multiply outputs keep theirs) —
        # align to the common physical shape before the elementwise op
        m = max(self._arr.shape[0], other._arr.shape[0])
        n = max(self._arr.shape[1], other._arr.shape[1])
        out = op(_pad_to(self._arr, m, n), _pad_to(other._arr, m, n))
        return BlockMatrix(self.ctx, out, self._num_rows, self._num_cols)

    def add(self, other: "BlockMatrix") -> "BlockMatrix":
        return self._ewise(other, lambda a, b: a + b)

    def subtract(self, other: "BlockMatrix") -> "BlockMatrix":
        return self._ewise(other, lambda a, b: a - b)

    def scale(self, alpha: float) -> "BlockMatrix":
        return BlockMatrix(self.ctx, self._arr * alpha,
                           self._num_rows, self._num_cols)

    def multiply(self, other: "BlockMatrix") -> "BlockMatrix":
        """A @ B as one ``torch.matmul`` (replaces simulateMultiply +
        shuffle, ref BlockMatrix.scala:477)."""
        if self._num_cols != other._num_rows:
            raise ValueError(
                f"A.cols({self._num_cols}) != B.rows({other._num_rows})")
        k = max(self._arr.shape[1], other._arr.shape[0])
        a = _pad_to(self._arr, self._arr.shape[0], k)
        b = _pad_to(other._arr, k, other._arr.shape[1])
        return BlockMatrix(self.ctx, torch.matmul(a, b), self._num_rows,
                           other._num_cols)

    def transpose(self) -> "BlockMatrix":
        return BlockMatrix(self.ctx, self._arr.T.contiguous(),
                           self._num_cols, self._num_rows)

    # -- conversions -----------------------------------------------------------
    def to_local_matrix(self) -> DenseMatrix:
        return DenseMatrix.from_array(
            self.to_numpy().astype(np.float64, copy=False))

    def to_numpy(self) -> np.ndarray:
        return self._arr[: self._num_rows, : self._num_cols].cpu().numpy()

    def to_indexed_row_matrix(self) -> "IndexedRowMatrix":
        return IndexedRowMatrix.from_numpy(
            self.ctx, np.arange(self._num_rows, dtype=np.int64), self.to_numpy())

    def to_coordinate_matrix(self) -> "CoordinateMatrix":
        a = self.to_numpy()
        i, j = np.nonzero(a)
        return CoordinateMatrix(self.ctx, i.astype(np.int64), j.astype(np.int64),
                                a[i, j], self._num_rows, self._num_cols)


class MatrixEntry(NamedTuple):
    i: int
    j: int
    value: float


class CoordinateMatrix:
    """COO-form distributed matrix (ref CoordinateMatrix.scala:52) — the
    ingest format for very sparse data; converts to the dense sharded forms
    for compute (the products run on dense forms)."""

    def __init__(self, ctx, rows: np.ndarray, cols: np.ndarray,
                 values: np.ndarray, num_rows: Optional[int] = None,
                 num_cols: Optional[int] = None):
        self.ctx = ctx
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.values = np.asarray(values, dtype=np.float64)
        self._num_rows = int(num_rows if num_rows is not None
                             else (self.rows.max(initial=-1) + 1))
        self._num_cols = int(num_cols if num_cols is not None
                             else (self.cols.max(initial=-1) + 1))

    @classmethod
    def from_entries(cls, ctx, entries, num_rows=None, num_cols=None):
        e = [(int(i), int(j), float(v)) for i, j, v in entries]
        return cls(ctx, np.array([x[0] for x in e]), np.array([x[1] for x in e]),
                   np.array([x[2] for x in e]), num_rows, num_cols)

    def entries(self):
        return [MatrixEntry(int(i), int(j), float(v))
                for i, j, v in zip(self.rows, self.cols, self.values)]

    def num_rows(self) -> int:
        return self._num_rows

    def num_cols(self) -> int:
        return self._num_cols

    def transpose(self) -> "CoordinateMatrix":
        return CoordinateMatrix(self.ctx, self.cols, self.rows, self.values,
                                self._num_cols, self._num_rows)

    def to_numpy(self) -> np.ndarray:
        a = np.zeros((self._num_rows, self._num_cols))
        np.add.at(a, (self.rows, self.cols), self.values)
        return a

    def to_block_matrix(self) -> BlockMatrix:
        return BlockMatrix.from_numpy(self.ctx, self.to_numpy())

    def to_indexed_row_matrix(self) -> "IndexedRowMatrix":
        return IndexedRowMatrix.from_numpy(
            self.ctx, np.arange(self._num_rows, dtype=np.int64), self.to_numpy())

    def to_row_matrix(self) -> RowMatrix:
        return RowMatrix.from_numpy(self.ctx, self.to_numpy())


class IndexedRowMatrix:
    """Row-indexed distributed matrix (ref IndexedRowMatrix.scala:45):
    a RowMatrix whose rows carry meaningful int64 indices."""

    def __init__(self, ctx, indices: np.ndarray, row_matrix: RowMatrix,
                 num_rows: Optional[int] = None):
        self.ctx = ctx
        self.indices = np.asarray(indices, dtype=np.int64)
        self.row_matrix = row_matrix
        self._num_rows = int(num_rows if num_rows is not None
                             else (self.indices.max(initial=-1) + 1))

    @classmethod
    def from_numpy(cls, ctx, indices: np.ndarray, x: np.ndarray,
                   num_rows: Optional[int] = None) -> "IndexedRowMatrix":
        return cls(ctx, indices, RowMatrix.from_numpy(ctx, x), num_rows)

    def num_rows(self) -> int:
        return self._num_rows

    def num_cols(self) -> int:
        return self.row_matrix.num_cols()

    def compute_gramian_matrix(self) -> DenseMatrix:
        return self.row_matrix.compute_gramian()

    def compute_svd(self, k: int, compute_u: bool = False, **kw):
        return self.row_matrix.compute_svd(k, compute_u=compute_u, **kw)

    def multiply(self, b) -> "IndexedRowMatrix":
        return IndexedRowMatrix(self.ctx, self.indices,
                                self.row_matrix.multiply(b), self._num_rows)

    def column_similarities(self) -> DenseMatrix:
        return self.row_matrix.column_similarities()

    def to_row_matrix(self) -> RowMatrix:
        return self.row_matrix

    def to_numpy(self) -> np.ndarray:
        """Dense (num_rows, num_cols) with rows placed at their indices."""
        stored = self.row_matrix.to_numpy()
        out = np.zeros((self._num_rows, stored.shape[1]), dtype=stored.dtype)
        out[self.indices] = stored
        return out

    def to_block_matrix(self) -> BlockMatrix:
        return BlockMatrix.from_numpy(self.ctx, self.to_numpy())

    def to_coordinate_matrix(self) -> CoordinateMatrix:
        a = self.to_numpy()
        i, j = np.nonzero(a)
        return CoordinateMatrix(self.ctx, i, j, a[i, j],
                                self._num_rows, a.shape[1])
