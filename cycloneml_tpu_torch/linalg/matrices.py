"""Local matrix types — the port's copy of ``cycloneml_tpu/linalg/matrices.py``.

API parity with ``ml.linalg`` matrices (ref: mllib-local/.../Matrices.scala:32
sealed Matrix, DenseMatrix :300, SparseMatrix :594), float64 numpy on the
host. The reference stores column-major to match Fortran BLAS; these store
row-major (C order) — ``to_array`` and indexing keep the reference's
semantics, and ``DenseMatrix.values`` is the column-major flat array of the
reference's field. ``SparseMatrix`` takes the reference's CSC constructor
and keeps CSR inside, as the reference's does. Products route through
``cycloneml_tpu_torch.linalg.blas``, the dispatch boundary.
"""

from __future__ import annotations

import numpy as np
from typing import Sequence, Union

from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vector


class Matrix:
    """Sealed base (ref Matrices.scala:32)."""

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    @property
    def num_cols(self) -> int:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        """(num_rows, num_cols) float64 array."""
        raise NotImplementedError

    def apply(self, i: int, j: int) -> float:
        return float(self.to_array()[i, j])

    def __getitem__(self, ij) -> float:
        return self.apply(*ij)

    def transpose(self) -> "Matrix":
        raise NotImplementedError

    @property
    def T(self) -> "Matrix":
        return self.transpose()

    def multiply(self, other: Union["Matrix", Vector]) -> Union["DenseMatrix", DenseVector]:
        from cycloneml_tpu_torch.linalg import blas
        if isinstance(other, Vector):
            return DenseVector(blas.device_gemv(self.to_array(), other.to_array()))
        return DenseMatrix.from_array(blas.device_gemm(self.to_array(), other.to_array()))

    def num_nonzeros(self) -> int:
        return int(np.count_nonzero(self.to_array()))

    def num_actives(self) -> int:
        raise NotImplementedError

    def colwise(self):
        return self.to_array().T

    def row_iter(self):
        arr = self.to_array()
        for i in range(arr.shape[0]):
            yield DenseVector(arr[i])

    def col_iter(self):
        arr = self.to_array()
        for j in range(arr.shape[1]):
            yield DenseVector(arr[:, j])

    def __eq__(self, other) -> bool:
        if not isinstance(other, Matrix):
            return NotImplemented
        return (self.num_rows, self.num_cols) == (other.num_rows, other.num_cols) and \
            np.array_equal(self.to_array(), other.to_array())

    def __hash__(self):
        return hash((self.num_rows, self.num_cols))


class DenseMatrix(Matrix):
    """Dense matrix (ref Matrices.scala:300). Row-major storage."""

    __slots__ = ("_arr",)

    def __init__(self, num_rows: int, num_cols: int,
                 values: Union[np.ndarray, Sequence[float]],
                 is_transposed: bool = False):
        # `values` follows the reference's constructor contract: column-major
        # unless is_transposed. Internally normalised to a (rows, cols) C array.
        v = np.asarray(values, dtype=np.float64).reshape(-1)
        if v.size != num_rows * num_cols:
            raise ValueError("values length mismatch")
        if is_transposed:
            self._arr = np.ascontiguousarray(v.reshape(num_rows, num_cols))
        else:
            self._arr = np.ascontiguousarray(v.reshape(num_cols, num_rows).T)

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "DenseMatrix":
        m = cls.__new__(cls)
        m._arr = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
        if m._arr.ndim != 2:
            raise ValueError("expected 2-D array")
        return m

    @property
    def num_rows(self) -> int:
        return self._arr.shape[0]

    @property
    def num_cols(self) -> int:
        return self._arr.shape[1]

    @property
    def values(self) -> np.ndarray:
        """Column-major flat values, matching the reference's field."""
        return np.asfortranarray(self._arr).ravel(order="F")

    def to_array(self) -> np.ndarray:
        return self._arr

    def num_actives(self) -> int:
        return self._arr.size

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix.from_array(self._arr.T)

    def copy(self) -> "DenseMatrix":
        return DenseMatrix.from_array(self._arr.copy())

    def to_sparse(self) -> "SparseMatrix":
        return SparseMatrix.from_array(self._arr)

    def __repr__(self) -> str:
        return f"DenseMatrix({self.num_rows}x{self.num_cols})"


class SparseMatrix(Matrix):
    """CSR sparse matrix (ref Matrices.scala:594 stores CSC; we store CSR to
    match row-major instance blocks — the public (i,j) semantics are equal)."""

    __slots__ = ("_num_rows", "_num_cols", "indptr", "indices", "values")

    def __init__(self, num_rows: int, num_cols: int,
                 colptrs: Sequence[int], row_indices: Sequence[int],
                 values: Sequence[float]):
        # reference constructor contract is CSC; convert to CSR internally
        from scipy.sparse import csc_matrix
        csc = csc_matrix(
            (np.asarray(values, dtype=np.float64),
             np.asarray(row_indices, dtype=np.int32),
             np.asarray(colptrs, dtype=np.int32)),
            shape=(num_rows, num_cols))
        csr = csc.tocsr()
        self._num_rows, self._num_cols = num_rows, num_cols
        self.indptr = csr.indptr
        self.indices = csr.indices
        self.values = csr.data

    @classmethod
    def from_array(cls, arr: np.ndarray) -> "SparseMatrix":
        from scipy.sparse import csr_matrix
        csr = csr_matrix(np.asarray(arr, dtype=np.float64))
        m = cls.__new__(cls)
        m._num_rows, m._num_cols = arr.shape
        m.indptr, m.indices, m.values = csr.indptr, csr.indices, csr.data
        return m

    @classmethod
    def from_scipy(cls, sp) -> "SparseMatrix":
        csr = sp.tocsr()
        m = cls.__new__(cls)
        m._num_rows, m._num_cols = csr.shape
        m.indptr, m.indices, m.values = csr.indptr, csr.indices, np.asarray(csr.data, dtype=np.float64)
        return m

    def to_scipy(self):
        from scipy.sparse import csr_matrix
        return csr_matrix((self.values, self.indices, self.indptr),
                          shape=(self._num_rows, self._num_cols))

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def num_cols(self) -> int:
        return self._num_cols

    def to_array(self) -> np.ndarray:
        return np.asarray(self.to_scipy().todense())

    def num_actives(self) -> int:
        return len(self.values)

    def num_nonzeros(self) -> int:
        return int(np.count_nonzero(self.values))

    def transpose(self) -> "SparseMatrix":
        return SparseMatrix.from_scipy(self.to_scipy().T)

    def to_dense(self) -> DenseMatrix:
        return DenseMatrix.from_array(self.to_array())

    def __repr__(self) -> str:
        return f"SparseMatrix({self._num_rows}x{self._num_cols}, nnz={self.num_actives()})"


class Matrices:
    """Factory methods (ref Matrices.scala object Matrices)."""

    @staticmethod
    def dense(num_rows: int, num_cols: int, values) -> DenseMatrix:
        return DenseMatrix(num_rows, num_cols, values)

    @staticmethod
    def sparse(num_rows: int, num_cols: int, colptrs, row_indices, values) -> SparseMatrix:
        return SparseMatrix(num_rows, num_cols, colptrs, row_indices, values)

    @staticmethod
    def from_array(arr: np.ndarray) -> DenseMatrix:
        return DenseMatrix.from_array(arr)

    @staticmethod
    def zeros(num_rows: int, num_cols: int) -> DenseMatrix:
        return DenseMatrix.from_array(np.zeros((num_rows, num_cols)))

    @staticmethod
    def ones(num_rows: int, num_cols: int) -> DenseMatrix:
        return DenseMatrix.from_array(np.ones((num_rows, num_cols)))

    @staticmethod
    def eye(n: int) -> DenseMatrix:
        return DenseMatrix.from_array(np.eye(n))

    @staticmethod
    def diag(vector: Vector) -> DenseMatrix:
        return DenseMatrix.from_array(np.diag(vector.to_array()))

    @staticmethod
    def horzcat(matrices) -> DenseMatrix:
        return DenseMatrix.from_array(np.hstack([m.to_array() for m in matrices]))

    @staticmethod
    def vertcat(matrices) -> DenseMatrix:
        return DenseMatrix.from_array(np.vstack([m.to_array() for m in matrices]))
