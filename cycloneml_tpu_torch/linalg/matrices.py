"""Local dense matrices — the port's copy of the ``DenseMatrix`` part of
``cycloneml_tpu/linalg/matrices.py`` (ref Matrices.scala:300), as far as
KMeans, RowMatrix and PCA use it: a float64 numpy-backed matrix stored
row-major, built with ``from_array`` (or ``Matrices.from_array``) and read
with ``to_array``. The rest of the reference's module (sparse matrices,
the other factories) waits with ``linalg/blas.py`` and ``block.py``."""

from __future__ import annotations

import numpy as np


class Matrix:
    """Base of the local matrix types (ref Matrices.scala:32)."""

    @property
    def num_rows(self) -> int:
        raise NotImplementedError

    @property
    def num_cols(self) -> int:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        """(num_rows, num_cols) float64 array."""
        raise NotImplementedError

    def transpose(self) -> "Matrix":
        raise NotImplementedError


class DenseMatrix(Matrix):
    """Dense float64 matrix, row-major."""

    __slots__ = ("_arr",)

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

    def to_array(self) -> np.ndarray:
        return self._arr

    def transpose(self) -> "DenseMatrix":
        return DenseMatrix.from_array(self._arr.T)

    def __repr__(self) -> str:
        return f"DenseMatrix({self.num_rows}x{self.num_cols})"


class Matrices:
    """Factory methods (ref Matrices.scala object Matrices), as far as
    ``RowMatrix.multiply`` and its callers use them."""

    @staticmethod
    def from_array(arr: np.ndarray) -> DenseMatrix:
        return DenseMatrix.from_array(arr)
