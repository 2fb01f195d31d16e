"""Local vector types — the port's copy of ``cycloneml_tpu/linalg/vectors.py``.

The sealed ``Vector`` family of the reference's ``ml.linalg``
(ref: mllib-local/src/main/scala/org/apache/spark/ml/linalg/Vectors.scala:37,
DenseVector :499, SparseVector :603), backed by float64 numpy on the host.
``DenseVector`` is every fitted model's ``coefficients``; it also hands its
values to numpy (``__array__``). Products route through
``cycloneml_tpu_torch.linalg.blas``, the dispatch boundary.
"""

from __future__ import annotations

import numpy as np
from typing import Sequence, Union


class Vector:
    """Sealed base (ref Vectors.scala:37)."""

    @property
    def size(self) -> int:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError

    def to_dense(self) -> "DenseVector":
        return DenseVector(self.to_array())

    def to_sparse(self) -> "SparseVector":
        arr = self.to_array()
        idx = np.nonzero(arr)[0]
        return SparseVector(len(arr), idx, arr[idx])

    def compressed(self) -> "Vector":
        """Pick the smaller representation (ref Vectors.scala compressed)."""
        nnz = self.num_nonzeros()
        # dense storage: 8n bytes; sparse: 12nnz + overhead
        if 1.5 * (nnz + 1.0) < self.size:
            return self.to_sparse()
        return self.to_dense()

    def num_nonzeros(self) -> int:
        return int(np.count_nonzero(self.to_array()))

    def num_actives(self) -> int:
        raise NotImplementedError

    def dot(self, other: "Vector") -> float:
        from cycloneml_tpu_torch.linalg import blas
        return blas.dot(self, other)

    def norm(self, p: float = 2.0) -> float:
        return Vectors.norm(self, p)

    def sq_dist(self, other: "Vector") -> float:
        return Vectors.sqdist(self, other)

    def argmax(self) -> int:
        raise NotImplementedError

    def apply(self, i: int) -> float:
        return float(self.to_array()[i])

    def __getitem__(self, i: int) -> float:
        return self.apply(i)

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        if not isinstance(other, Vector):
            return NotImplemented
        return self.size == other.size and np.array_equal(self.to_array(), other.to_array())

    def __hash__(self) -> int:
        # mirror reference semantics: dense/sparse with same values hash equal
        arr = self.to_array()
        nz = np.nonzero(arr)[0][:16]
        return hash((self.size, tuple(nz.tolist()), tuple(arr[nz].tolist())))


class DenseVector(Vector):
    """Dense float64 vector (ref Vectors.scala:499)."""

    __slots__ = ("values",)

    def __init__(self, values: Union[np.ndarray, Sequence[float]]):
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)

    @property
    def size(self) -> int:
        return self.values.shape[0]

    def to_array(self) -> np.ndarray:
        return self.values

    def __array__(self, dtype=None, copy=None):
        return self.values if dtype is None else self.values.astype(dtype)

    def num_actives(self) -> int:
        return self.size

    def argmax(self) -> int:
        if self.size == 0:
            return -1
        return int(np.argmax(self.values))

    def copy(self) -> "DenseVector":
        return DenseVector(self.values.copy())

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class SparseVector(Vector):
    """Sparse vector as (size, indices, values) (ref Vectors.scala:603)."""

    __slots__ = ("_size", "indices", "values")

    def __init__(self, size: int, indices: Union[np.ndarray, Sequence[int]],
                 values: Union[np.ndarray, Sequence[float]]):
        self._size = int(size)
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        self.values = np.asarray(values, dtype=np.float64).reshape(-1)
        if self.indices.shape[0] != self.values.shape[0]:
            raise ValueError("indices and values must have the same length")
        if self.indices.size > 0:
            if np.any(np.diff(self.indices) <= 0):
                order = np.argsort(self.indices, kind="stable")
                self.indices = self.indices[order]
                self.values = self.values[order]
            if self.indices[-1] >= self._size:
                raise ValueError(f"index {self.indices[-1]} out of range for size {self._size}")

    @property
    def size(self) -> int:
        return self._size

    def to_array(self) -> np.ndarray:
        arr = np.zeros(self._size, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    def num_actives(self) -> int:
        return self.values.shape[0]

    def num_nonzeros(self) -> int:
        return int(np.count_nonzero(self.values))

    def apply(self, i: int) -> float:
        if i < 0 or i >= self._size:
            raise IndexError(i)
        j = np.searchsorted(self.indices, i)
        if j < len(self.indices) and self.indices[j] == i:
            return float(self.values[j])
        return 0.0

    def argmax(self) -> int:
        if self._size == 0:
            return -1
        if self.num_actives() == 0:
            return 0
        max_j = int(np.argmax(self.values))
        max_v = self.values[max_j]
        if max_v <= 0 and self.num_actives() < self._size:
            if max_v < 0:
                # first index not in indices (a zero beats any negative)
                present = set(self.indices.tolist())
                for i in range(self._size):
                    if i not in present:
                        return i
            else:
                return int(self.indices[max_j])
        return int(self.indices[max_j])

    def copy(self) -> "SparseVector":
        return SparseVector(self._size, self.indices.copy(), self.values.copy())

    def __repr__(self) -> str:
        return f"SparseVector({self._size}, {self.indices.tolist()}, {self.values.tolist()})"


class Vectors:
    """Factory methods (ref Vectors.scala object Vectors)."""

    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(list(values))

    @staticmethod
    def sparse(size: int, arg1, arg2=None) -> SparseVector:
        if arg2 is None:
            # list of (index, value) pairs
            pairs = sorted(arg1)
            idx = [p[0] for p in pairs]
            vals = [p[1] for p in pairs]
            return SparseVector(size, idx, vals)
        return SparseVector(size, arg1, arg2)

    @staticmethod
    def zeros(size: int) -> DenseVector:
        return DenseVector(np.zeros(size))

    @staticmethod
    def norm(vector: Vector, p: float) -> float:
        """p-norm (ref Vectors.scala norm)."""
        values = vector.values if isinstance(vector, (DenseVector, SparseVector)) else vector.to_array()
        if p == 1:
            return float(np.sum(np.abs(values)))
        if p == 2:
            return float(np.sqrt(np.sum(values * values)))
        if np.isinf(p):
            return float(np.max(np.abs(values))) if len(values) else 0.0
        if p < 1:
            raise ValueError("p must be >= 1")
        return float(np.power(np.sum(np.power(np.abs(values), p)), 1.0 / p))

    @staticmethod
    def sqdist(v1: Vector, v2: Vector) -> float:
        """Squared euclidean distance (ref Vectors.scala sqdist)."""
        if v1.size != v2.size:
            raise ValueError("vector sizes differ")
        d = v1.to_array() - v2.to_array()
        return float(np.dot(d, d))
