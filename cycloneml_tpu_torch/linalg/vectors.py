"""Local dense vectors — the port's copy of the ``DenseVector`` part of
``cycloneml_tpu/linalg/vectors.py`` (ref Vectors.scala:499): a float64
numpy-backed vector, the type of a fitted model's ``coefficients``."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np


class DenseVector:
    """Dense float64 vector."""

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

    def __getitem__(self, i: int) -> float:
        return float(self.values[i])

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


class Vectors:
    """Factory (ref Vectors.scala:37)."""

    @staticmethod
    def dense(values) -> DenseVector:
        return DenseVector(values)
