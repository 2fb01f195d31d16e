"""Local linear algebra: vectors, matrices and the BLAS dispatch boundary
(the port's ``cycloneml_tpu/linalg/__init__.py``)."""
from cycloneml_tpu_torch.linalg.vectors import (
    Vector, DenseVector, SparseVector, Vectors,
)
from cycloneml_tpu_torch.linalg.matrices import (
    Matrix, DenseMatrix, SparseMatrix, Matrices,
)
from cycloneml_tpu_torch.linalg import blas as BLAS

__all__ = [
    "Vector", "DenseVector", "SparseVector", "Vectors",
    "Matrix", "DenseMatrix", "SparseMatrix", "Matrices",
    "BLAS",
]
