"""Distributed row matrices on the dense in-core tier.

The port's counterpart of ``cycloneml_tpu/linalg/distributed.py`` (ref
RowMatrix.scala:47): a ``RowMatrix`` is an ``InstanceDataset``'s feature
block, rows on the mesh, padding rows masked by w = 0.

- ``compute_gramian``: X^T X over the present rows, through kernel K4
  (``ops/kernels.gramian``) when ``use_fused_kernels`` says so (a CUDA X by
  default), else the plain presence-masked product.
- ``compute_covariance``, ``compute_principal_components(_and_variance)``:
  covariance from the Gramian and the mean, ``eigh`` on the host.
- ``compute_svd`` in its small-d branch (d <= ``max_gram_dim``): the
  eigendecomposition of the Gramian on the host.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
slice: the sparse tier (slice 2), the feature-sharded Gramian (slice 8),
Lanczos for large d, ``multiply`` and ``column_similarities`` (slice 5).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import is_narrow_dtype
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.stat.summarizer import Summarizer
from cycloneml_tpu_torch.ops import kernels

ROW_CHUNK = 1 << 16  # rows of X upcast at a time by U = X V / sigma


class SVDResult(NamedTuple):
    U: Optional["RowMatrix"]
    s: DenseVector
    V: DenseMatrix


class RowMatrix:
    """Row-oriented distributed matrix without meaningful row indices
    (ref RowMatrix.scala:47), over a dense ``InstanceDataset``."""

    def __init__(self, dataset: InstanceDataset):
        if not isinstance(dataset, InstanceDataset):
            raise NotImplementedError(
                "RowMatrix over the sparse tier is ROADMAP slice 2")
        # not fp8-capable: a quantized dataset is dequantized to bf16 (a
        # logged fallback); its codes are never read as values
        self.dataset = dataset.to_instance_dataset()

    @classmethod
    def from_numpy(cls, ctx, x: np.ndarray) -> "RowMatrix":
        return cls(InstanceDataset.from_numpy(ctx, x))

    def num_rows(self) -> int:
        return self.dataset.n_rows

    def num_cols(self) -> int:
        return self.dataset.n_features

    # -- gramian ---------------------------------------------------------------
    def compute_gramian(self) -> DenseMatrix:
        """X^T X over the present rows (ref computeGramianMatrix:130)."""
        ds = self.dataset
        if kernels.use_fused_kernels(ds.ctx, ds.x):
            out = ds.tree_aggregate_fn(lambda x, y, w: kernels.gramian(x, w))()
        else:
            def agg(x, y, w):
                # narrow (bf16) rows accumulate in float32
                acc = torch.float32 if is_narrow_dtype(x.dtype) else x.dtype
                return kernels.gramian_plain(x, w, acc_dtype=acc)
            out = ds.tree_aggregate_fn(agg)()
        return DenseMatrix.from_array(out.cpu().double().numpy())

    def compute_gramian_sharded(self):
        raise NotImplementedError(
            "the feature-sharded Gramian (model-axis ring) is ROADMAP "
            "slice 8")

    # -- covariance / pca ------------------------------------------------------
    def compute_covariance(self) -> DenseMatrix:
        """Sample covariance (ref computeCovariance:332):
        (X^T X - n mean mean^T) / (n - 1)."""
        n = self.num_rows()
        if n < 2:
            raise ValueError("need at least 2 rows for covariance")
        g = self.compute_gramian().to_array()
        mean = Summarizer.summarize(self.dataset).mean
        return DenseMatrix.from_array(
            (g - n * np.outer(mean, mean)) / (n - 1.0))

    def compute_principal_components_and_variance(
            self, k: int) -> Tuple[DenseMatrix, DenseVector]:
        """The top-k principal components (columns, signs by
        :func:`_sign_convention`) and the share of the variance each
        explains (ref computePrincipalComponentsAndExplainedVariance:486)."""
        d = self.num_cols()
        if not 1 <= k <= d:
            raise ValueError(f"k must be in [1,{d}]")
        cov = self.compute_covariance().to_array()
        vals, vecs = np.linalg.eigh(cov)  # ascending
        order = np.argsort(vals)[::-1]
        vals, vecs = vals[order], vecs[:, order]
        vecs = _sign_convention(vecs)
        total = max(vals.sum(), 1e-300)
        return (DenseMatrix.from_array(vecs[:, :k]),
                Vectors.dense(vals[:k] / total))

    def compute_principal_components(self, k: int) -> DenseMatrix:
        return self.compute_principal_components_and_variance(k)[0]

    # -- svd -------------------------------------------------------------------
    def compute_svd(self, k: int, compute_u: bool = False,
                    r_cond: float = 1e-9, max_gram_dim: int = 4096,
                    tol: float = 1e-10, max_iter: int = 300) -> SVDResult:
        """Top-k singular value decomposition (ref computeSVD:303) through
        the Gramian's eigendecomposition on the host; ranks below
        ``r_cond`` times the largest singular value are dropped.
        ``compute_u`` gives U = X V / sigma as a RowMatrix on the mesh."""
        d = self.num_cols()
        if not 1 <= k <= d:
            raise ValueError(f"k must be in [1,{d}]")
        if d > max_gram_dim:
            raise NotImplementedError(
                "compute_svd for d > max_gram_dim (distributed Lanczos) is "
                "ROADMAP slice 5")
        g = self.compute_gramian().to_array()
        vals, vecs = np.linalg.eigh(g)
        order = np.argsort(vals)[::-1]
        vals, vecs = vals[order][:k], vecs[:, order][:, :k]
        sigmas = np.sqrt(np.maximum(vals, 0.0))
        if sigmas.size == 0 or sigmas[0] <= 0:
            raise ValueError("matrix has rank 0")
        keep = sigmas > r_cond * sigmas[0]
        sigmas = sigmas[keep]
        vecs = _sign_convention(vecs[:, keep])
        u = self._left_vectors(vecs / sigmas[None, :]) if compute_u else None
        return SVDResult(u, Vectors.dense(sigmas), DenseMatrix.from_array(vecs))

    def _left_vectors(self, m: np.ndarray) -> "RowMatrix":
        """X m as a RowMatrix with this one's rows, at the accumulator
        width (w's dtype), X upcast a chunk of rows at a time."""
        ds = self.dataset
        acc = ds.w.dtype
        mt = torch.as_tensor(m, device=ds.x.device).to(acc)
        out = torch.empty((ds.x.shape[0], m.shape[1]), dtype=acc,
                          device=ds.x.device)
        for lo in range(0, ds.x.shape[0], ROW_CHUNK):
            out[lo:lo + ROW_CHUNK] = ds.x[lo:lo + ROW_CHUNK].to(acc) @ mt
        return RowMatrix(ds.derive(x=out, n_features=m.shape[1]))

    # -- not ported yet --------------------------------------------------------
    def multiply(self, b) -> "RowMatrix":
        raise NotImplementedError("RowMatrix.multiply is ROADMAP slice 5")

    def column_similarities(self) -> DenseMatrix:
        raise NotImplementedError(
            "RowMatrix.column_similarities is ROADMAP slice 5")

    def to_numpy(self) -> np.ndarray:
        return self.dataset.to_numpy()[0]


def _sign_convention(vecs: np.ndarray) -> np.ndarray:
    """Deterministic sign: the largest-|component| entry of each column is
    positive (keeps results comparable across runs and backends)."""
    if vecs.size == 0:
        return vecs
    idx = np.argmax(np.abs(vecs), axis=0)
    signs = np.sign(vecs[idx, np.arange(vecs.shape[1])])
    signs[signs == 0] = 1.0
    return vecs * signs[None, :]
