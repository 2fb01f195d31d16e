"""Distributed row matrices over the dense or the sparse tier.

The port's counterpart of ``cycloneml_tpu/linalg/distributed.py`` (ref
RowMatrix.scala:47): a ``RowMatrix`` is an ``InstanceDataset``'s feature
block or a ``SparseInstanceDataset``'s ELL rows, rows on the mesh, padding
rows masked by w = 0.

- ``compute_gramian``: X^T X over the present rows; dense rows through
  kernel K4 (``ops/kernels.gramian``) when ``use_fused_kernels`` says so
  (a CUDA X by default), else the plain presence-masked product; sparse
  rows densified a chunk at a time into one float32 product (the small-d
  path; large d goes through ``compute_svd``'s Lanczos operator instead).
- ``compute_covariance``, ``compute_principal_components(_and_variance)``:
  covariance from the Gramian and the mean, ``eigh`` on the host.
- ``compute_svd``: for d <= ``max_gram_dim`` the eigendecomposition of
  the Gramian on the host; otherwise Lanczos with full
  reorthogonalization on the host (numpy, as the reference), whose matvec
  X^T (X q) runs on the device: two products a row chunk at a time on
  dense rows, kernels S1 (the Gram link) and S2 on sparse rows
  (``csrc/ell_sweep.cu``).
- ``multiply`` (X B, rows kept on the device) and ``column_similarities``
  (cosines from the Gramian).

Not ported yet, and raising ``NotImplementedError`` with its ROADMAP
slice: the feature-sharded Gramian (slice 8).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import is_narrow_dtype
from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
from cycloneml_tpu_torch.linalg.matrices import DenseMatrix, Matrix
from cycloneml_tpu_torch.linalg.vectors import DenseVector, Vectors
from cycloneml_tpu_torch.ml.optim.sparse_aggregators import \
    sparse_gradient_pass
from cycloneml_tpu_torch.ml.stat.summarizer import Summarizer
from cycloneml_tpu_torch.ops import kernels

ROW_CHUNK = 1 << 16     # dense rows upcast at a time (X m, the matvec)
DENSIFY_ROWS = 1 << 12  # sparse rows densified at a time (small-d Gramian)


class SVDResult(NamedTuple):
    U: Optional["RowMatrix"]
    s: DenseVector
    V: DenseMatrix


class RowMatrix:
    """Row-oriented distributed matrix without meaningful row indices
    (ref RowMatrix.scala:47), over a dense ``InstanceDataset`` or a
    ``SparseInstanceDataset`` (the reference's RowMatrix is likewise
    storage-agnostic; the sparse large-d path is BASELINE configuration
    5)."""

    def __init__(self, dataset):
        if isinstance(dataset, SparseInstanceDataset):
            self.dataset = dataset
        elif isinstance(dataset, InstanceDataset):
            # not fp8-capable: a quantized dataset is dequantized to bf16
            # (a logged fallback); its codes are never read as values
            self.dataset = dataset.to_instance_dataset()
        else:
            raise TypeError("RowMatrix takes an InstanceDataset or a "
                            "SparseInstanceDataset, not "
                            f"{type(dataset).__name__}")

    @classmethod
    def from_numpy(cls, ctx, x: np.ndarray) -> "RowMatrix":
        return cls(InstanceDataset.from_numpy(ctx, x))

    @property
    def _sparse(self) -> bool:
        return isinstance(self.dataset, SparseInstanceDataset)

    def num_rows(self) -> int:
        return self.dataset.n_rows

    def num_cols(self) -> int:
        return self.dataset.n_features

    # -- gramian ---------------------------------------------------------------
    def compute_gramian(self) -> DenseMatrix:
        """X^T X over the present rows (ref computeGramianMatrix:130)."""
        ds = self.dataset
        if self._sparse:
            return DenseMatrix.from_array(self._sparse_gramian())
        if kernels.use_fused_kernels(ds.ctx, ds.x):
            out = ds.tree_aggregate_fn(lambda x, y, w: kernels.gramian(x, w))()
        else:
            def agg(x, y, w):
                # narrow (bf16) rows accumulate in float32
                acc = torch.float32 if is_narrow_dtype(x.dtype) else x.dtype
                return kernels.gramian_plain(x, w, acc_dtype=acc)
            out = ds.tree_aggregate_fn(agg)()
        return DenseMatrix.from_array(out.cpu().double().numpy())

    def _sparse_gramian(self) -> np.ndarray:
        """The small-d sparse Gramian (ref :80-108): each chunk of ELL rows
        (and its part of the COO tail) densified into (rows, d) float32,
        then one float32 product of the present rows, the chunks summed in
        float64."""
        ds = self.dataset
        d, dev, dt = ds.n_features, ds.device, ds.values.dtype
        n = ds.indices.shape[0]
        tail = ds.tail()
        if tail is not None:
            tail_rows = kernels.tail_row_ids(tail)
            tail_vals = kernels.tail_values(tail, ds.scale)
            ptr = tail.ptr.tolist()
        g = torch.zeros((d, d), dtype=torch.float64, device=dev)
        for lo in range(0, n, DENSIFY_ROWS):
            hi = min(lo + DENSIFY_ROWS, n)
            v = ds.values[lo:hi]
            idx = ds.indices[lo:hi].long()
            if ds.scale is not None:
                v = v * ds.scale[idx]
            rows = torch.arange(hi - lo, device=dev)[:, None].expand_as(idx)
            dense = torch.zeros((hi - lo, d), dtype=dt, device=dev)
            dense.index_put_((rows, idx), v, accumulate=True)
            if tail is not None and ptr[hi] > ptr[lo]:
                t = slice(ptr[lo], ptr[hi])
                dense.index_put_((tail_rows[t] - lo, tail.cols[t].long()),
                                 tail_vals[t], accumulate=True)
            present = dense * (ds.w[lo:hi] > 0).to(dt)[:, None]
            g += (present.T @ dense).double()
        return g.cpu().numpy()

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
        """Top-k singular value decomposition (ref computeSVD:303): for
        d <= ``max_gram_dim`` through the Gramian's eigendecomposition on
        the host, otherwise by Lanczos over the operator q -> X^T X q
        (:meth:`_lanczos`); ranks below ``r_cond`` times the largest
        singular value are dropped. ``compute_u`` gives U = X V / sigma as
        a RowMatrix on the mesh (dense rows only, as the reference)."""
        d = self.num_cols()
        if not 1 <= k <= d:
            raise ValueError(f"k must be in [1,{d}]")
        if d <= max_gram_dim:
            g = self.compute_gramian().to_array()
            vals, vecs = np.linalg.eigh(g)
            order = np.argsort(vals)[::-1]
            vals, vecs = vals[order][:k], vecs[:, order][:, :k]
        else:
            vals, vecs = self._lanczos(k, tol=tol, max_iter=max_iter)
        sigmas = np.sqrt(np.maximum(vals, 0.0))
        if sigmas.size == 0 or sigmas[0] <= 0:
            raise ValueError("matrix has rank 0")
        keep = sigmas > r_cond * sigmas[0]
        sigmas = sigmas[keep]
        vecs = _sign_convention(vecs[:, keep])
        u = None
        if compute_u:
            if self._sparse:
                raise NotImplementedError(
                    "compute_u over the sparse tier: project with "
                    "multiply() after densifying, or request V/sigma only")
            u = self._left_vectors(vecs / sigmas[None, :])
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

    def _gram_matvec_fn(self):
        """``(matvec, dtype)``: q -> X^T (X q) over the present rows as a
        host float64 vector, and the dtype the product runs in. Sparse
        rows: q in the values' float32, kernel S1 with the Gram link then
        S2 (their plain versions off the kernel route), the reference's
        gather/segment-sum pair. Dense rows: two products a chunk of rows
        at a time, X upcast to the accumulator width (w's dtype; the
        reference casts q to X's dtype instead, which at bf16 would leave
        the Ritz values at bf16's precision)."""
        ds = self.dataset
        d = self.num_cols()
        if self._sparse:
            dt = ds.values.dtype

            def matvec(q: np.ndarray) -> np.ndarray:
                qt = torch.as_tensor(q, device=ds.device).to(dt)
                z = sparse_gradient_pass(ds, qt, 0.0, kernels.GRAM, d)[0]
                return z.cpu().double().numpy()

            return matvec, np.float32
        acc = ds.w.dtype
        present = (ds.w > 0).to(acc)

        def dense_matvec(q: np.ndarray) -> np.ndarray:
            qt = torch.as_tensor(q, device=ds.x.device).to(acc)
            z = torch.zeros(d, dtype=acc, device=ds.x.device)
            for lo in range(0, ds.x.shape[0], ROW_CHUNK):
                xc = ds.x[lo:lo + ROW_CHUNK].to(acc)
                z += xc.T @ ((xc @ qt) * present[lo:lo + ROW_CHUNK])
            return z.cpu().double().numpy()

        return dense_matvec, torch.empty((), dtype=acc).numpy().dtype

    def _lanczos(self, k: int, tol: float, max_iter: int):
        """Lanczos with full reorthogonalization on the host (ref :258-319,
        the ARPACK role of EigenValueDecomposition.scala:87); the matvec
        is :meth:`_gram_matvec_fn` on the device. The start vector is
        ``RandomState(0)``'s; every step reorthogonalizes twice; past
        max(3k, 20) steps the Ritz values are checked every 5 steps and
        the run stops once they move less than max(tol, 32 eps) of the
        matvec's dtype."""
        d = self.num_cols()
        matvec, dt = self._gram_matvec_fn()
        rng = np.random.RandomState(0)
        m = min(d, max_iter)
        min_steps = min(max(3 * k, 20), m)
        ritz_tol = max(tol, 32.0 * float(np.finfo(np.dtype(dt)).eps))
        q = rng.randn(d)
        q /= np.linalg.norm(q)
        qs = [q]
        alphas, betas = [], []
        prev_ritz = None
        for j in range(m):
            z = matvec(qs[j])
            a = float(qs[j] @ z)
            alphas.append(a)
            z = z - a * qs[j] - (betas[-1] * qs[j - 1] if betas else 0.0)
            for _ in range(2):  # full reorthogonalization, twice
                for qi in qs:
                    z -= (qi @ z) * qi
            b = float(np.linalg.norm(z))
            if b < tol:
                break
            # past the 3k floor, grow the subspace until the wanted Ritz
            # values stop moving (ARPACK's restarts play this role)
            if j + 1 >= min_steps and (j + 1) % 5 == 0:
                t = np.diag(alphas)
                for i, bb in enumerate(betas):
                    t[i, i + 1] = t[i + 1, i] = bb
                ritz = np.sort(np.linalg.eigvalsh(t))[::-1][:k]
                if prev_ritz is not None and len(prev_ritz) == len(ritz):
                    denom = np.maximum(np.abs(ritz), 1e-300)
                    if np.max(np.abs(ritz - prev_ritz) / denom) < ritz_tol:
                        betas.append(b)
                        qs.append(z / b)
                        break
                prev_ritz = ritz
            betas.append(b)
            qs.append(z / b)
        t = np.diag(alphas)
        for i, b in enumerate(betas[: len(alphas) - 1]):
            t[i, i + 1] = t[i + 1, i] = b
        evals, evecs = np.linalg.eigh(t)
        order = np.argsort(evals)[::-1][:k]
        basis = np.stack(qs[: t.shape[0]], axis=1)
        return evals[order], basis @ evecs[:, order]

    # -- products --------------------------------------------------------------
    def multiply(self, b: Matrix) -> "RowMatrix":
        """X B with the rows kept on the device (ref multiply:592), at the
        accumulator width. Dense rows only, as the reference's."""
        if self._sparse:
            raise NotImplementedError(
                "RowMatrix.multiply over the sparse tier: the reference "
                "multiplies dense rows only")
        if b.num_rows != self.num_cols():
            raise ValueError("dimension mismatch")
        return self._left_vectors(np.asarray(b.to_array(), dtype=np.float64))

    def column_similarities(self) -> DenseMatrix:
        """Upper-triangular cosine similarities between columns, from the
        Gramian (ref columnSimilarities:613; K4 on dense rows on the
        card)."""
        g = self.compute_gramian().to_array()
        norms = np.sqrt(np.maximum(np.diag(g), 1e-300))
        sim = g / norms[:, None] / norms[None, :]
        return DenseMatrix.from_array(np.triu(sim, 1))

    def compute_column_summary_statistics(self):
        """The columns' moments (:class:`~cycloneml_tpu_torch.ml.stat.
        summarizer.SummaryStats`: count, mean, variance, min, max, norms,
        nonzeros) from one pass over the rows on their device."""
        if self._sparse:
            raise NotImplementedError(
                "column summary statistics of a sparse RowMatrix: the "
                "Summarizer takes dense rows only, as the reference's does")
        return Summarizer.summarize(self.dataset)

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
