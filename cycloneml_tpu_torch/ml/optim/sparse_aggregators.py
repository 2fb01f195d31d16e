"""Block aggregators over ELL sparse rows.

The port's counterpart of ``cycloneml_tpu/ml/optim/sparse_aggregators.py``:
the same ``{"loss", "grad", "count"}`` contract as the dense aggregators
(sums, not means), with margins from gathers (sum_k v beta[index]) and the
gradient from column sums of mult x, O(nnz) instead of O(n d); and the
weighted feature moments of :func:`sparse_summary`. Padding slots (0, 0.0)
and padding rows (w = 0) are exactly neutral.

An aggregator is ``agg(block, coef)``, where ``block`` is a
:class:`~cycloneml_tpu_torch.dataset.sparse.SparseInstanceDataset`'s rows
(``tree_aggregate_fn`` passes it). The plain route is ``index_select``
plus ``index_add_`` (``ops/kernels.ell_rows_plain``/``ell_cols_plain``),
in the dtype of the coefficients; under ``cyclone.ml.usePallasKernels``
(a CUDA dataset by default) every evaluation is one launch of S1
(``ell_rows``, the row pass with the link, reading the hot columns'
coefficients from shared memory) and one of S2 (``ell_cols``, the column
pass over the copy of the nonzeros in (row block, column) order), both from
``csrc/ell_sweep.cu``, which sum in one fixed order. The ``_hybrid`` twins
take a dataset with a COO tail, the others one without, as the
reference's signatures do.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict

import torch

from cycloneml_tpu_torch.ops import kernels

Agg = Callable[..., Dict[str, torch.Tensor]]


def _split(coef: torch.Tensor, d: int, fit_intercept: bool):
    if fit_intercept:
        return coef[:d], coef[d]
    return coef, torch.zeros((), dtype=coef.dtype, device=coef.device)


def _fused(block) -> bool:
    return kernels.use_fused_kernels(block.ctx, block.values)


def _check_tier(block, hybrid: bool, name: str) -> None:
    if block.is_hybrid != hybrid:
        want = "with" if hybrid else "without"
        raise ValueError(f"{name} takes a dataset {want} a COO tail")


def sparse_gradient_pass(block, beta: torch.Tensor, b0, link: str, d: int):
    """One evaluation over ``block``: S1 at ``link`` then S2 on its
    multipliers. Returns ``(grad (d,), loss, sum(mult), sum(w))``, through
    the kernels or the plain versions as :func:`_fused` says."""
    tail = block.tail()
    if _fused(block):
        mult, loss, msum, wsum = kernels.ell_rows(
            block.indices, block.values, block.y, block.w, beta, b0, link,
            block.scale, tail, hot=block.hot_columns())
        g = kernels.ell_cols(block.indices, block.values, mult, d,
                             scale=block.scale, tail=tail,
                             columns=block.columns)
    else:
        mult, loss, msum, wsum = kernels.ell_rows_plain(
            block.indices, block.values, block.y, block.w, beta, b0, link,
            block.scale, tail)
        g = kernels.ell_cols_plain(block.indices, block.values, mult, d,
                                   scale=block.scale, tail=tail)
    return g, loss, msum, wsum


def _glm(link: str, d: int, fit_intercept: bool, hybrid: bool,
         name: str) -> Agg:
    def agg(block, coef):
        _check_tier(block, hybrid, name)
        beta, b0 = _split(coef, d, fit_intercept)
        g, loss, msum, wsum = sparse_gradient_pass(block, beta, b0, link, d)
        grad = torch.cat([g, msum.reshape(1).to(g.dtype)]) \
            if fit_intercept else g
        return {"loss": loss, "grad": grad, "count": wsum}

    return agg


@functools.lru_cache(maxsize=None)
def binary_logistic_sparse(d: int, fit_intercept: bool = True) -> Agg:
    """Sparse binomial logistic: loss w (softplus(m) - y m), mult
    w (sigmoid(m) - y)."""
    return _glm(kernels.LOGISTIC, d, fit_intercept, False,
                "binary_logistic_sparse")


@functools.lru_cache(maxsize=None)
def least_squares_sparse(d: int, fit_intercept: bool = True) -> Agg:
    """Sparse squared loss: err = m - y, loss 1/2 w err^2, mult w err."""
    return _glm(kernels.SQUARED, d, fit_intercept, False,
                "least_squares_sparse")


@functools.lru_cache(maxsize=None)
def hinge_sparse(d: int, fit_intercept: bool = True) -> Agg:
    """Sparse hinge loss: s = 2y - 1, loss w max(0, 1 - s m), mult -s w
    where 1 - s m > 0."""
    return _glm(kernels.HINGE, d, fit_intercept, False, "hinge_sparse")


@functools.lru_cache(maxsize=None)
def binary_logistic_sparse_hybrid(d: int, fit_intercept: bool = True) -> Agg:
    """Hybrid twin of :func:`binary_logistic_sparse`."""
    return _glm(kernels.LOGISTIC, d, fit_intercept, True,
                "binary_logistic_sparse_hybrid")


@functools.lru_cache(maxsize=None)
def least_squares_sparse_hybrid(d: int, fit_intercept: bool = True) -> Agg:
    """Hybrid twin of :func:`least_squares_sparse`."""
    return _glm(kernels.SQUARED, d, fit_intercept, True,
                "least_squares_sparse_hybrid")


def _summary(d: int, hybrid: bool, name: str) -> Agg:
    def agg(block, coef_unused=None):
        _check_tier(block, hybrid, name)
        w = block.w
        tail = block.tail()
        if _fused(block):
            mom = kernels.ell_cols(block.indices, block.values, w, d,
                                   moments=True, scale=block.scale,
                                   tail=tail, columns=block.columns)
        else:
            mom = kernels.ell_cols_plain(block.indices, block.values, w, d,
                                         moments=True, scale=block.scale,
                                         tail=tail)
        return {"sum": mom[0], "sum_sq": mom[1], "nnz_weight": mom[2],
                "weight_sum": torch.sum(w), "weight_sq_sum": torch.sum(w * w),
                "count": torch.sum((w > 0).to(w.dtype))}

    return agg


@functools.lru_cache(maxsize=None)
def sparse_summary(d: int) -> Agg:
    """Single-pass weighted feature moments (the dense Summarizer's
    aggregation): per feature sum w v, sum (w v) v and sum w [v != 0],
    plus sum w, sum w^2 and the count of present rows. Zero entries add
    0; the caller folds in the implicit zeros. The products are float32,
    as the reference forms them, summed in double (both routes) into
    float32 results."""
    return _summary(d, False, "sparse_summary")


@functools.lru_cache(maxsize=None)
def sparse_summary_hybrid(d: int) -> Agg:
    """Hybrid twin of :func:`sparse_summary`: the tail's entries fold into
    the same moments with their row's weight."""
    return _summary(d, True, "sparse_summary_hybrid")
