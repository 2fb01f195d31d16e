"""Random dataset generators, drawn on the device.

The port's counterpart of ``cycloneml_tpu/dataset/random.py``
(``generate_classification``, ``generate_regression`` and
``RandomDatasets.normal``), plus ``generate_multiclass``, the recipe of the
reference's OneVsRest benchmark (bench.py ``bench_ovr_stacked``) drawn on
the device, and the sparse tier's two configurations: Criteo-class hashed
rows drawn on the device (:func:`generate_criteo_like`) and the NYTimes
bag of words of BASELINE configuration 5 (:func:`nytimes_like`, the
reference's numpy recipe, so its rows are the reference's bit for bit).
Each mesh shard draws its rows from its own seeded ``torch.Generator``
(seed, shard), and a shared ground-truth weight vector comes from the
generator (seed, 2**31 - 1) — the reference's per-shard ``fold_in``
scheme. The bits differ from ``jax.random``'s, so "the
same seed" is not the same data as the reference's: parity tests never use
these generators; they make their inputs with numpy and hand them to both
packages.
"""

from __future__ import annotations

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.instance import compute_dtype, data_dtype
from cycloneml_tpu_torch.dataset.sparse import (SparseInstanceDataset,
                                                hash_features_torch)

_GEN_ROWS = 1 << 16  # rows drawn at a time (bounds the f32 temporary)
_BETA_STREAM = 2 ** 31 - 1


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32) + int(stream))
    return g


def _generate_labeled(ctx, n_rows: int, n_cols: int, seed: int,
                      noise: float, label) -> InstanceDataset:
    """Rows x ~ N(0, I) and labels ``label(x.beta + noise*eps)`` with a
    shared ``beta ~ N(0, I)``, generated on the device. X lands in the data
    tier (drawn in float32, then narrowed on the device), y/w in the
    accumulator tier; padding rows carry w=0. Only the (n,) labels are read
    back, once, so estimators get their host label moments."""
    conf = getattr(ctx, "conf", None)
    rt = ctx.mesh_runtime
    dev = rt.device
    nd = rt.data_parallelism
    per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
    total = per * nd
    # not fp8-capable: under the fp8 tiers the generators store bfloat16,
    # as the reference's do; quantize with InstanceDataset.quantized()
    cdt, xdt = compute_dtype(conf), data_dtype(conf)
    f32 = torch.float32
    beta = torch.randn(n_cols, generator=_generator(dev, seed, _BETA_STREAM),
                       device=dev, dtype=f32)
    x = torch.empty((total, n_cols), dtype=xdt, device=dev)
    y = torch.empty(total, dtype=cdt, device=dev)
    for shard in range(nd):
        g = _generator(dev, seed, shard)
        for lo in range(0, per, _GEN_ROWS):
            rows = min(_GEN_ROWS, per - lo)
            xc = torch.randn((rows, n_cols), generator=g, device=dev, dtype=f32)
            eps = torch.randn(rows, generator=g, device=dev, dtype=f32)
            at = shard * per + lo
            x[at:at + rows] = xc.to(xdt)
            y[at:at + rows] = label(xc @ beta + noise * eps).to(cdt)
    w_host = np.zeros(total, dtype=np.float64)
    w_host[:n_rows] = 1.0
    w = rt.device_put_sharded_rows(w_host).to(cdt)
    ds = InstanceDataset(ctx, x, y, w, n_rows, n_cols)
    return ds.attach_host_labels(y.cpu().double().numpy(), w_host)


def generate_classification(ctx, n_rows: int, n_cols: int, seed: int = 0,
                            noise: float = 1.0) -> InstanceDataset:
    """Labeled synthetic binary-classification data, generated on the
    device: ``y = 1[x.beta + noise*eps > 0]`` (see
    :func:`_generate_labeled`)."""
    return _generate_labeled(ctx, n_rows, n_cols, seed, noise,
                             lambda m: m > 0)


def generate_regression(ctx, n_rows: int, n_cols: int, seed: int = 0,
                        noise: float = 0.1) -> InstanceDataset:
    """Labeled synthetic linear-regression data, generated on the device
    (the epsilon-shape LinearRegression configuration's feeder):
    ``y = x.beta + noise*eps`` (see :func:`_generate_labeled`)."""
    return _generate_labeled(ctx, n_rows, n_cols, seed, noise,
                             lambda m: m)


def generate_multiclass(ctx, n_rows: int, n_cols: int, n_classes: int,
                        seed: int = 0, center_scale: float = 3.0
                        ) -> InstanceDataset:
    """Labeled synthetic k-class data on the device, the recipe of
    bench.py's ``bench_ovr_stacked``: class centers ``N(0, I) *
    center_scale`` (k, d), labels uniform over the k classes, rows ``x =
    center[y] + N(0, I)``. X in the data tier, labels 0..k-1 in the
    accumulator tier; padding rows carry w=0."""
    conf = getattr(ctx, "conf", None)
    rt = ctx.mesh_runtime
    dev = rt.device
    nd = rt.data_parallelism
    per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
    total = per * nd
    cdt, xdt = compute_dtype(conf), data_dtype(conf)
    f32 = torch.float32
    centers = torch.randn((n_classes, n_cols), dtype=f32, device=dev,
                          generator=_generator(dev, seed, _BETA_STREAM)) \
        * center_scale
    x = torch.empty((total, n_cols), dtype=xdt, device=dev)
    y = torch.empty(total, dtype=cdt, device=dev)
    for shard in range(nd):
        g = _generator(dev, seed, shard)
        for lo in range(0, per, _GEN_ROWS):
            rows = min(_GEN_ROWS, per - lo)
            yc = torch.randint(0, n_classes, (rows,), generator=g,
                               device=dev)
            xc = torch.randn((rows, n_cols), generator=g, device=dev,
                             dtype=f32)
            at = shard * per + lo
            x[at:at + rows] = (centers[yc] + xc).to(xdt)
            y[at:at + rows] = yc.to(cdt)
    w_host = np.zeros(total, dtype=np.float64)
    w_host[:n_rows] = 1.0
    w = rt.device_put_sharded_rows(w_host).to(cdt)
    ds = InstanceDataset(ctx, x, y, w, n_rows, n_cols)
    return ds.attach_host_labels(y.cpu().double().numpy(), w_host)


# -- the sparse tier's configurations ------------------------------------------

CRITEO_INT_FIELDS = 13         # integer fields: column j, value log1p(count)
CRITEO_CAT_FIELDS = 26         # categorical fields: hashed, value 1.0
ZIPF_A = 1.1
ZIPF_RANKS = 1 << 20           # each categorical field's truncated zipf
_SPARSE_GEN_ROWS = 1 << 20     # rows drawn at a time


def _zipf_cdf(a: float, ranks: int, device) -> torch.Tensor:
    """The float64 CDF of zipf(a) truncated to ``ranks`` ranks."""
    p = torch.arange(1, ranks + 1, dtype=torch.float64, device=device) ** -a
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def generate_criteo_like(ctx, n_rows: int, seed: int = 0,
                         hash_dim: int = 1 << 20, positive: float = 0.25,
                         noise: float = 1.0) -> SparseInstanceDataset:
    """Criteo-class hashed sparse rows drawn on the device (the shape of
    the Criteo display-advertising training set: 13 integer and 26
    categorical fields, k = 39 ELL slots a row). Integer field j is column
    j with value log1p(count), count = floor(exp(3 |z|)), z ~ N(0, 1) (so
    never 0); categorical field f draws a rank r from zipf(1.1) truncated
    to 2^20 ranks by inverse CDF, and its id r * 26 + f goes through
    :func:`~cycloneml_tpu_torch.dataset.sparse.hash_features`' hash into
    ``hash_dim`` columns with value 1.0. Labels come from a planted sparse
    beta (each column N(0, 1/4) with probability 1/8) plus ``noise`` N(0,
    1), thresholded so that a ``positive`` share of rows is 1. Every draw
    comes from the seeded generators (seed, 0) and (seed, 2^31 - 1)."""
    rt = ctx.mesh_runtime
    dev = rt.device
    n_pad = max((n_rows + 7) // 8 * 8, 8)
    k = CRITEO_INT_FIELDS + CRITEO_CAT_FIELDS
    g = _generator(dev, seed, 0)
    gb = _generator(dev, seed, _BETA_STREAM)
    beta = torch.randn(hash_dim, generator=gb, device=dev) * 0.5 \
        * (torch.rand(hash_dim, generator=gb, device=dev) < 0.125)
    cdf = _zipf_cdf(ZIPF_A, ZIPF_RANKS, dev)
    field = torch.arange(CRITEO_CAT_FIELDS, device=dev)
    idx = torch.zeros((n_pad, k), dtype=torch.int32, device=dev)
    val = torch.zeros((n_pad, k), dtype=torch.float32, device=dev)
    margin = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    idx[:, :CRITEO_INT_FIELDS] = torch.arange(CRITEO_INT_FIELDS,
                                              dtype=torch.int32, device=dev)
    for lo in range(0, n_rows, _SPARSE_GEN_ROWS):
        hi = min(lo + _SPARSE_GEN_ROWS, n_rows)
        z = torch.randn((hi - lo, CRITEO_INT_FIELDS), generator=g,
                        device=dev)
        val[lo:hi, :CRITEO_INT_FIELDS] = torch.log1p(
            torch.floor(torch.exp(3.0 * z.abs())))
        u = torch.rand((hi - lo, CRITEO_CAT_FIELDS), generator=g, device=dev,
                       dtype=torch.float64)
        rank = torch.searchsorted(cdf, u).clamp_(max=ZIPF_RANKS - 1)
        idx[lo:hi, CRITEO_INT_FIELDS:] = hash_features_torch(
            rank * CRITEO_CAT_FIELDS + field, hash_dim)
        val[lo:hi, CRITEO_INT_FIELDS:] = 1.0
        margin[lo:hi] = torch.sum(val[lo:hi] * beta[idx[lo:hi].long()], 1) \
            + noise * torch.randn(hi - lo, generator=g, device=dev)
    sample = margin[:min(n_rows, _SPARSE_GEN_ROWS)]
    thresh = torch.quantile(sample, 1.0 - positive)
    y = (margin > thresh).float()
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[:n_rows] = 1.0
    y[n_rows:] = 0.0
    return SparseInstanceDataset(ctx, idx, val, y, w, n_rows, hash_dim)


def nytimes_like(n_docs: int, vocab: int, nnz_per_doc: int, seed: int = 5):
    """Zipf-marginal bag of words at the UCI NYTimes shape (BASELINE
    configuration 5), the numpy recipe of the reference's benchmark
    (benchmarks/baseline_configs.py ``_nytimes_like``) copied draw for
    draw: ``RandomState(seed)``, columns (zipf(1.1) - 1) mod vocab,
    duplicates kept, counts 1 + Poisson(0.6). Returns ELL (indices (n, k)
    int32, values (n, k) float32), bit for bit the reference's."""
    rng = np.random.RandomState(seed)
    idx = (rng.zipf(1.1, size=(n_docs, nnz_per_doc)) - 1) % vocab
    val = (1.0 + rng.poisson(0.6, size=(n_docs, nnz_per_doc))).astype(
        np.float32)
    return idx.astype(np.int32), val


class RandomDatasets:
    """Static factory surface mirroring RandomRDDs (the vector variants
    this slice uses)."""

    classification = staticmethod(generate_classification)
    regression = staticmethod(generate_regression)
    multiclass = staticmethod(generate_multiclass)

    @staticmethod
    def normal(ctx, n_rows: int, n_cols: int = 1, seed: int = 0,
               mean: float = 0.0, std: float = 1.0) -> InstanceDataset:
        """Unlabeled rows x ~ N(mean, std^2 I) on the device, in the data
        tier (drawn in float32, narrowed on the device); y = 0, padding
        rows carry w=0."""
        conf = getattr(ctx, "conf", None)
        rt = ctx.mesh_runtime
        dev = rt.device
        nd = rt.data_parallelism
        per = max(((n_rows + nd - 1) // nd + 7) // 8 * 8, 8)
        total = per * nd
        cdt, xdt = compute_dtype(conf), data_dtype(conf)
        x = torch.empty((total, n_cols), dtype=xdt, device=dev)
        for shard in range(nd):
            g = _generator(dev, seed, shard)
            for lo in range(0, per, _GEN_ROWS):
                rows = min(_GEN_ROWS, per - lo)
                at = shard * per + lo
                x[at:at + rows] = (torch.randn(
                    (rows, n_cols), generator=g, device=dev,
                    dtype=torch.float32) * std + mean).to(xdt)
        w_host = np.zeros(total, dtype=np.float64)
        w_host[:n_rows] = 1.0
        w = rt.device_put_sharded_rows(w_host).to(cdt)
        ds = InstanceDataset(ctx, x, torch.zeros(total, dtype=cdt,
                                                 device=dev), w, n_rows,
                             n_cols)
        return ds.attach_host_labels(np.zeros(total), w_host)
