"""The port's sparse (ELL) tier against the JAX package's, on the same numpy
rows.

The row converters (``rows_to_ell``, ``_csr_to_ell``, ``hash_features``) agree bit
for bit; the datasets densify to the same rows. The aggregators run their
plain route on the CPU (``index_select`` plus ``index_add_``) in float64
(``cyclone.compute.dtype=float64``) over the same float32 values, so the
logistic and squared losses and gradients agree to 1e-10 relative. The
reference's hinge multiplier does not involve the (float64) coefficients,
so it sums the hinge gradient in float32 even under x64: the port's hinge
gradient is held to 1e-10 of a float64 numpy truth and to 1e-6 of the
reference. The summary moments: within 1e-6 of their largest entry, the
reference summing them in float32 (sparse_aggregators.py:114-134).
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu.dataset import sparse as jsparse
from cycloneml_tpu.ml.optim import sparse_aggregators as jsa
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset import sparse as psparse
from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
from cycloneml_tpu_torch.ml.optim import sparse_aggregators as psa
from cycloneml_tpu_torch.ops import kernels
from tests.test_sparse import _random_sparse, _random_varlen_sparse


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _pair(ctx, pctx, hybrid, n=230, d=40, seed=3):
    """The same rows in both packages: pure ELL, or ELL + COO (k_ell=8)."""
    if hybrid:
        rows, dense, y, w = _random_varlen_sparse(n=n, d=d, seed=seed)
        ref = jsparse.SparseInstanceDataset.from_rows_hybrid(
            ctx, rows, y=y, w=w, n_features=d, k_ell=8)
        got = interop.sparse_dataset_from_reference(
            rows=rows, y=y, w=w, n_features=d, k_ell=8, ctx=pctx)
    else:
        rows, dense, y, w = _random_sparse(n=n, d=d, k=6, seed=seed)
        idx, val, _ = jsparse.rows_to_ell(rows, d)
        ref = jsparse.SparseInstanceDataset.from_ell(ctx, idx, val, y, w,
                                                     n_features=d)
        got = interop.sparse_dataset_from_reference(idx, val, y, w,
                                                    n_features=d, ctx=pctx)
    return ref, got, dense, y, w


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# -- row converters and constructors -----------------------------------------

def test_row_converters_match_reference_bit_for_bit():
    rows, _, _, _ = _random_varlen_sparse(n=90, d=70, seed=1)
    for got, ref in zip(psparse.rows_to_ell(rows, 70),
                        jsparse.rows_to_ell(rows, 70)):
        np.testing.assert_array_equal(got, ref)
    nnz = np.array([3, 0, 5, 1])
    fi = np.arange(9, dtype=np.int32) * 7
    fv = np.linspace(-1, 1, 9).astype(np.float32)
    for got, ref in zip(psparse._csr_to_ell(nnz, fi, fv, 6),
                        jsparse._csr_to_ell(nnz, fi, fv, 6)):
        np.testing.assert_array_equal(got, ref)
    ids = np.random.RandomState(2).randint(0, 2**30, size=(50, 7))
    hp, _ = psparse.hash_features(ids, None, 1 << 20)
    hr, _ = jsparse.hash_features(ids, None, 1 << 20)
    np.testing.assert_array_equal(hp, hr)
    np.testing.assert_array_equal(
        psparse.hash_features_torch(torch.from_numpy(ids), 1 << 20).numpy(),
        hr)
    with pytest.raises(ValueError, match="nonzeros"):
        psparse.rows_to_ell([(np.arange(5), np.ones(5))], k_max=3)


@pytest.mark.parametrize("ctor", ["from_ell", "from_rows", "hash",
                                     "from_scipy", "hybrid", "hybrid_short"])
def test_datasets_densify_to_the_reference_rows(ctx, pctx, ctor):
    import scipy.sparse as sp
    rows, dense, y, w = _random_varlen_sparse(n=77, d=33, seed=4) \
        if ctor.startswith("hybrid") else _random_sparse(n=77, d=33, k=5,
                                                            seed=4)
    if ctor == "from_ell":
        idx, val, _ = jsparse.rows_to_ell(rows, 33)
        args = (idx, val, y, w)
        kw = {"n_features": 33}
    elif ctor == "from_scipy":
        args, kw = (sp.csr_matrix(dense), y, w), {}
    elif ctor == "hash":
        ctor, args, kw = "from_rows", (rows, y, w), {"hash_dim": 16}
    elif ctor.startswith("hybrid"):
        k_ell = 50 if ctor == "hybrid_short" else 6
        ctor, args = "from_rows_hybrid", (rows, y, w)
        kw = {"n_features": 33, "k_ell": k_ell}
    else:
        args, kw = (rows, y, w), {"n_features": 33}
    ref = getattr(jsparse.SparseInstanceDataset, ctor)(ctx, *args, **kw)
    got = getattr(SparseInstanceDataset, ctor)(pctx, *args, **kw)
    assert got.shape == ref.shape and got.k_max == ref.k_max
    assert got.is_hybrid == ref.is_hybrid
    np.testing.assert_array_equal(got.to_dense(), ref.to_dense())
    assert got.indices.dtype == torch.int32
    assert got.values.dtype == got.y.dtype == got.w.dtype == torch.float32


# -- aggregators ----------------------------------------------------------------

_GLMS = [("binary_logistic_sparse", False), ("least_squares_sparse", False),
         ("binary_logistic_sparse", True), ("least_squares_sparse", True)]


@pytest.mark.parametrize("name,hybrid", _GLMS)
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_glm_aggregators_match_reference(ctx, pctx, name, hybrid,
                                         fit_intercept):
    ref_ds, got_ds, _, _, _ = _pair(ctx, pctx, hybrid)
    d = 40
    coef = np.random.RandomState(0).randn(d + int(fit_intercept)) * 0.5
    suffix = "_hybrid" if hybrid else ""
    ref = ref_ds.tree_aggregate_fn(
        getattr(jsa, name + suffix)(d, fit_intercept))(coef)
    got = got_ds.tree_aggregate_fn(
        getattr(psa, name + suffix)(d, fit_intercept))(torch.as_tensor(coef))
    assert _rel(float(got["loss"]), float(ref["loss"])) <= 1e-10
    assert _rel(got["grad"].numpy(), ref["grad"]) <= 1e-10
    assert _rel(float(got["count"]), float(ref["count"])) <= 1e-6
    assert got["grad"].dtype == torch.float64


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_hinge_aggregator_matches_float64_and_reference(ctx, pctx,
                                                        fit_intercept):
    ref_ds, got_ds, dense, y, w = _pair(ctx, pctx, False)
    d = 40
    coef = np.random.RandomState(1).randn(d + int(fit_intercept)) * 0.5
    got = got_ds.tree_aggregate_fn(psa.hinge_sparse(d, fit_intercept))(
        torch.as_tensor(coef))
    ref = ref_ds.tree_aggregate_fn(jsa.hinge_sparse(d, fit_intercept))(coef)
    # float64 truth on the float32-rounded rows, weights and labels
    x = dense.astype(np.float32).astype(np.float64)
    ww = w.astype(np.float32).astype(np.float64)
    m = x @ coef[:d] + (coef[d] if fit_intercept else 0.0)
    s = 2 * y - 1
    mult = np.where(1 - s * m > 0, -s * ww, 0.0)
    grad = x.T @ mult
    if fit_intercept:
        grad = np.append(grad, mult.sum())
    assert _rel(float(got["loss"]),
                np.sum(ww * np.maximum(0, 1 - s * m))) <= 1e-10
    assert _rel(got["grad"].numpy(), grad) <= 1e-10
    assert _rel(float(got["loss"]), float(ref["loss"])) <= 1e-10
    assert _rel(got["grad"].numpy(), ref["grad"]) <= 1e-6


@pytest.mark.parametrize("hybrid", [False, True])
def test_summary_matches_reference(ctx, pctx, hybrid):
    ref_ds, got_ds, _, _, _ = _pair(ctx, pctx, hybrid, seed=11)
    d = 40
    ref_agg = jsa.sparse_summary_hybrid(d) if hybrid else jsa.sparse_summary(d)
    got_agg = psa.sparse_summary_hybrid(d) if hybrid else psa.sparse_summary(d)
    ref = ref_ds.tree_aggregate_fn(ref_agg)(np.zeros(1, np.float32))
    got = got_ds.tree_aggregate_fn(got_agg)(None)
    assert set(got) == set(ref)
    for key in ("sum", "sum_sq", "nnz_weight", "weight_sum",
                "weight_sq_sum", "count"):
        assert _rel(got[key].double().numpy(), ref[key]) <= 1e-6, key


@pytest.mark.parametrize("hybrid", [False, True])
def test_feature_std_and_standardized_rows_match_reference(ctx, pctx,
                                                           hybrid):
    ref_ds, got_ds, _, _, _ = _pair(ctx, pctx, hybrid, seed=12)
    ref_std = jsparse.sparse_feature_std(ref_ds)
    got_std = psparse.sparse_feature_std(got_ds)
    np.testing.assert_allclose(got_std, ref_std, rtol=1e-6, atol=1e-12)
    ref_std[3] = 0.0  # a zero-variance column scales to 0
    ref_s, ref_inv = jsparse.standardize_sparse_dataset(ref_ds, ref_std)
    got_s, got_inv = psparse.standardize_sparse_dataset(got_ds, ref_std)
    np.testing.assert_array_equal(got_inv, ref_inv)
    # the same float32 products, folded into the read instead of stored
    np.testing.assert_array_equal(got_s.to_dense(), ref_s.to_dense())
    assert got_s.values is got_ds.values and got_s.scale is not None
    with pytest.raises(ValueError, match="already scaled"):
        psparse.standardize_sparse_dataset(got_s, ref_std)


def test_padding_rows_are_neutral(ctx, pctx):
    """Padding rows (w = 0, slots (0, 0.0)) add nothing although column 0
    is a real feature (the reference's test, both packages)."""
    rows = [(np.array([0]), np.array([5.0]))] * 3
    y = np.ones(3)
    ref = jsparse.SparseInstanceDataset.from_rows(ctx, rows, y=y,
                                                  n_features=4)
    got = SparseInstanceDataset.from_rows(pctx, rows, y=y, n_features=4)
    out = got.tree_aggregate_fn(psa.binary_logistic_sparse(4, False))(
        torch.zeros(4, dtype=torch.float64))
    want = ref.tree_aggregate_fn(jsa.binary_logistic_sparse(4, False))(
        np.zeros(4))
    assert float(out["grad"][0]) == pytest.approx(-7.5, rel=1e-12)
    np.testing.assert_allclose(out["grad"].numpy(), want["grad"],
                               rtol=1e-12)
    assert float(out["count"]) == 3.0


def test_aggregators_check_the_tier(pctx):
    rows, _, y, w = _random_varlen_sparse(n=40, d=20, seed=2)
    hyb = SparseInstanceDataset.from_rows_hybrid(pctx, rows, y, w,
                                                 n_features=20, k_ell=4)
    ell = SparseInstanceDataset.from_rows(pctx, rows, y, w, n_features=20)
    coef = torch.zeros(21, dtype=torch.float64)
    with pytest.raises(ValueError, match="without a COO tail"):
        hyb.tree_aggregate_fn(psa.binary_logistic_sparse(20))(coef)
    with pytest.raises(ValueError, match="with a COO tail"):
        ell.tree_aggregate_fn(psa.least_squares_sparse_hybrid(20))(coef)


@pytest.mark.parametrize("case", ["ell_past_d", "ell_negative",
                                  "tail_past_d", "tail_row_past_n",
                                  "constructor"])
def test_ids_outside_the_dataset_raise_at_ingest(pctx, case):
    """A column id outside [0, n_features) or a tail row id outside the
    rows raises ValueError when the dataset is built (the kernels gather
    by these ids unchecked); ids at the edges are accepted."""
    idx = np.array([[0, 3], [2, 1]], np.int32)
    val = np.ones((2, 2), np.float32)
    SparseInstanceDataset.from_ell(pctx, idx, val, n_features=4)
    rows = [(np.array([0, 1, 3]), np.ones(3)), (np.array([2]), np.ones(1))]
    SparseInstanceDataset.from_rows_hybrid(pctx, rows, n_features=4, k_ell=1)
    with pytest.raises(ValueError, match="ids must lie in"):
        if case == "ell_past_d":
            SparseInstanceDataset.from_ell(pctx, idx, val, n_features=3)
        elif case == "ell_negative":
            SparseInstanceDataset.from_ell(pctx, -idx, val, n_features=4)
        else:
            ds = SparseInstanceDataset.from_rows_hybrid(
                pctx, rows, n_features=4, k_ell=1)
            coo_row, coo_idx = ds.coo_row.clone(), ds.coo_idx.clone()
            d = 3 if case == "constructor" else 4
            if case == "tail_past_d":
                coo_idx[1] = 4
            if case == "tail_row_past_n":
                coo_row[0] = ds.indices.shape[0]
            SparseInstanceDataset(pctx, ds.indices, ds.values, ds.y, ds.w, 2,
                                  d, coo_row, coo_idx, ds.coo_val)


def test_kernel_route_on_the_cpu_runs_the_plain_passes(pctx):
    """usePallasKernels=true with CPU tensors: the wrappers run their plain
    versions (identical results), nothing is launched, and no column copy
    is built."""
    rows, _, y, w = _random_varlen_sparse(n=60, d=25, seed=6)
    ds = SparseInstanceDataset.from_rows_hybrid(pctx, rows, y, w,
                                                n_features=25, k_ell=5)
    coef = torch.linspace(-1, 1, 26, dtype=torch.float64)
    agg = psa.binary_logistic_sparse_hybrid(25)
    plain = ds.tree_aggregate_fn(agg)(coef)
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    fused = ds.tree_aggregate_fn(agg)(coef)
    for key in plain:
        assert torch.equal(plain[key], fused[key])
    assert kernels.ell_rows.launches == 0 and kernels.ell_cols.launches == 0
    assert "columns" not in ds._layout


def test_sparse_dataset_from_reference_holds_the_same_arrays(ctx, pctx):
    ref, got, _, _, _ = _pair(ctx, pctx, False, n=50, d=12, seed=8)
    n = ref.n_rows
    np.testing.assert_array_equal(got.indices.numpy()[:n],
                                  np.asarray(ref.indices)[:n])
    np.testing.assert_array_equal(got.values.numpy()[:n],
                                  np.asarray(ref.values)[:n])
    np.testing.assert_array_equal(got.y_host()[:n], np.asarray(ref.y)[:n])
    np.testing.assert_array_equal(got.w_host()[:n], np.asarray(ref.w)[:n])
    assert np.all(got.w_host()[n:] == 0)


def test_distributed_loss_over_the_sparse_tier_matches_reference(ctx, pctx):
    """The reference's sparse L-BFGS recipe (no weight sum given, so the
    loss function sums w itself) on both packages: the same iterations
    and solution."""
    from cycloneml_tpu.ml.optim.lbfgs import LBFGS as JaxLBFGS
    from cycloneml_tpu.ml.optim.loss import \
        DistributedLossFunction as JaxLoss
    from cycloneml_tpu_torch.ml.optim.lbfgs import LBFGS
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction
    ref_ds, got_ds, _, _, _ = _pair(ctx, pctx, False, n=300, d=30, seed=7)
    ref = JaxLBFGS(max_iter=40, tol=1e-10).minimize(
        JaxLoss(ref_ds, jsa.binary_logistic_sparse(30, fit_intercept=False)),
        np.zeros(30))
    got_loss = DistributedLossFunction(
        got_ds, psa.binary_logistic_sparse(30, fit_intercept=False))
    got = LBFGS(max_iter=40, tol=1e-10).minimize(got_loss, np.zeros(30))
    assert got_loss.weight_sum == pytest.approx(float(np.sum(
        np.asarray(ref_ds.w, np.float64))), rel=1e-7)
    assert got.iteration == ref.iteration
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-6, atol=1e-8)
    # both divide by a float32 sum of the float32 weights, summed in
    # different orders
    assert got.value == pytest.approx(ref.value, rel=1e-6)
