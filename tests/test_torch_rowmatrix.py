"""The port's RowMatrix and PCA against the JAX package's, on the same
numpy data.

In float64 (``cyclone.compute.dtype=float64``) the Gramian, covariance,
principal components (after the sign convention), explained variance and
the small-d SVD agree to 1e-9: both eigendecompose the same float64 matrix
on the host, up to rounding in the Gramian's sums. The row counts are not
multiples of the padding, so padding rows (w = 0) are masked on both sides.
With the kernel route on (``usePallasKernels=true``: the port's plain K4 on
the CPU, the reference's interpreted Pallas kernel) both Gramians are
float32, held to the reference test's rtol 1e-4, atol 1e-3.

The rest of RowMatrix: Lanczos on float64 rows takes the reference's
steps (its matvecs are counted on both sides) to singular values within
1e-9; on sparse float32 rows (ELL and hybrid) within 1e-6 of the
reference's and of scipy's svds, the reference test's bound; ``multiply``
and ``column_similarities`` within 1e-12 in float64.
"""

import numpy as np
import pytest

from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.linalg.distributed import RowMatrix as JaxRowMatrix
from cycloneml_tpu.ml.feature import PCA as JaxPCA
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.linalg.distributed import RowMatrix
from cycloneml_tpu_torch.linalg.matrices import Matrices
from cycloneml_tpu_torch.ml.feature import PCA
from cycloneml_tpu_torch.ops import kernels


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _data(n=301, d=9, seed=0):
    """Rows with a spread spectrum and a nonzero mean."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(d, d))
    s = 3.0 / np.arange(1, d + 1)
    return (rng.randn(n, d) * s) @ q.T + rng.randn(d)


def _matrices(ctx, pctx, x):
    return JaxRowMatrix.from_numpy(ctx, x), RowMatrix.from_numpy(pctx, x)


def test_f64_gramian_and_covariance_match_reference(ctx, pctx):
    x = _data()
    ref, got = _matrices(ctx, pctx, x)
    assert (got.num_rows(), got.num_cols()) == (ref.num_rows(),
                                                ref.num_cols())
    g = got.compute_gramian().to_array()
    np.testing.assert_allclose(g, ref.compute_gramian().to_array(),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(g, x.T @ x, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(g, g.T)
    np.testing.assert_allclose(got.compute_covariance().to_array(),
                               ref.compute_covariance().to_array(),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_f64_principal_components_match_reference(ctx, pctx, k):
    ref, got = _matrices(ctx, pctx, _data(seed=1))
    rp, rv = ref.compute_principal_components_and_variance(k)
    gp, gv = got.compute_principal_components_and_variance(k)
    np.testing.assert_allclose(gp.to_array(), rp.to_array(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gv.to_array(), rv.to_array(), rtol=1e-9)
    np.testing.assert_allclose(got.compute_principal_components(k)
                               .to_array(), rp.to_array(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("k", [3, 9])
def test_f64_small_d_svd_matches_reference(ctx, pctx, k):
    x = _data(seed=2)
    ref, got = _matrices(ctx, pctx, x)
    rs = ref.compute_svd(k, compute_u=True)
    gs = got.compute_svd(k, compute_u=True)
    np.testing.assert_allclose(gs.s.to_array(), rs.s.to_array(), rtol=1e-9)
    np.testing.assert_allclose(gs.V.to_array(), rs.V.to_array(), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(gs.U.to_numpy(), rs.U.to_numpy(), rtol=1e-8,
                               atol=1e-9)
    assert gs.U.num_cols() == k and gs.U.num_rows() == x.shape[0]


def test_f64_pca_fit_matches_reference(ctx, pctx):
    x = _data(n=257, d=7, seed=3)
    ref = JaxPCA(k=3).fit(JaxFrame(ctx, {"features": x}))
    got = PCA(k=3).fit(MLFrame(pctx, {"features": x}))
    np.testing.assert_allclose(got.pc, ref.pc, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.explained_variance,
                               ref.explained_variance, rtol=1e-9)
    out = got.transform(MLFrame(pctx, {"features": x}))
    np.testing.assert_allclose(out["pca"], x @ ref.pc, rtol=1e-9, atol=1e-9)


def test_kernel_route_matches_reference_kernel(ctx, pctx):
    """usePallasKernels=true in both packages: the port's plain K4 against
    the reference's interpreted fused_gramian (test_pallas_ops.py:88's
    tolerance), padding rows masked, and the PCs that follow."""
    x = _data(n=400, d=19, seed=4)
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxRowMatrix.from_numpy(ctx, x)
        rg = ref.compute_gramian().to_array()
        rp, rv = ref.compute_principal_components_and_variance(3)
    finally:
        ctx.conf.set(JAX_USE_KERNELS, "false")
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    launches = kernels.gramian.launches
    got = RowMatrix.from_numpy(pctx, x)
    g = got.compute_gramian().to_array()
    np.testing.assert_allclose(g, rg, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(g, g.T)
    gp, gv = got.compute_principal_components_and_variance(3)
    np.testing.assert_allclose(np.abs(np.sum(gp.to_array() * rp.to_array(),
                                             axis=0)), 1.0, atol=1e-6)
    np.testing.assert_allclose(gv.to_array(), rv.to_array(), rtol=1e-4)
    # on the CPU the kernel route is the plain version: nothing launched
    assert kernels.gramian.launches == launches


def test_pca_model_from_reference_transforms_the_same(ctx, pctx):
    x = _data(n=200, d=6, seed=5)
    ref = JaxPCA(k=2).fit(JaxFrame(ctx, {"features": x}))
    got = interop.pca_model_from_reference(ref.pc, ref.explained_variance)
    assert got.get("k") == 2
    xs = np.random.RandomState(6).randn(30, 6)
    np.testing.assert_allclose(
        got.transform(MLFrame(pctx, {"features": xs}))["pca"],
        np.asarray(ref.transform(JaxFrame(ctx, {"features": xs}))["pca"]),
        rtol=1e-12)


def test_unported_parts_raise_with_their_slice(pctx):
    """What still raises: the feature-sharded Gramian (slice 8) and, as in
    the reference, U over the sparse tier (and X B of sparse rows)."""
    from cycloneml_tpu_torch.dataset.sparse import SparseInstanceDataset
    got = RowMatrix.from_numpy(pctx, _data(n=50, d=6))
    with pytest.raises(NotImplementedError, match="slice 8"):
        got.compute_gramian_sharded()
    idx, val, _ = _sparse_rows(n=40, d=12, nnz=3, seed=1)
    sparse = RowMatrix(SparseInstanceDataset.from_ell(pctx, idx, val,
                                                      n_features=12))
    with pytest.raises(NotImplementedError, match="compute_u over the sparse"):
        sparse.compute_svd(2, compute_u=True)
    with pytest.raises(NotImplementedError, match="sparse tier"):
        sparse.multiply(Matrices.from_array(np.ones((12, 2))))
    with pytest.raises(TypeError, match="RowMatrix takes"):
        RowMatrix(object())


# -- Lanczos, multiply, column similarities, the sparse tier --------------------

def _counted(rm, calls, key):
    """Count ``rm``'s Lanczos matvecs into ``calls[key]``."""
    base = rm._gram_matvec_fn

    def wrapped():
        matvec, dt = base()

        def mv(q):
            calls[key] = calls.get(key, 0) + 1
            return matvec(q)
        return mv, dt

    rm._gram_matvec_fn = wrapped
    return rm


@pytest.mark.parametrize("k,max_gram_dim", [(4, 8), (3, 1), (6, 20)])
def test_f64_dense_lanczos_matches_reference(ctx, pctx, k, max_gram_dim):
    """Lanczos forced by a small max_gram_dim on float64 rows: the same
    number of steps and the singular values to 1e-9, and both to numpy's
    SVD."""
    x = np.random.RandomState(45).randn(100, 30) @ np.diag(
        np.linspace(3, 0.2, 30))
    calls = {}
    ref = _counted(JaxRowMatrix.from_numpy(ctx, x), calls, "ref")
    got = _counted(RowMatrix.from_numpy(pctx, x), calls, "got")
    rs = ref.compute_svd(k, max_gram_dim=max_gram_dim)
    gs = got.compute_svd(k, max_gram_dim=max_gram_dim)
    assert calls["got"] == calls["ref"]
    np.testing.assert_allclose(gs.s.to_array(), rs.s.to_array(), rtol=1e-9)
    np.testing.assert_allclose(gs.s.to_array(),
                               np.linalg.svd(x, compute_uv=False)[:k],
                               rtol=1e-6)
    np.testing.assert_allclose(np.abs(np.sum(gs.V.to_array()
                                             * rs.V.to_array(), axis=0)),
                               1.0, atol=1e-8)


def _sparse_rows(n=400, d=120, nnz=12, seed=7):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.choice(d, nnz, replace=False)
                    for _ in range(n)]).astype(np.int32)
    val = rng.rand(n, nnz).astype(np.float32) + 0.1
    import scipy.sparse as sp
    csr = sp.csr_matrix((val.reshape(-1), (np.repeat(np.arange(n), nnz),
                                           idx.reshape(-1))), shape=(n, d))
    return idx, val, csr


@pytest.mark.parametrize("hybrid", [False, True])
def test_sparse_lanczos_matches_reference_and_scipy(ctx, pctx, hybrid):
    """The reference's sparse RowMatrix test on both packages (its bound,
    1e-6, against scipy's svds in float64 and between the two)."""
    import scipy.sparse.linalg as spla
    from cycloneml_tpu.dataset.sparse import \
        SparseInstanceDataset as JaxSparse
    idx, val, csr = _sparse_rows()
    if hybrid:
        rows = [(idx[i], val[i]) for i in range(idx.shape[0])]
        ref_ds = JaxSparse.from_rows_hybrid(ctx, rows, n_features=120,
                                            k_ell=6)
        got_ds = interop.sparse_dataset_from_reference(
            rows=rows, n_features=120, k_ell=6, ctx=pctx)
    else:
        ref_ds = JaxSparse.from_ell(ctx, idx, val, n_features=120)
        got_ds = interop.sparse_dataset_from_reference(idx, val,
                                                       n_features=120,
                                                       ctx=pctx)
    want = np.sort(spla.svds(csr.astype(np.float64), k=5,
                             return_singular_vectors=False))[::-1]
    ref = JaxRowMatrix(ref_ds).compute_svd(5, max_gram_dim=1)
    got = RowMatrix(got_ds).compute_svd(5, max_gram_dim=1)
    np.testing.assert_allclose(got.s.to_array(), want, rtol=1e-6)
    np.testing.assert_allclose(got.s.to_array(), ref.s.to_array(),
                               rtol=1e-6)
    # the default max_gram_dim takes the small-d Gramian branch
    gram = RowMatrix(got_ds).compute_svd(5)
    np.testing.assert_allclose(gram.s.to_array(), want, rtol=1e-6)


@pytest.mark.parametrize("hybrid", [False, True])
def test_sparse_gramian_matches_reference(ctx, pctx, hybrid):
    """The small-d sparse Gramian (rows densified a chunk at a time, one
    float32 product each): within 1e-6 of the reference's float32 einsum,
    scaled by the diagonal, padding rows masked."""
    from cycloneml_tpu.dataset.sparse import \
        SparseInstanceDataset as JaxSparse
    idx, val, csr = _sparse_rows(n=301, d=40, nnz=9, seed=3)
    if hybrid:
        rows = [(idx[i], val[i]) for i in range(idx.shape[0])]
        ref_ds = JaxSparse.from_rows_hybrid(ctx, rows, n_features=40,
                                            k_ell=4)
        got_ds = interop.sparse_dataset_from_reference(
            rows=rows, n_features=40, k_ell=4, ctx=pctx)
    else:
        ref_ds = JaxSparse.from_ell(ctx, idx, val, n_features=40)
        got_ds = interop.sparse_dataset_from_reference(idx, val,
                                                       n_features=40,
                                                       ctx=pctx)
    g = RowMatrix(got_ds).compute_gramian().to_array()
    rg = JaxRowMatrix(ref_ds).compute_gramian().to_array()
    dg = np.sqrt(np.outer(np.diag(rg), np.diag(rg)))
    assert np.max(np.abs(g - rg) / dg) <= 1e-6
    np.testing.assert_allclose(g, (csr.T @ csr).toarray(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        RowMatrix(got_ds).column_similarities().to_array(),
        JaxRowMatrix(ref_ds).column_similarities().to_array(), atol=1e-6)


def test_f64_multiply_and_column_similarities_match_reference(ctx, pctx):
    from cycloneml_tpu.linalg.matrices import Matrices as JaxMatrices
    x = _data(n=203, d=11, seed=46)
    ref, got = _matrices(ctx, pctx, x)
    b = np.random.RandomState(0).randn(11, 4)
    rp = ref.multiply(JaxMatrices.from_array(b))
    gp = got.multiply(Matrices.from_array(b))
    assert (gp.num_rows(), gp.num_cols()) == (203, 4)
    np.testing.assert_allclose(gp.to_numpy(), rp.to_numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(gp.to_numpy(), x @ b, rtol=1e-12, atol=1e-12)
    rs = ref.column_similarities().to_array()
    gs = got.column_similarities().to_array()
    np.testing.assert_allclose(gs, rs, rtol=1e-12, atol=1e-12)
    assert np.all(np.tril(gs) == 0.0)
    with pytest.raises(ValueError, match="dimension mismatch"):
        got.multiply(Matrices.from_array(np.ones((5, 2))))
