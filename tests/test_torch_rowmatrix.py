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
    got = RowMatrix.from_numpy(pctx, _data(n=50, d=6))
    with pytest.raises(NotImplementedError, match="slice 5"):
        got.compute_svd(2, max_gram_dim=4)
    with pytest.raises(NotImplementedError, match="slice 5"):
        got.multiply(None)
    with pytest.raises(NotImplementedError, match="slice 5"):
        got.column_similarities()
    with pytest.raises(NotImplementedError, match="slice 8"):
        got.compute_gramian_sharded()
    with pytest.raises(NotImplementedError, match="slice 2"):
        RowMatrix(object())
