"""The port's KMeans against the JAX package's, on the same numpy data.

Both draw their initial centers from ``np.random.RandomState(seed)`` in the
same order, so in float64 (``cyclone.compute.dtype=float64``) the two fits
start from identical centers and take the same steps: equal
``num_iterations``, centers to 1e-9 and ``training_cost`` to 1e-9 relative.
The k-means|| draws depend on the padded row count (one uniform per padded
row), so the row counts here are multiples of 64: the reference's 8-device
test mesh and the port's one device then pad to the same length.

With the kernel route on (``usePallasKernels=true``: the port's plain K3 on
the CPU, the reference's Pallas kernel interpreted) both assign in float32,
and the centers agree to 1e-5.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.ml.clustering import KMeans as JaxKMeans
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.clustering import KMeans
from cycloneml_tpu_torch.ops import kernels


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _blobs(n=512, d=5, k=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 4
    return centers[rng.randint(k, size=n)] + rng.randn(n, d)


def _assert_same_model(ref, got, rtol=1e-9):
    assert got.num_iterations == ref.num_iterations
    np.testing.assert_allclose(got.cluster_centers_matrix().to_array(),
                               ref.cluster_centers_matrix().to_array(),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.training_cost, ref.training_cost,
                               rtol=rtol)


@pytest.mark.parametrize("init", ["random", "k-means||"])
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_f64_fit_matches_reference(ctx, pctx, init, measure):
    x = _blobs()
    kw = dict(k=4, seed=3, initMode=init, distanceMeasure=measure,
              maxIter=30, tol=1e-9)
    ref = JaxKMeans(**kw).fit(JaxDataset.from_numpy(ctx, x))
    got = KMeans(**kw).fit(interop.dataset_from_numpy(x))
    _assert_same_model(ref, got)


def test_f64_weighted_fit_matches_reference(ctx, pctx):
    x = _blobs(n=448, d=3, k=5, seed=1)
    w = np.random.RandomState(2).rand(len(x)) * 2 + 0.1
    kw = dict(k=5, seed=7, maxIter=30, tol=1e-9, weightCol="w")
    cols = {"features": x, "w": w}
    ref = JaxKMeans(**kw).fit(JaxFrame(ctx, cols))
    got = KMeans(**kw).fit(MLFrame(pctx, cols))
    _assert_same_model(ref, got)


def test_f64_more_clusters_than_rows_matches_reference(ctx, pctx):
    x = _blobs(n=3, d=2, k=1, seed=4)
    ref = JaxKMeans(k=5, maxIter=5).fit(JaxDataset.from_numpy(ctx, x))
    got = KMeans(k=5, maxIter=5).fit(interop.dataset_from_numpy(x))
    _assert_same_model(ref, got)


def test_kernel_route_matches_reference_kernel_fit(ctx, pctx):
    """usePallasKernels=true in both packages: the port's plain K3 (every
    distance pass, k-means|| included) against the reference's
    interpreted Pallas assignment."""
    x = _blobs(n=640, d=6, k=5, seed=5)
    kw = dict(k=5, seed=11, maxIter=20, tol=1e-7)
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxKMeans(**kw).fit(JaxDataset.from_numpy(ctx, x))
    finally:
        ctx.conf.set(JAX_USE_KERNELS, "false")
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    launches = kernels.kmeans_assign.launches
    got = KMeans(**kw).fit(interop.dataset_from_numpy(x))
    _assert_same_model(ref, got, rtol=1e-5)
    # on the CPU the kernel route is the plain version: nothing launched
    assert kernels.kmeans_assign.launches == launches
    assert got.init_distance_passes == 3  # two k-means|| steps, attraction


def test_lloyd_step_kernel_and_plain_agree(pctx):
    """One Lloyd step from the same centers through the K3 route and the
    plain assignment (float32 against float64 distances) gives the same
    centers to float32 resolution."""
    x = _blobs(n=512, d=4, k=3, seed=6)
    ds = interop.dataset_from_numpy(x)
    km = KMeans(k=3, maxIter=1, seed=2)
    init, passes = km._init_centers(ds, 3, False)
    assert passes == 3
    ck, cost_k, it_k = km._lloyd(ds, init, True)
    cp, cost_p, it_p = km._lloyd(ds, init, False)
    assert it_k == it_p == 1
    np.testing.assert_allclose(ck, cp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cost_k, cost_p, rtol=1e-5)


def test_model_from_reference_predicts_the_same(ctx, pctx):
    x = _blobs(n=256, d=4, k=3, seed=8)
    for measure in ("euclidean", "cosine"):
        ref = JaxKMeans(k=3, seed=1, distanceMeasure=measure).fit(
            JaxDataset.from_numpy(ctx, x))
        got = interop.kmeans_model_from_reference(
            ref.cluster_centers_matrix().to_array(), ref.training_cost,
            ref.num_iterations, distanceMeasure=measure)
        xs = np.random.RandomState(9).randn(50, 4) * 3
        np.testing.assert_array_equal(got._assign(xs), ref._assign(xs))
        assert got.predict(xs[0]) == ref.predict(xs[0])
        assert got.compute_cost(MLFrame(pctx, {"features": xs})) == \
            pytest.approx(ref.compute_cost(JaxFrame(ctx, {"features": xs})),
                          rel=1e-12)
        out = got.transform(MLFrame(pctx, {"features": xs}))
        np.testing.assert_array_equal(out["prediction"], ref._assign(xs))
        assert (got.training_cost, got.num_iterations) == \
            (ref.training_cost, ref.num_iterations)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_padding_rows_are_inert(pctx, use_kernel):
    """Padding rows (w = 0) far from the data are never sampled by
    k-means|| (their distance is masked to 0) and add nothing to a Lloyd
    step's center sums or cost, through K3's route and the plain one."""
    x = _blobs(n=256, d=3, k=3, seed=10)
    xp = np.vstack([x, np.full((64, 3), 1e6)])
    w = np.concatenate([np.ones(256), np.zeros(64)])
    padded = InstanceDataset(pctx, torch.from_numpy(xp),
                             torch.zeros(320, dtype=torch.float64),
                             torch.from_numpy(w), 256, 3)
    plain = interop.dataset_from_numpy(x)
    km = KMeans(k=3, maxIter=1, seed=4)
    init, _ = km._init_centers(padded, 3, use_kernel)
    assert np.abs(init).max() < 100
    cp, cost_p, _ = km._lloyd(padded, init, use_kernel)
    cu, cost_u, _ = km._lloyd(plain, init, use_kernel)
    np.testing.assert_allclose(cp, cu, rtol=1e-12)
    np.testing.assert_allclose(cost_p, cost_u, rtol=1e-12)
