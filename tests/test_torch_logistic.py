"""The port's binomial LogisticRegression.fit against the JAX package's, on
the same numpy data.

In float64 (``cyclone.compute.dtype=float64``, the counterpart of the
reference's x64 test configuration) the two fits must take the same path:
equal iteration and evaluation counts, objective histories within rtol
1e-10, coefficients within rtol 1e-8 / atol 1e-10. With the kernel route on
(``usePallasKernels=true``: the port's plain K1 on the CPU, the reference's
Pallas kernel interpreted) both sweeps sum in float32, and the models agree
within the reference's own kernel-vs-plain bound (rtol 5e-3, atol 5e-4,
tests/test_pallas_ops.py).
"""

import numpy as np
import pytest

from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
from cycloneml_tpu.ml.optim.lbfgs import OptimState as JaxOptimState
from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch import interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ops import kernels


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _data(n=500, d=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 3) + rng.randn(d)
    beta = rng.randn(d)
    y = ((x - x.mean(0)) @ beta + rng.randn(n) > 0).astype(np.float64)
    return x, y


def _assert_same_path(ref, got):
    rs, gs = ref.summary, got.summary
    assert gs.total_iterations == rs.total_iterations
    assert gs.total_evals == rs.total_evals
    assert gs.total_dispatches == rs.total_dispatches
    np.testing.assert_allclose(gs.objective_history, rs.objective_history,
                               rtol=1e-10)
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept,
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_f64_fit_matches_reference(ctx, pctx, fit_intercept, reg):
    x, y = _data()
    kw = dict(maxIter=30, regParam=reg, fitIntercept=fit_intercept, tol=1e-9)
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_path(ref, got)


def test_f64_weighted_unstandardized_host_lbfgs_matches_reference(ctx, pctx):
    """Instance weights, the original-space penalty
    (standardization=false) and deviceChunk=0 (host L-BFGS, whole line
    search on the device) take the reference's path too."""
    x, y = _data(n=400, d=7, seed=4)
    w = np.random.RandomState(5).rand(len(y)) + 0.2
    kw = dict(maxIter=25, regParam=0.05, standardization=False, tol=1e-9)
    from cycloneml_tpu.conf import LBFGS_DEVICE_CHUNK
    ctx.conf.set(LBFGS_DEVICE_CHUNK, "0")
    pctx.conf.set("cyclone.ml.lbfgs.deviceChunk", "0")
    try:
        ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y, w))
    finally:
        ctx.conf.remove(LBFGS_DEVICE_CHUNK)
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y, w))
    _assert_same_path(ref, got)


def test_kernel_route_matches_reference_kernel_fit(ctx, pctx):
    """usePallasKernels=true in both packages: the port's plain K1 on the
    CPU against the reference's interpreted Pallas kernel."""
    rng = np.random.RandomState(7)
    x = rng.randn(600, 12)
    y = (x[:, 0] - x[:, 1] > 0).astype(float)
    kw = dict(maxIter=30, regParam=0.01, tol=1e-8)
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    finally:
        ctx.conf.set(JAX_USE_KERNELS, "false")
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    launches = kernels.glm_sweep.launches
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got.intercept, ref.intercept,
                               rtol=5e-3, atol=5e-4)
    # on the CPU the kernel route is the plain version: nothing launched
    assert kernels.glm_sweep.launches == launches


def test_model_from_reference_predicts_the_same(ctx):
    x, y = _data(n=300, d=6, seed=2)
    ref = JaxLR(maxIter=20, regParam=0.01, threshold=0.4).fit(
        JaxDataset.from_numpy(ctx, x, y))
    got = interop.model_from_reference(np.asarray(ref.coefficients),
                                       ref.intercept, threshold=0.4)
    xs = np.random.RandomState(3).randn(50, 6) * 2
    np.testing.assert_array_equal(got._predict_batch(xs),
                                  ref._predict_batch(xs))
    np.testing.assert_allclose(got._raw_prediction(xs),
                               ref._raw_prediction(xs), rtol=1e-15)
    np.testing.assert_allclose(
        got._raw_to_probability(got._raw_prediction(xs)),
        ref._raw_to_probability(ref._raw_prediction(xs)), rtol=1e-15)
    assert got.predict(xs[0]) == ref.predict(xs[0])


def test_optim_state_from_pytree_resumes_the_reference_run(ctx, pctx):
    """A reference optimizer state, carried across as its pytree dict,
    resumes in the port's DeviceLBFGS and ends where an uninterrupted port
    run ends."""
    from cycloneml_tpu_torch.ml.optim.device_lbfgs import DeviceLBFGS
    from cycloneml_tpu_torch.ml.optim.lbfgs import OptimState
    ref = JaxOptimState(x=np.arange(3.0), value=1.5, grad=np.ones(3),
                        iteration=4, loss_history=[3.0, 2.0, 1.5],
                        hist_s=[np.ones(3)], hist_y=[np.full(3, 2.0)])
    got = interop.optim_state_from_pytree(ref.to_pytree())
    assert isinstance(got, OptimState)
    assert (got.iteration, got.value, got.loss_history) == (4, 1.5,
                                                            [3.0, 2.0, 1.5])
    np.testing.assert_array_equal(got.hist_y[0], np.full(3, 2.0))

    # mid-fit hand-over: stop after 3 iterations, resume to 12
    x, y = _data(n=300, d=5, seed=6)
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction
    ds = interop.dataset_from_numpy(x, y)
    f = DistributedLossFunction(ds, aggregators.binary_logistic(5, True))
    full = DeviceLBFGS(max_iter=12, tol=0.0, chunk=4).minimize(f, np.zeros(6))
    head = DeviceLBFGS(max_iter=3, tol=0.0, chunk=4).minimize(f, np.zeros(6))
    pytree = head.to_pytree()
    pytree["hist_s"] = [np.asarray(s) for s in pytree["hist_s"]]
    pytree["hist_y"] = [np.asarray(s) for s in pytree["hist_y"]]
    tail = DeviceLBFGS(max_iter=12, tol=0.0, chunk=4).minimize(
        f, np.zeros(6), resume=interop.optim_state_from_pytree(pytree))
    assert tail.iteration == full.iteration == 12
    np.testing.assert_allclose(tail.loss_history, full.loss_history,
                               rtol=1e-12)
    np.testing.assert_allclose(tail.x, full.x, rtol=1e-10, atol=1e-12)


def test_quickstart_fits_on_the_bf16_tier():
    """The README quickstart's ``fit(MLFrame(...))`` with the card's
    defaults (float32 accumulator, bf16 data tier), here on the CPU."""
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        rng = np.random.RandomState(0)
        x = rng.randn(2000, 20)
        y = (x[:, :3].sum(1) + 0.3 * rng.randn(2000) > 0).astype(float)
        frame = MLFrame(c, {"features": x, "label": y})
        model = LogisticRegression(maxIter=50).fit(frame)
        ds = frame.to_instance_dataset()
        assert str(ds.x.dtype) == "torch.bfloat16"
        assert str(ds.w.dtype) == "torch.float32"
        hist = model.summary.objective_history
        assert np.all(np.isfinite(hist)) and hist[-1] < hist[0]
        acc = (model._predict_batch(x) == y).mean()
        assert acc > 0.9
        out = model.transform(frame)
        assert out["probability"].shape == (2000, 2)
    finally:
        c.stop()
