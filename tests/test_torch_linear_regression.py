"""The port's LinearRegression (L-BFGS and OWL-QN) against the JAX
package's, on the same numpy data.

In float64 (``cyclone.compute.dtype=float64``, the counterpart of the
reference's x64 test configuration) both fits take the same path: equal
iteration counts, objective histories and coefficients within rtol 1e-8
(the two sum in different orders, so agreement is to rounding, not
bitwise). With the kernel route on (``usePallasKernels=true``: the port's
plain K2 on the CPU, the reference's Pallas kernel interpreted) both sweeps
sum in float32, and the models agree within the reference's own
kernel-vs-plain bound (rtol 5e-3, atol 5e-4, tests/test_pallas_ops.py).
"""

import numpy as np
import pytest

from cycloneml_tpu.conf import USE_PALLAS_KERNELS as JAX_USE_KERNELS
from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.ml.optim.lbfgs import OWLQN as JaxOWLQN
from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.regression import LinearRegression
from cycloneml_tpu_torch.ops import kernels


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _data(n=400, d=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 3 + 0.2) + rng.randn(d)
    beta = rng.randn(d) * (rng.rand(d) > 0.3)
    y = x @ beta + 0.5 * rng.randn(n) + 2.0
    return x, y


def _assert_same_fit(ref, got, rtol=1e-8):
    assert got.summary.total_iterations == ref.summary.total_iterations
    np.testing.assert_allclose(got.summary.objective_history,
                               ref.summary.objective_history, rtol=rtol)
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=rtol,
                               atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=rtol,
                               atol=1e-10)


@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_f64_fit_matches_reference(ctx, pctx, alpha, standardization):
    """L-BFGS (alpha=0) and OWL-QN (alpha=0.5), with the penalty in the
    standardized or the original feature space."""
    x, y = _data()
    kw = dict(solver="l-bfgs", regParam=0.05, elasticNetParam=alpha,
              standardization=standardization, maxIter=60, tol=1e-10)
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_fit(ref, got)
    if alpha > 0:  # the L1 part zeroes coordinates, the same ones
        np.testing.assert_array_equal(got.coefficients.values == 0,
                                      np.asarray(ref.coefficients) == 0)


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_f64_weighted_fit_without_intercept_matches_reference(ctx, pctx,
                                                              alpha):
    x, y = _data(n=300, d=7, seed=3)
    w = np.random.RandomState(4).rand(len(y)) + 0.2
    kw = dict(solver="l-bfgs", regParam=0.02, elasticNetParam=alpha,
              fitIntercept=False, maxIter=60, tol=1e-10)
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y, w))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y, w))
    _assert_same_fit(ref, got)
    assert got.intercept == 0.0


@pytest.mark.parametrize("fit_intercept,value", [(True, 3.5), (False, 0.0),
                                                 (False, -2.0)])
def test_f64_constant_label_matches_reference(ctx, pctx, fit_intercept,
                                              value):
    """A constant label: zero coefficients and the mean as intercept, or,
    without an intercept and a nonzero constant, the unscaled solve."""
    x, _ = _data(n=200, d=5, seed=5)
    y = np.full(200, value)
    kw = dict(solver="l-bfgs", fitIntercept=fit_intercept, maxIter=50,
              tol=1e-10)
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_fit(ref, got)


def test_constant_label_refuses_regularization_without_intercept(pctx):
    x, _ = _data(n=100, d=4, seed=6)
    with pytest.raises(ValueError, match="standard deviation of the label"):
        LinearRegression(solver="l-bfgs", fitIntercept=False,
                         regParam=0.1).fit(
            interop.dataset_from_numpy(x, np.full(100, 2.0)))


@pytest.mark.parametrize("kw", [dict(solver="normal"), dict(solver="auto"),
                                dict(solver="auto", regParam=0.1,
                                     elasticNetParam=0.0)])
def test_normal_solver_is_not_ported(pctx, kw):
    x, y = _data(n=50, d=3)
    with pytest.raises(NotImplementedError, match="ROADMAP slice 2"):
        LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))


def test_auto_with_an_l1_part_takes_owlqn(ctx, pctx):
    """solver='auto' with alpha*reg > 0 resolves to the quasi-Newton path,
    as in the reference."""
    x, y = _data(n=300, d=6, seed=8)
    kw = dict(regParam=0.1, elasticNetParam=0.3, maxIter=60, tol=1e-10)
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_fit(ref, got)


def test_kernel_route_matches_reference_kernel_fit(ctx, pctx):
    """usePallasKernels=true in both packages: the port's plain K2 on the
    CPU against the reference's interpreted Pallas kernel."""
    x, y = _data(n=512, d=12, seed=9)
    kw = dict(solver="l-bfgs", regParam=0.01, elasticNetParam=0.5,
              maxIter=40, tol=1e-8)
    ctx.conf.set(JAX_USE_KERNELS, "true")
    try:
        ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    finally:
        ctx.conf.set(JAX_USE_KERNELS, "false")
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    launches = kernels.glm_sweep.launches
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(got.intercept, ref.intercept,
                               rtol=5e-3, atol=5e-4)
    # on the CPU the kernel route is the plain version: nothing launched
    assert kernels.glm_sweep.launches == launches
    assert got.summary.total_evals > got.summary.total_iterations


def test_model_from_reference_predicts_and_evaluates_the_same(ctx, pctx):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    x, y = _data(n=200, d=6, seed=2)
    ref = JaxLinReg(solver="l-bfgs", regParam=0.01).fit(
        JaxDataset.from_numpy(ctx, x, y))
    got = interop.linear_model_from_reference(np.asarray(ref.coefficients),
                                              ref.intercept)
    xs = np.random.RandomState(3).randn(40, 6) * 2
    np.testing.assert_allclose(got._predict_batch(xs),
                               ref._predict_batch(xs), rtol=1e-14)
    assert got.predict(xs[0]) == pytest.approx(ref.predict(xs[0]),
                                               rel=1e-14)
    cols = {"features": x, "label": y}
    got_m = got.evaluate(MLFrame(pctx, cols))
    ref_m = ref.evaluate(JaxFrame(ctx, cols))
    for k in ("rmse", "mse", "mae", "r2"):
        assert got_m[k] == pytest.approx(ref_m[k], rel=1e-12)
    out = got.transform(MLFrame(pctx, cols))
    np.testing.assert_allclose(out["prediction"], got._predict_batch(x))


def test_owlqn_state_from_the_reference_resumes_exactly(ctx, pctx):
    """A reference OWL-QN state (with its raw gradient), carried across as
    its pytree dict, resumes in the port's OWLQN and ends where an
    uninterrupted run of the port ends."""
    from cycloneml_tpu.ml.optim import aggregators as jagg
    from cycloneml_tpu.ml.optim.loss import (
        DistributedLossFunction as JaxLoss)
    from cycloneml_tpu_torch.ml.optim import aggregators
    from cycloneml_tpu_torch.ml.optim.lbfgs import OWLQN
    from cycloneml_tpu_torch.ml.optim.loss import DistributedLossFunction
    x, y = _data(n=256, d=5, seed=7)
    l1 = np.full(6, 0.05)
    l1[5] = 0.0  # no penalty on the intercept
    jf = JaxLoss(JaxDataset.from_numpy(ctx, x, y), jagg.least_squares(5))
    head = JaxOWLQN(max_iter=4, tol=0.0, l1_reg=l1).minimize(jf, np.zeros(6))
    assert head.raw_grad is not None
    state = interop.optim_state_from_pytree(head.to_pytree())
    np.testing.assert_array_equal(state.raw_grad, head.raw_grad)
    f = DistributedLossFunction(interop.dataset_from_numpy(x, y),
                                aggregators.least_squares(5))
    full = OWLQN(max_iter=15, tol=0.0, l1_reg=l1).minimize(f, np.zeros(6))
    tail = OWLQN(max_iter=15, tol=0.0, l1_reg=l1).minimize(
        f, np.zeros(6), resume=state)
    assert tail.iteration == full.iteration == 15
    np.testing.assert_allclose(tail.loss_history, full.loss_history,
                               rtol=1e-10)
    np.testing.assert_allclose(tail.x, full.x, rtol=1e-8, atol=1e-12)
