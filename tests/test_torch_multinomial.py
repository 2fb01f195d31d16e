"""The port's multinomial LogisticRegression and its aggregators against
the JAX package's, on the same numpy data.

In float64 (``cyclone.compute.dtype=float64``) both fits take the same
path: equal iteration and evaluation counts, objective histories within
rtol 1e-10, coefficient matrices and intercept vectors within rtol 1e-8 /
atol 1e-10 (the two sum in different orders, so agreement is to
rounding). The aggregators' loss and gradient agree to rtol 1e-12. The
multinomial aggregator follows the reference's kernel route on a narrow X
(the coefficients at full width, X widened a chunk of rows at a time,
``aggregators._tier_dot``); in float64 the two routes are the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
from cycloneml_tpu.ml.optim import aggregators as jagg
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression
from cycloneml_tpu_torch.ml.optim import aggregators


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _data(n=400, d=5, k=3, seed=23):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 2 + 0.3) + rng.randn(d)
    wt = rng.randn(k, d)
    y = np.argmax((x - x.mean(0)) @ wt.T + 0.5 * rng.randn(n, k),
                  axis=1).astype(np.float64)
    return x, y


def _assert_same_path(ref, got):
    rs, gs = ref.summary, got.summary
    assert gs.total_iterations == rs.total_iterations
    assert gs.total_evals == rs.total_evals
    np.testing.assert_allclose(gs.objective_history, rs.objective_history,
                               rtol=1e-10)
    np.testing.assert_allclose(got.coefficient_matrix.to_array(),
                               ref.coefficient_matrix.to_array(),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.intercept_vector.values,
                               np.asarray(ref.intercept_vector),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_aggregator_matches_reference(scaled, fit_intercept):
    rng = np.random.RandomState(1)
    n, d, k = 90, 6, 4
    x = rng.randn(n, d)
    y = rng.randint(0, k, n).astype(np.float64)
    w = rng.rand(n) + 0.1
    w[-7:] = 0.0  # padding rows
    coef = rng.randn(d * k + (k if fit_intercept else 0)) * 0.5
    inv_std, mu = rng.rand(d) + 0.5, rng.randn(d) * 0.3
    if scaled:
        ref = jagg.multinomial_logistic_scaled(d, k, fit_intercept)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(inv_std), jnp.asarray(mu), jnp.asarray(coef))
        got = aggregators.multinomial_logistic_scaled(d, k, fit_intercept)(
            *(torch.as_tensor(a) for a in (x, y, w, inv_std, mu, coef)))
    else:
        ref = jagg.multinomial_logistic(d, k, fit_intercept)(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(coef))
        got = aggregators.multinomial_logistic(d, k, fit_intercept)(
            *(torch.as_tensor(a) for a in (x, y, w, coef)))
    for key in ("loss", "grad", "count"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-12, atol=1e-13)


def test_aggregator_on_bf16_x_follows_the_kernel_route():
    """On a bf16 X the coefficients stay at full width: the result is the
    float64 aggregation over the bf16 values, exactly."""
    rng = np.random.RandomState(2)
    n, d, k = 200, 7, 3
    x16 = torch.as_tensor(rng.randn(n, d)).to(torch.bfloat16)
    y = torch.as_tensor(rng.randint(0, k, n).astype(np.float64))
    w = torch.ones(n, dtype=torch.float64)
    coef = torch.as_tensor(rng.randn(d * k + k))
    agg = aggregators.multinomial_logistic(d, k, True)
    got = agg(x16, y, w, coef)
    wide = agg(x16.double(), y, w, coef)
    for key in ("loss", "grad"):
        np.testing.assert_allclose(got[key].numpy(), wide[key].numpy(),
                                   rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("kw", [
    dict(regParam=0.01),
    dict(regParam=0.0),
    dict(regParam=0.02, fitIntercept=False),
    dict(regParam=0.05, standardization=False),
    dict(regParam=0.05, elasticNetParam=0.5),
    dict(regParam=0.03, elasticNetParam=1.0, standardization=False),
], ids=["l2", "unregularized", "no-intercept", "unstandardized",
        "elastic-net", "lasso-unstandardized"])
def test_f64_fit_matches_reference(ctx, pctx, kw):
    """Device L-BFGS (L2), OWL-QN (an L1 part), the centered coefficients
    of an unregularized fit and the original-space penalties."""
    x, y = _data()
    kw = dict(maxIter=60, tol=1e-9, **kw)
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_path(ref, got)
    assert got.num_classes == ref.num_classes == 3


def test_f64_weighted_host_lbfgs_fit_matches_reference(ctx, pctx):
    """Weights, four classes, and the host L-BFGS (deviceChunk=0)."""
    x, y = _data(n=300, d=4, k=4, seed=5)
    w = np.random.RandomState(6).rand(len(y)) + 0.2
    key = "cyclone.ml.lbfgs.deviceChunk"
    pctx.conf.set(key, "0")
    kw = dict(maxIter=50, tol=1e-9, regParam=0.01)
    ctx.conf.set(key, "0")
    try:
        ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y, w))
    finally:
        ctx.conf.remove(key)
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y, w))
    _assert_same_path(ref, got)


def test_binomial_family_on_two_classes_and_multinomial_forced(ctx, pctx):
    """family='multinomial' on a binary label: two full coefficient rows,
    as the reference fits them."""
    x, y = _data(n=200, d=3, k=2, seed=8)
    kw = dict(maxIter=40, tol=1e-9, regParam=0.01, family="multinomial")
    ref = JaxLR(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LogisticRegression(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_path(ref, got)
    assert got.coefficient_matrix.to_array().shape == (2, 3)
    with pytest.raises(ValueError, match="coefficient_matrix"):
        got.coefficients


def test_binomial_family_refuses_three_classes(pctx):
    x, y = _data(n=60, d=3, k=3, seed=9)
    with pytest.raises(ValueError, match="Binomial family"):
        LogisticRegression(family="binomial").fit(
            interop.dataset_from_numpy(x, y))


def test_f64_multinomial_bounds_match_reference(ctx, pctx):
    """The reference's test_lr_multinomial_bounds configuration: all
    coefficients bounded below by 0, L-BFGS-B, no centering."""
    rng = np.random.RandomState(23)
    n, d, k = 400, 4, 3
    x = rng.randn(n, d)
    wt = rng.randn(k, d)
    y = np.argmax(x @ wt.T + 0.2 * rng.randn(n, k), axis=1).astype(float)
    kw = dict(maxIter=100, regParam=0.01, tol=1e-9,
              lowerBoundsOnCoefficients=np.zeros((k, d)))
    ref = JaxLR(**kw).fit(JaxFrame(ctx, {"features": x, "label": y}))
    got = LogisticRegression(**kw).fit(
        MLFrame(pctx, {"features": x, "label": y}))
    _assert_same_path(ref, got)
    assert np.all(got.coefficient_matrix.to_array() >= 0.0)


def test_multinomial_bounds_refuse_a_transposed_matrix(pctx):
    x, y = _data(n=60, d=4, k=3, seed=10)
    with pytest.raises(ValueError, match=r"shape \(3, 4\)"):
        LogisticRegression(lowerBoundsOnCoefficients=np.zeros((4, 3))).fit(
            interop.dataset_from_numpy(x, y))


def test_model_from_reference_transforms_the_same(ctx, pctx):
    x, y = _data(n=300, d=5, k=4, seed=11)
    ref = JaxLR(maxIter=30, regParam=0.01).fit(
        JaxDataset.from_numpy(ctx, x, y))
    got = interop.multinomial_model_from_reference(
        ref.coefficient_matrix.to_array(), np.asarray(ref.intercept_vector))
    xs = np.random.RandomState(12).randn(40, 5) * 2
    jout = ref.transform(JaxFrame(ctx, {"features": xs}))
    pout = got.transform(MLFrame(pctx, {"features": xs}))
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(pout[col], np.asarray(jout[col]),
                                   rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(pout["prediction"],
                                  np.asarray(jout["prediction"]))
    assert got.predict(xs[0]) == ref.predict(xs[0])
