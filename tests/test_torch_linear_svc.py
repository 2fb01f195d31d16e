"""The port's LinearSVC, its hinge aggregator, the Huber aggregator and
``standardize_dataset`` against the JAX package's, on the same numpy
data.

The aggregators' loss and gradient agree to rtol 1e-12 in float64. The
LinearSVC fits take the same path in float64: equal iteration counts,
objective histories within rtol 1e-10, coefficients within rtol 1e-8 /
atol 1e-10 (the hinge is not smooth, but on these data no row's margin
lands within rounding of the hinge point, so the subgradients agree).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.ml.classification import LinearSVC as JaxSVC
from cycloneml_tpu.ml.optim import aggregators as jagg
from cycloneml_tpu.ml.optim.loss import \
    standardize_dataset as jax_standardize
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LinearSVC
from cycloneml_tpu_torch.ml.optim import aggregators
from cycloneml_tpu_torch.ml.optim.loss import standardize_dataset
from cycloneml_tpu_torch.ml.stat import Summarizer


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _binary(n=300, d=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 2 + 0.3) + rng.randn(d)
    beta = rng.randn(d)
    y = ((x - x.mean(0)) @ beta + 0.8 * rng.randn(n) > 0).astype(np.float64)
    return x, y


def _agg_inputs(n, d, n_coef, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = (rng.rand(n) > 0.5).astype(np.float64)
    w = rng.rand(n) + 0.1
    w[-5:] = 0.0
    return x, y, w, rng.randn(n_coef) * 0.7


@pytest.mark.parametrize("fit_intercept", [True, False])
def test_hinge_matches_reference(fit_intercept):
    d = 6
    x, y, w, coef = _agg_inputs(120, d, d + int(fit_intercept), 1)
    ref = jagg.hinge(d, fit_intercept)(*(jnp.asarray(a)
                                         for a in (x, y, w, coef)))
    got = aggregators.hinge(d, fit_intercept)(*(torch.as_tensor(a)
                                                for a in (x, y, w, coef)))
    for key in ("loss", "grad", "count"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("epsilon", [1.35, 0.5])
def test_huber_matches_reference(fit_intercept, epsilon):
    d = 5
    x, _, w, coef = _agg_inputs(150, d, d + int(fit_intercept) + 1, 2)
    y = x @ np.arange(1.0, d + 1) + np.random.RandomState(3).standard_t(
        2, 150)  # heavy tails: some rows past epsilon
    coef[-1] = 1.3  # sigma > 0
    ref = jagg.huber(d, fit_intercept, epsilon)(
        *(jnp.asarray(a) for a in (x, y, w, coef)))
    got = aggregators.huber(d, fit_intercept, epsilon)(
        *(torch.as_tensor(a) for a in (x, y, w, coef)))
    for key in ("loss", "grad", "count"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("center", [False, True])
def test_standardize_dataset_matches_reference(ctx, pctx, center):
    x, y = _binary(n=90, d=4, seed=4)
    x[:, 2] = 3.0  # a zero-variance column scales to 0
    jds = JaxDataset.from_numpy(ctx, x, y)
    pds = interop.dataset_from_numpy(x, y)
    stats = Summarizer.summarize(pds)
    mean = stats.mean if center else None
    jstd, jinv = jax_standardize(jds, stats.std, mean)
    pstd, pinv = standardize_dataset(pds, stats.std, mean)
    np.testing.assert_array_equal(pinv, jinv)
    np.testing.assert_allclose(pstd.x[:90].numpy(),
                               np.asarray(jstd.x)[jds.valid_indices()],
                               rtol=1e-14, atol=1e-15)
    assert np.all(pstd.x[:, 2].numpy() == 0.0)
    assert pstd.x.dtype == pds.x.dtype
    np.testing.assert_array_equal(pstd.w.numpy(), pds.w.numpy())


def test_standardize_dataset_keeps_the_data_tier():
    """A bf16 X gives a bf16 copy; e4m3 codes are refused (LinearSVC is
    not fp8-capable: its fit dequantizes them first)."""
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu"))
    try:
        x, y = _binary(n=200, d=6, seed=5)
        std = x.std(0)
        out16, _ = standardize_dataset(interop.dataset_from_numpy(
            x, y, ctx=c), std)
        assert out16.x.dtype == torch.bfloat16
        assert np.max(np.abs(out16.x[:200].float().numpy() - x / std)) < 0.05
        ds8 = interop.dataset_from_numpy(x, y, ctx=c,
                                         dtype=torch.float8_e4m3fn)
        with pytest.raises(ValueError, match="dequantize"):
            standardize_dataset(ds8, std)
        model = LinearSVC(maxIter=10).fit(ds8)
        assert np.all(np.isfinite(model.coefficients.values))
        assert c.precision_fallbacks[-1]["to_dtype"] == "bfloat16"
    finally:
        c.stop()


def _assert_same_svc(ref, got):
    assert len(got.objective_history) == len(ref.objective_history)
    np.testing.assert_allclose(got.objective_history, ref.objective_history,
                               rtol=1e-10)
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("kw", [
    dict(regParam=0.01), dict(regParam=0.1, fitIntercept=False),
    dict(regParam=0.05, standardization=False), dict(regParam=0.0),
], ids=["l2", "no-intercept", "unstandardized", "unregularized"])
def test_f64_fit_matches_reference(ctx, pctx, kw):
    x, y = _binary()
    kw = dict(maxIter=50, tol=1e-9, **kw)
    ref = JaxSVC(**kw).fit(JaxDataset.from_numpy(ctx, x, y))
    got = LinearSVC(**kw).fit(interop.dataset_from_numpy(x, y))
    _assert_same_svc(ref, got)


def test_f64_weighted_frame_fit_matches_reference(ctx, pctx):
    x, y = _binary(n=250, d=4, seed=6)
    w = np.random.RandomState(7).rand(250) + 0.3
    cols = {"features": x, "label": y, "w": w}
    kw = dict(maxIter=40, tol=1e-9, regParam=0.02, weightCol="w")
    ref = JaxSVC(**kw).fit(JaxFrame(ctx, dict(cols)))
    got = LinearSVC(**kw).fit(MLFrame(pctx, dict(cols)))
    _assert_same_svc(ref, got)


def test_labels_outside_zero_one_are_refused(pctx):
    x, y = _binary(n=40, d=3)
    with pytest.raises(ValueError, match=r"labels in \{0, 1\}"):
        LinearSVC().fit(interop.dataset_from_numpy(x, 2.0 * y - 1.0))


def test_model_from_reference_transforms_the_same(ctx, pctx):
    x, y = _binary(n=200, d=5, seed=8)
    ref = JaxSVC(maxIter=30, regParam=0.01, threshold=0.3).fit(
        JaxDataset.from_numpy(ctx, x, y))
    got = interop.svc_model_from_reference(np.asarray(ref.coefficients),
                                           ref.intercept, threshold=0.3)
    xs = np.random.RandomState(9).randn(60, 5) * 2
    jout = ref.transform(JaxFrame(ctx, {"features": xs}))
    pout = got.transform(MLFrame(pctx, {"features": xs}))
    np.testing.assert_allclose(pout["rawPrediction"],
                               np.asarray(jout["rawPrediction"]),
                               rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(pout["prediction"],
                                  np.asarray(jout["prediction"]))
