"""The port's GeneralizedLinearRegression against the JAX package's, on the
same numpy data.

Every family-link pair the reference supports (and tests/test_regression2
.py's tweedie configurations), with offsets and weights, in float64
(``cyclone.compute.dtype=float64``): the same number of IRLS iterations,
coefficients and intercept within rtol 1e-8 / atol 1e-10, the summary's
deviances, dispersion, AIC, standard errors, t- and p-values within rtol
1e-8 (p-values also atol 1e-12: they may underflow toward 0), and all four
residual types within rtol 1e-8 / atol 1e-10. Models carried across by
``interop`` transform identically.
"""

import numpy as np
import pytest

from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.ml.regression import \
    GeneralizedLinearRegression as JaxGLR
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.regression import GeneralizedLinearRegression


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _labels(family, link, seed, n=300, d=4):
    """Features and a label drawn from the family through the link's
    inverse, at coefficients that keep the mean inside its domain."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * 0.5
    beta = np.array([0.5, -0.3, 0.2, 0.1])[:d]
    eta = x @ beta
    if family == "binomial":
        p = {"logit": lambda e: 1 / (1 + np.exp(-e)),
             "probit": lambda e: 0.5 * (1 + np.tanh(0.8 * e)),
             "cloglog": lambda e: 1 - np.exp(-np.exp(e - 0.4))}[link](eta)
        return x, (rng.rand(n) < p).astype(float)
    mean = {"identity": 3.0 + eta, "log": np.exp(eta + 0.3),
            "inverse": 1.0 / (1.5 + 0.3 * eta), "sqrt": (1.7 + eta) ** 2,
            }[link]
    if family == "gaussian":
        return x, mean + 0.2 * rng.randn(n)
    if family == "poisson":
        return x, rng.poisson(mean).astype(float)
    # gamma, shape 10: at shape 2 an identity-link IRLS step can drive mu
    # below 0, where the clamped mu gives rows weights near 1e16 and the
    # normal system's solution is decided by rounding (in either package)
    return x, rng.gamma(10.0, mean / 10.0)


_PAIRS = [("gaussian", "identity"), ("gaussian", "log"),
          ("gaussian", "inverse"), ("binomial", "logit"),
          ("binomial", "probit"), ("binomial", "cloglog"),
          ("poisson", "log"), ("poisson", "identity"), ("poisson", "sqrt"),
          ("gamma", "inverse"), ("gamma", "identity"), ("gamma", "log")]


def _fit_both(ctx, pctx, cols, **kw):
    ref = JaxGLR(**kw).fit(JaxFrame(ctx, dict(cols)))
    got = GeneralizedLinearRegression(**kw).fit(MLFrame(pctx, dict(cols)))
    return ref, got


def _assert_same_fit(ref, got):
    rs, gs = ref.summary, got.summary
    assert gs.num_iterations == rs.num_iterations
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=1e-8,
                               atol=1e-10)
    for name in ("deviance", "null_deviance", "dispersion", "aic",
                 "coefficient_standard_errors", "t_values"):
        np.testing.assert_allclose(getattr(gs, name), getattr(rs, name),
                                   rtol=1e-8, err_msg=name)
    np.testing.assert_allclose(gs.p_values, rs.p_values, rtol=1e-8,
                               atol=1e-12)
    for attr in ("rank", "degrees_of_freedom",
                 "residual_degree_of_freedom", "family", "link"):
        assert getattr(gs, attr) == getattr(rs, attr), attr
    for kind in ("response", "working", "pearson", "deviance"):
        np.testing.assert_allclose(gs.residuals(kind), rs.residuals(kind),
                                   rtol=1e-8, atol=1e-10, err_msg=kind)


@pytest.mark.parametrize("family,link", _PAIRS,
                         ids=[f"{f}-{l}" for f, l in _PAIRS])
def test_family_link_pairs_match_reference(ctx, pctx, family, link):
    x, y = _labels(family, link, seed=len(family) * 7 + len(link))
    ref, got = _fit_both(ctx, pctx, {"features": x, "label": y},
                         family=family, link=link, maxIter=50, tol=1e-10)
    _assert_same_fit(ref, got)


@pytest.mark.parametrize("kw", [
    dict(variancePower=1.5, linkPower=0.0, maxIter=100, tol=1e-10),
    dict(variancePower=1.5),
    dict(variancePower=2.5, linkPower=-0.5, maxIter=60),
    dict(variancePower=1.2, linkPower=1.0, maxIter=60),
], ids=["p1.5-log", "p1.5-canonical", "p2.5-power", "p1.2-identity"])
def test_tweedie_matches_reference(ctx, pctx, kw):
    rng = np.random.RandomState(4)
    x = rng.randn(300, 4) * 0.5
    mean = np.exp(x @ np.array([0.5, -0.3, 0.2, 0.1]) + 0.5)
    y = rng.gamma(2.0, mean / 2.0)
    if kw["variancePower"] < 2:
        y = y * (rng.rand(300) > 0.2)  # exact zeros: compound Poisson
    ref, got = _fit_both(ctx, pctx, {"features": x, "label": y},
                         family="tweedie", **kw)
    _assert_same_fit(ref, got)


@pytest.mark.parametrize("fit_intercept,reg", [(True, 0.05), (True, 0.0),
                                               (False, 0.0)])
def test_offset_weights_and_l2_match_reference(ctx, pctx, fit_intercept,
                                               reg):
    """Offsets, weights and the L2 step. (The reference's L2 step without
    an intercept writes into a read-only array and raises, so that case
    is not compared.)"""
    x, y = _labels("poisson", "log", seed=5)
    rng = np.random.RandomState(6)
    cols = {"features": x, "label": y, "off": rng.rand(len(y)) * 0.5,
            "w": rng.randint(1, 4, len(y)).astype(float)}
    ref, got = _fit_both(ctx, pctx, cols, family="poisson", offsetCol="off",
                         weightCol="w", regParam=reg,
                         fitIntercept=fit_intercept, maxIter=50, tol=1e-10)
    _assert_same_fit(ref, got)


def test_l2_without_intercept_shrinks_the_fit(pctx):
    """The port's L2 step without an intercept: the same penalty on the
    diagonal, so the coefficients shrink toward 0 as regParam grows."""
    x, y = _labels("poisson", "log", seed=5)
    norms = []
    for reg in (0.0, 0.5, 5.0):
        m = GeneralizedLinearRegression(
            family="poisson", fitIntercept=False, regParam=reg).fit(
            MLFrame(pctx, {"features": x, "label": y}))
        norms.append(float(np.linalg.norm(m.coefficients.values)))
    assert norms[0] > norms[1] > norms[2] > 0


def test_weights_equal_row_replication(pctx):
    """Integer weights fit as replicated rows (the defining property of a
    weighted GLM; the reference's test_glm_weights)."""
    x, y = _labels("poisson", "log", seed=7, n=120)
    w = np.random.RandomState(8).randint(1, 4, len(y)).astype(float)
    rep = np.repeat(np.arange(len(y)), w.astype(int))
    glr = GeneralizedLinearRegression(family="poisson")
    mw = GeneralizedLinearRegression(family="poisson", weightCol="w").fit(
        MLFrame(pctx, {"features": x, "label": y, "w": w}))
    mr = glr.fit(MLFrame(pctx, {"features": x[rep], "label": y[rep]}))
    np.testing.assert_allclose(mw.coefficients.values, mr.coefficients.values,
                               atol=1e-7)


def test_offset_transform_and_residuals(ctx, pctx):
    """The reference's test_glm_offset_transform_and_residuals: transform
    adds the offset to eta, and the squared deviance residuals sum to the
    deviance; then a model carried across by interop transforms as the
    reference's does."""
    x, y = _labels("poisson", "log", seed=8)
    offset = np.full(len(y), 0.5)
    cols = {"features": x, "label": y, "off": offset}
    kw = dict(family="poisson", offsetCol="off", linkPredictionCol="eta")
    ref, got = _fit_both(ctx, pctx, cols, **kw)
    out = got.transform(MLFrame(pctx, dict(cols)))
    eta = x @ got.coefficients.values + got.intercept + offset
    np.testing.assert_allclose(out["prediction"], np.exp(eta), rtol=1e-10)
    np.testing.assert_allclose(out["eta"], eta, rtol=1e-10)
    np.testing.assert_allclose(
        (got.summary.residuals("deviance") ** 2).sum(),
        got.summary.deviance, rtol=1e-8)
    carried = interop.glm_model_from_reference(
        np.asarray(ref.coefficients), ref.intercept, **kw)
    xs = np.random.RandomState(9).randn(40, 4)
    new = {"features": xs, "off": np.linspace(0, 1, 40)}
    jout = ref.transform(JaxFrame(ctx, dict(new)))
    pout = carried.transform(MLFrame(pctx, dict(new)))
    for col in ("prediction", "eta"):
        np.testing.assert_allclose(pout[col], np.asarray(jout[col]),
                                   rtol=1e-14)
    np.testing.assert_allclose(carried.predict_link(xs),
                               ref.predict_link(xs), rtol=1e-14)
    probit = interop.glm_model_from_reference([0.3, -0.2, 0.1, 0.0], 0.1,
                                              family="binomial",
                                              link="probit")
    jprobit = JaxGLR(family="binomial", link="probit")
    from cycloneml_tpu.ml.regression.glm import \
        GeneralizedLinearRegressionModel as JaxModel
    jm = JaxModel(np.array([0.3, -0.2, 0.1, 0.0]), 0.1)
    jprobit._copy_values(jm)
    np.testing.assert_allclose(probit._predict_batch(xs),
                               jm._predict_batch(xs), rtol=1e-14)


@pytest.mark.parametrize("kw,y,match", [
    (dict(family="tweedie", variancePower=-1.0), [1.0, 2.0, 3.0],
     "variancePower"),
    (dict(family="tweedie", variancePower=2.5, maxIter=5), [0.0, 1.0, 2.0],
     "positive"),
    (dict(family="tweedie", variancePower=1.5, maxIter=5), [-1.0, 1.0, 2.0],
     "non-negative"),
    (dict(family="poisson", link="logit"), [1.0, 2.0, 3.0], "unsupported"),
    (dict(family="tweedie", variancePower=1.5, link="log"), [1.0, 2.0, 3.0],
     "linkPower"),
])
def test_refusals(pctx, kw, y, match):
    frame = MLFrame(pctx, {"features": np.array([[1.0], [2.0], [3.0]]),
                           "label": np.array(y)})
    with pytest.raises(ValueError, match=match):
        GeneralizedLinearRegression(**kw).fit(frame)
