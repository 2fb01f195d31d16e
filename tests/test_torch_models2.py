"""The rest of MLlib's models in the port — NaiveBayes, the factorization
machines, the multilayer perceptron, AFT survival regression and isotonic
regression — against the JAX package's, on the same seeded numpy inputs.

- The reference's ``TestNaiveBayes``, ``TestFM`` and ``TestMLP``
  (tests/test_classification2.py) and its AFT and isotonic cases
  (tests/test_regression2.py) run on the port (``cyclone.master=cpu``,
  ``cyclone.compute.dtype=float64``); those that call sklearn or scipy
  import them with ``pytest.importorskip``.
- Parity in float64, rtol 1e-8 with the same iteration counts: the MLP
  (L-BFGS and GD), AFT, NaiveBayes (all four model types) and FM (adamW
  and gd) at ``miniBatchFraction=1.0``, where both packages take every
  row; isotonic regression exactly. The sums differ only in their order
  (the port's row chunks against the reference's mesh shards).
- FM below ``miniBatchFraction=1.0`` draws the port's own mask bits (a
  generator seeded by a SplitMix64 mix of (seed, step)): one seed replays.
- The reference's chunked (interleaved padding) dataset case
  (tests/test_oocore.py:550) for the MLP.
- Each model family carried across by ``interop``, and models the
  reference saved loading in the port, predict as the reference does.

These models add no kernel: their products are plain ``torch.matmul``s
and their gradients ``torch.autograd``'s, on the context's device.
"""

import types

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import (
    FMClassificationModel, FMClassifier,
    MultilayerPerceptronClassificationModel, MultilayerPerceptronClassifier,
    NaiveBayes, NaiveBayesModel,
)
from cycloneml_tpu_torch.ml.regression import (
    AFTSurvivalRegression, AFTSurvivalRegressionModel, FMRegressor,
    IsotonicRegression, IsotonicRegressionModel,
)

RTOL = 1e-8


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ref():
    import cycloneml_tpu.ml.classification as rc
    import cycloneml_tpu.ml.regression as rr
    from cycloneml_tpu.dataset.frame import MLFrame as RFrame
    names = {n: getattr(rc, n) for n in rc.__all__}
    names.update({n: getattr(rr, n) for n in rr.__all__})
    return types.SimpleNamespace(MLFrame=RFrame, **names)


def _both(ctx, pctx, name, cols, **kw):
    """(port model, reference model) of estimator ``name`` fitted on the
    same columns."""
    r = _ref()
    ref = getattr(r, name)(**kw).fit(r.MLFrame(ctx, dict(cols)))
    import cycloneml_tpu_torch.ml.classification as pc
    import cycloneml_tpu_torch.ml.regression as pr
    est = getattr(pc, name, None) or getattr(pr, name)
    return est(**kw).fit(MLFrame(pctx, dict(cols))), ref


# -- NaiveBayes ---------------------------------------------------------------

def _counts(ctx, n=400, d=12, k=3, seed=7):
    rng = np.random.RandomState(seed)
    profiles = rng.dirichlet(np.ones(d) * 0.4, size=k)
    y = rng.randint(0, k, n).astype(np.float64)
    x = np.stack([rng.multinomial(40, profiles[int(c)]) for c in y]) \
        .astype(np.float64)
    return MLFrame(ctx, {"features": x, "label": y}), x, y


class TestNaiveBayes:
    def test_multinomial_matches_sklearn(self, pctx):
        sk_nb = pytest.importorskip("sklearn.naive_bayes")
        frame, x, y = _counts(pctx)
        ours = NaiveBayes(smoothing=1.0).fit(frame)
        sk = sk_nb.MultinomialNB(alpha=1.0).fit(x, y)
        counts = np.array([(y == c).sum() for c in range(3)], float)
        expect_pi = np.log(counts + 1.0) - np.log(counts.sum() + 3.0)
        np.testing.assert_allclose(ours.pi, expect_pi, atol=1e-9)
        np.testing.assert_allclose(ours.theta.to_array(),
                                   sk.feature_log_prob_, atol=1e-9)
        pred = ours.transform(frame)["prediction"]
        assert (pred == sk.predict(x)).mean() > 0.98

    def test_bernoulli_matches_sklearn(self, pctx):
        sk_nb = pytest.importorskip("sklearn.naive_bayes")
        rng = np.random.RandomState(8)
        x = (rng.rand(300, 10) < 0.3).astype(np.float64)
        y = rng.randint(0, 2, 300).astype(np.float64)
        frame = MLFrame(pctx, {"features": x, "label": y})
        ours = NaiveBayes(modelType="bernoulli", smoothing=1.0).fit(frame)
        sk = sk_nb.BernoulliNB(alpha=1.0).fit(x, y)
        np.testing.assert_allclose(ours.theta.to_array(),
                                   sk.feature_log_prob_, atol=1e-9)
        np.testing.assert_array_equal(
            ours.transform(frame)["prediction"], sk.predict(x))

    def test_gaussian_matches_sklearn(self, pctx):
        sk_nb = pytest.importorskip("sklearn.naive_bayes")
        rng = np.random.RandomState(9)
        x = np.concatenate([rng.randn(100, 4) - 1, rng.randn(100, 4) + 1])
        y = np.concatenate([np.zeros(100), np.ones(100)])
        frame = MLFrame(pctx, {"features": x, "label": y})
        ours = NaiveBayes(modelType="gaussian").fit(frame)
        sk = sk_nb.GaussianNB().fit(x, y)
        agree = (ours.transform(frame)["prediction"] == sk.predict(x)).mean()
        assert agree > 0.99

    def test_complement_mode(self, pctx):
        sk_nb = pytest.importorskip("sklearn.naive_bayes")
        frame, x, y = _counts(pctx, seed=10)
        ours = NaiveBayes(modelType="complement", smoothing=1.0).fit(frame)
        sk = sk_nb.ComplementNB(alpha=1.0, norm=False).fit(x, y)
        agree = (ours.transform(frame)["prediction"] == sk.predict(x)).mean()
        assert agree > 0.95

    def test_rejects_negative_features(self, pctx):
        frame = MLFrame(pctx, {"features": np.array([[1.0, -1.0]]),
                               "label": np.array([0.0])})
        with pytest.raises(ValueError, match="nonnegative"):
            NaiveBayes().fit(frame)

    def test_bernoulli_rejects_values_outside_zero_one(self, pctx):
        frame = MLFrame(pctx, {"features": np.array([[1.0, 2.0]]),
                               "label": np.array([0.0])})
        with pytest.raises(ValueError, match="zero-or-one"):
            NaiveBayes(modelType="bernoulli").fit(frame)

    def test_persistence(self, pctx, tmp_path):
        frame, x, y = _counts(pctx, seed=11)
        m = NaiveBayes().fit(frame)
        p = str(tmp_path / "nb")
        m.save(p)
        m2 = NaiveBayesModel.load(p)
        np.testing.assert_allclose(m2.theta.to_array(), m.theta.to_array())


@pytest.mark.parametrize("model_type", ["multinomial", "bernoulli",
                                        "complement", "gaussian"])
def test_naive_bayes_matches_reference(ctx, pctx, model_type):
    if model_type == "bernoulli":
        rng = np.random.RandomState(8)
        x = (rng.rand(300, 10) < 0.3).astype(np.float64)
        y = rng.randint(0, 3, 300).astype(np.float64)
    elif model_type == "gaussian":
        rng = np.random.RandomState(9)
        x = np.concatenate([rng.randn(100, 4) - 1, rng.randn(100, 4) + 1])
        y = np.concatenate([np.zeros(100), np.ones(100)])
    else:
        _, x, y = _counts(pctx)
    w = np.random.RandomState(1).uniform(0.5, 2.0, len(y))
    got, ref = _both(ctx, pctx, "NaiveBayes",
                     {"features": x, "label": y, "w": w},
                     modelType=model_type, smoothing=0.5, weightCol="w")
    np.testing.assert_allclose(got.pi, np.asarray(ref.pi), rtol=RTOL)
    np.testing.assert_allclose(got.theta.to_array(),
                               ref.theta.to_array(), rtol=RTOL)
    np.testing.assert_allclose(got._sigma, np.asarray(ref._sigma), rtol=RTOL)
    np.testing.assert_allclose(
        got.transform(MLFrame(pctx, {"features": x}))["probability"],
        np.asarray(ref.transform(_ref().MLFrame(ctx, {"features": x}))
                   ["probability"]), rtol=RTOL, atol=1e-12)


# -- FM -----------------------------------------------------------------------

class TestFM:
    def test_classifier_learns_xor_interaction(self, pctx):
        rng = np.random.RandomState(12)
        x = rng.choice([-1.0, 1.0], size=(600, 2))
        y = (x[:, 0] * x[:, 1] > 0).astype(np.float64)
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = FMClassifier(factorSize=4, maxIter=200, stepSize=0.1,
                         seed=5).fit(frame)
        acc = (m.transform(frame)["prediction"] == y).mean()
        assert acc > 0.95
        prob = m.transform(frame)["probability"]
        assert np.all(np.isclose(prob.sum(1), 1.0))

    def test_regressor_fits_quadratic(self, pctx):
        rng = np.random.RandomState(13)
        x = rng.randn(500, 3)
        y = 2.0 + x @ np.array([1.0, -2.0, 0.5]) + 1.5 * x[:, 0] * x[:, 1]
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = FMRegressor(factorSize=4, maxIter=400, stepSize=0.1,
                        seed=3).fit(frame)
        pred = m.transform(frame)["prediction"]
        r2 = 1 - np.sum((pred - y) ** 2) / np.sum((y - y.mean()) ** 2)
        assert r2 > 0.95

    def test_minibatch_and_gd_solver(self, pctx):
        rng = np.random.RandomState(14)
        x = rng.randn(300, 3)
        y = x @ np.array([1.0, 0.5, -1.0])
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = FMRegressor(factorSize=2, maxIter=150, solver="gd",
                        stepSize=0.05, miniBatchFraction=0.5, seed=2).fit(frame)
        pred = m.transform(frame)["prediction"]
        assert np.corrcoef(pred, y)[0, 1] > 0.9

    def test_persistence(self, pctx, tmp_path):
        rng = np.random.RandomState(15)
        x = rng.randn(100, 3)
        y = (x[:, 0] > 0).astype(np.float64)
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = FMClassifier(factorSize=2, maxIter=20, seed=1).fit(frame)
        p = str(tmp_path / "fm")
        m.save(p)
        m2 = FMClassificationModel.load(p)
        np.testing.assert_allclose(m2.factors.to_array(),
                                   m.factors.to_array())
        np.testing.assert_array_equal(m2.transform(frame)["prediction"],
                                      m.transform(frame)["prediction"])


@pytest.mark.parametrize("name,data,kw", [
    ("FMClassifier", "xor", dict(factorSize=4, maxIter=60, stepSize=0.1,
                                 seed=5)),
    ("FMClassifier", "xor", dict(factorSize=3, maxIter=40, stepSize=0.05,
                                 regParam=0.01, seed=2, fitLinear=False)),
    ("FMRegressor", "quad", dict(factorSize=4, maxIter=80, stepSize=0.1,
                                 seed=3)),
    ("FMRegressor", "quad", dict(factorSize=2, maxIter=50, solver="gd",
                                 stepSize=0.01, regParam=0.1, seed=4,
                                 fitIntercept=False)),
])
def test_fm_matches_reference(ctx, pctx, name, data, kw):
    """At miniBatchFraction 1.0 both packages take every row: the same
    factors, linear part and intercept, and the same objective history."""
    rng = np.random.RandomState(12)
    if data == "xor":
        x = rng.choice([-1.0, 1.0], size=(600, 2)) + 0.1 * rng.randn(600, 2)
        y = (x[:, 0] * x[:, 1] > 0).astype(np.float64)
    else:
        x = rng.randn(500, 3)
        y = 2.0 + x @ np.array([1.0, -2.0, 0.5]) + 1.5 * x[:, 0] * x[:, 1]
    got, ref = _both(ctx, pctx, name, {"features": x, "label": y}, **kw)
    assert len(got.objective_history) == len(ref.objective_history)
    np.testing.assert_allclose(got.objective_history,
                               ref.objective_history, rtol=RTOL)
    np.testing.assert_allclose(got.factors.to_array(),
                               ref.factors.to_array(), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(got.linear.to_array(), ref.linear.to_array(),
                               rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=RTOL,
                               atol=1e-10)


def test_fm_minibatch_mask_replays_with_one_seed(pctx):
    rng = np.random.RandomState(14)
    x = rng.randn(300, 3)
    y = x @ np.array([1.0, 0.5, -1.0])
    frame = MLFrame(pctx, {"features": x, "label": y})
    kw = dict(factorSize=2, maxIter=30, stepSize=0.05,
              miniBatchFraction=0.5, seed=2)
    a = FMRegressor(**kw).fit(frame)
    b = FMRegressor(**kw).fit(frame)
    c = FMRegressor(**dict(kw, seed=3)).fit(frame)
    assert a.objective_history == b.objective_history
    np.testing.assert_array_equal(a.factors.to_array(), b.factors.to_array())
    assert a.objective_history != c.objective_history


def test_adamw_is_optax_written_out():
    """Two steps of the port's AdamW against optax's formulas in float64
    numpy: bias-corrected moments, eps outside the square root, decoupled
    weight decay."""
    from cycloneml_tpu_torch.ml.optim.fm_core import AdamW
    rng = np.random.RandomState(0)
    p = rng.randn(5)
    gs = [rng.randn(5), rng.randn(5)]
    opt = AdamW(0.1, 0.01, torch.from_numpy(p))
    got = torch.from_numpy(p)
    mu = nu = np.zeros(5)
    want = p.copy()
    for t, g in enumerate(gs, 1):
        got = opt.step(got, torch.from_numpy(g))
        mu = 0.1 * g + 0.9 * mu
        nu = 0.001 * g * g + 0.999 * nu
        upd = (mu / (1 - 0.9 ** t)) / (np.sqrt(nu / (1 - 0.999 ** t)) + 1e-8)
        want = want - 0.1 * (upd + 0.01 * want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)


# -- MLP ----------------------------------------------------------------------

class TestMLP:
    def test_learns_xor(self, pctx):
        rng = np.random.RandomState(16)
        x = rng.choice([-1.0, 1.0], size=(400, 2)) + 0.1 * rng.randn(400, 2)
        y = (x[:, 0] * x[:, 1] > 0).astype(np.float64)
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = MultilayerPerceptronClassifier(
            layers=[2, 8, 2], maxIter=300, seed=5).fit(frame)
        acc = (m.transform(frame)["prediction"] == y).mean()
        assert acc > 0.95

    def test_three_class_blobs(self, pctx):
        rng = np.random.RandomState(17)
        centers = np.array([[0, 4], [-4, -2], [4, -2]], float)
        y = rng.randint(0, 3, 450).astype(np.float64)
        x = centers[y.astype(int)] + 0.5 * rng.randn(450, 2)
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = MultilayerPerceptronClassifier(
            layers=[2, 5, 3], maxIter=200, seed=2).fit(frame)
        out = m.transform(frame)
        assert (out["prediction"] == y).mean() > 0.97
        prob = out["probability"]
        assert np.all(np.isclose(prob.sum(1), 1.0, atol=1e-6))

    def test_initial_weights_and_validation(self, pctx):
        rng = np.random.RandomState(18)
        frame = MLFrame(pctx, {"features": rng.randn(50, 3),
                               "label": rng.randint(0, 2, 50).astype(float)})
        with pytest.raises(ValueError, match="input layer"):
            MultilayerPerceptronClassifier(layers=[4, 2], maxIter=5).fit(frame)
        with pytest.raises(ValueError, match="initialWeights"):
            MultilayerPerceptronClassifier(
                layers=[3, 2], maxIter=5,
                initialWeights=np.zeros(3)).fit(frame)

    def test_persistence(self, pctx, tmp_path):
        rng = np.random.RandomState(19)
        x = rng.randn(80, 3)
        y = (x[:, 0] > 0).astype(np.float64)
        frame = MLFrame(pctx, {"features": x, "label": y})
        m = MultilayerPerceptronClassifier(layers=[3, 4, 2], maxIter=30,
                                           seed=1).fit(frame)
        p = str(tmp_path / "mlp")
        m.save(p)
        m2 = MultilayerPerceptronClassificationModel.load(p)
        np.testing.assert_allclose(m2.weights.to_array(),
                                   m.weights.to_array())
        np.testing.assert_array_equal(m2.transform(frame)["prediction"],
                                      m.transform(frame)["prediction"])


@pytest.mark.parametrize("kw", [
    dict(layers=[2, 5, 3], maxIter=40, seed=2),
    dict(layers=[2, 6, 4, 3], maxIter=25, seed=7, tol=1e-9),
    dict(layers=[2, 5, 3], maxIter=30, seed=2, solver="gd", stepSize=0.5),
])
def test_mlp_matches_reference(ctx, pctx, kw):
    rng = np.random.RandomState(17)
    centers = np.array([[0, 4], [-4, -2], [4, -2]], float)
    y = rng.randint(0, 3, 450).astype(np.float64)
    x = centers[y.astype(int)] + 1.5 * rng.randn(450, 2)
    got, ref = _both(ctx, pctx, "MultilayerPerceptronClassifier",
                     {"features": x, "label": y}, **kw)
    assert got.total_iterations == ref.total_iterations
    np.testing.assert_allclose(got.objective_history,
                               ref.objective_history, rtol=RTOL)
    np.testing.assert_allclose(got.weights.to_array(),
                               ref.weights.to_array(), rtol=RTOL, atol=1e-10)


def test_chunked_dataset_trains_the_mlp(ctx, pctx):
    """The reference's chunked-ingest case (tests/test_oocore.py:550) for
    the MLP: the labels come from the dataset's mask of real rows, and
    the fit equals the fit on the same rows in one block."""
    rng = np.random.RandomState(6)
    x = rng.randn(900, 6)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(float)

    def chunks():
        for lo in range(0, 900, 200):
            yield x[lo:lo + 200], y[lo:lo + 200], None

    ds = InstanceDataset.from_dense_chunks(pctx, chunks(), 6)
    one = InstanceDataset.from_numpy(pctx, x, y)
    assert ds._valid_mask is not None and not ds._valid_mask.all()
    est = MultilayerPerceptronClassifier(layers=[6, 8, 2], maxIter=40, seed=3)
    m_chunked = est.fit(ds)
    m_one = est.fit(one)
    px = np.asarray(m_chunked.transform(
        MLFrame(pctx, {"features": x, "label": y}))["prediction"])
    assert float((px == y).mean()) > 0.85
    np.testing.assert_allclose(m_chunked.weights.to_array(),
                               m_one.weights.to_array(), rtol=RTOL)


# -- AFT ------------------------------------------------------------------------

def _aft_data(seed=10, n=500, d=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    beta = np.array([0.4, -0.2, 0.3])[:d]
    sigma = 0.7
    w_noise = np.log(-np.log(1.0 - rng.rand(n)))
    t = np.exp(x @ beta + 1.0 + sigma * w_noise)
    c = np.exp(x @ np.zeros(d) + 1.5 + rng.randn(n))
    y = np.minimum(t, c)
    censor = (t <= c).astype(float)
    return x, y, censor


def _aft_nll_numpy(params, x, y, censor):
    d = x.shape[1]
    beta, icpt, log_sigma = params[:d], params[d], params[d + 1]
    sigma = np.exp(log_sigma)
    eps = (np.log(y) - x @ beta - icpt) / sigma
    ll = censor * (eps - log_sigma) - np.exp(eps)
    return -ll.mean()


def test_aft_quantiles_col(pctx):
    x, y, censor = _aft_data(seed=13)
    frame = MLFrame(pctx, {"features": x, "label": y, "censor": censor})
    m = AFTSurvivalRegression(quantilesCol="q",
                              quantileProbabilities=[0.25, 0.5]).fit(frame)
    out = m.transform(frame)
    assert out["q"].shape == (len(y), 2)
    np.testing.assert_allclose(out["q"], m.predict_quantiles(x), rtol=1e-12)


def test_aft_matches_scipy_mle(pctx):
    optimize = pytest.importorskip("scipy.optimize")
    x, y, censor = _aft_data()
    frame = MLFrame(pctx, {"features": x, "label": y, "censor": censor})
    m = AFTSurvivalRegression(maxIter=200, tol=1e-9).fit(frame)
    res = optimize.minimize(
        _aft_nll_numpy, np.zeros(x.shape[1] + 2), args=(x, y, censor),
        method="L-BFGS-B",
        options={"maxiter": 1000, "ftol": 1e-14, "gtol": 1e-10})
    np.testing.assert_allclose(m.coefficients.to_array(), res.x[:x.shape[1]],
                               atol=1e-3)
    np.testing.assert_allclose(m.intercept, res.x[x.shape[1]], atol=1e-3)
    np.testing.assert_allclose(m.scale, np.exp(res.x[-1]), atol=1e-3)
    assert abs(m.scale - 0.7) < 0.15


def test_aft_quantiles_median_consistency(pctx):
    x, y, censor = _aft_data(seed=11)
    frame = MLFrame(pctx, {"features": x, "label": y, "censor": censor})
    m = AFTSurvivalRegression(quantileProbabilities=[0.5]).fit(frame)
    q = m.predict_quantiles(x[:5])
    lam = np.exp(x[:5] @ m.coefficients.to_array() + m.intercept)
    np.testing.assert_allclose(
        q[:, 0], lam * (-np.log(0.5)) ** m.scale, rtol=1e-10)


def test_aft_persistence(pctx, tmp_path):
    x, y, censor = _aft_data(seed=12)
    frame = MLFrame(pctx, {"features": x, "label": y, "censor": censor})
    m = AFTSurvivalRegression().fit(frame)
    path = str(tmp_path / "aft")
    m.save(path)
    m2 = AFTSurvivalRegressionModel.load(path)
    np.testing.assert_allclose(m2.coefficients.to_array(),
                               m.coefficients.to_array())
    assert m2.scale == m.scale


@pytest.mark.parametrize("seed,kw", [
    (10, dict(maxIter=200, tol=1e-9)), (11, dict()),
    (12, dict(fitIntercept=False, maxIter=50))])
def test_aft_matches_reference(ctx, pctx, seed, kw):
    x, y, censor = _aft_data(seed=seed)
    got, ref = _both(ctx, pctx, "AFTSurvivalRegression",
                     {"features": x, "label": y, "censor": censor}, **kw)
    assert len(got.loss_history) == len(ref.loss_history)
    np.testing.assert_allclose(got.loss_history, ref.loss_history,
                               rtol=RTOL)
    np.testing.assert_allclose(got.coefficients.to_array(),
                               ref.coefficients.to_array(), rtol=RTOL)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.scale, ref.scale, rtol=RTOL)


# -- isotonic -------------------------------------------------------------------

def test_isotonic_vs_sklearn(pctx):
    sk_iso = pytest.importorskip("sklearn.isotonic")
    rng = np.random.RandomState(20)
    f = rng.uniform(0, 10, 300)
    y = 0.5 * f + rng.randn(300)
    frame = MLFrame(pctx, {"features": f, "label": y})
    m = IsotonicRegression().fit(frame)
    sk = sk_iso.IsotonicRegression(out_of_bounds="clip").fit(f, y)
    np.testing.assert_allclose(m.transform(frame)["prediction"],
                               sk.predict(f), atol=1e-9)
    np.testing.assert_allclose(
        m._predict_batch(np.array([-100.0, 100.0])),
        sk.predict(np.array([-100.0, 100.0])), atol=1e-9)


def test_isotonic_weighted_and_antitonic(pctx):
    sk_iso = pytest.importorskip("sklearn.isotonic")
    rng = np.random.RandomState(21)
    f = rng.uniform(0, 5, 200)
    y = -0.7 * f + rng.randn(200)
    w = rng.uniform(0.5, 2.0, 200)
    frame = MLFrame(pctx, {"features": f, "label": y, "w": w})
    m = IsotonicRegression(isotonic=False, weightCol="w").fit(frame)
    sk = sk_iso.IsotonicRegression(increasing=False,
                                   out_of_bounds="clip").fit(
        f, y, sample_weight=w)
    np.testing.assert_allclose(m.transform(frame)["prediction"],
                               sk.predict(f), atol=1e-9)


def test_isotonic_persistence(pctx, tmp_path):
    rng = np.random.RandomState(22)
    f = rng.uniform(0, 10, 100)
    y = f + rng.randn(100)
    frame = MLFrame(pctx, {"features": f, "label": y})
    m = IsotonicRegression().fit(frame)
    path = str(tmp_path / "iso")
    m.save(path)
    m2 = IsotonicRegressionModel.load(path)
    np.testing.assert_allclose(m2.boundaries, m.boundaries)
    np.testing.assert_allclose(m2.predictions, m.predictions)


@pytest.mark.parametrize("increasing,weighted,ties", [
    (True, False, False), (False, True, False), (True, True, True)])
def test_isotonic_matches_reference_exactly(ctx, pctx, increasing, weighted,
                                            ties):
    rng = np.random.RandomState(23)
    f = rng.uniform(0, 10, 400)
    if ties:
        f = np.round(f, 1)
    y = (0.5 if increasing else -0.5) * f + rng.randn(400)
    cols = {"features": f, "label": y}
    kw = dict(isotonic=increasing)
    if weighted:
        cols["w"] = rng.uniform(0.5, 2.0, 400)
        kw["weightCol"] = "w"
    got, ref = _both(ctx, pctx, "IsotonicRegression", cols, **kw)
    np.testing.assert_array_equal(got.boundaries, ref.boundaries)
    np.testing.assert_array_equal(got.predictions, ref.predictions)


# -- carried across from the reference ------------------------------------------

def test_each_model_family_from_reference_predicts_the_same(ctx, pctx):
    r = _ref()
    rng = np.random.RandomState(3)
    x = rng.randn(120, 3)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    xc = np.abs(np.round(x * 3))
    rf = lambda cols: r.MLFrame(ctx, cols)  # noqa: E731
    pf = lambda cols: MLFrame(pctx, cols)  # noqa: E731
    pairs = []
    m = r.MultilayerPerceptronClassifier(layers=[3, 4, 2], maxIter=10,
                                         seed=1).fit(rf({"features": x,
                                                         "label": y}))
    pairs.append((interop.mlp_model_from_reference(
        m._layers, m.weights.to_array()), m, x))
    m = r.FMClassifier(factorSize=2, maxIter=10, seed=1).fit(
        rf({"features": x, "label": y}))
    pairs.append((interop.fm_model_from_reference(
        m.factors.to_array(), m.linear.to_array(), m.intercept), m, x))
    m = r.FMRegressor(factorSize=2, maxIter=10, seed=1).fit(
        rf({"features": x, "label": x[:, 0]}))
    pairs.append((interop.fm_model_from_reference(
        m.factors.to_array(), m.linear.to_array(), m.intercept,
        classification=False), m, x))
    for mt in ("multinomial", "gaussian"):
        xx = xc if mt == "multinomial" else x
        m = r.NaiveBayes(modelType=mt).fit(rf({"features": xx, "label": y}))
        pairs.append((interop.naive_bayes_model_from_reference(
            m.pi, m.theta.to_array(), np.asarray(m._sigma), model_type=mt),
            m, xx))
    xa, ya, ca = _aft_data(seed=12, n=120)
    m = r.AFTSurvivalRegression(maxIter=20).fit(
        rf({"features": xa, "label": ya, "censor": ca}))
    pairs.append((interop.aft_model_from_reference(
        m.coefficients.to_array(), m.intercept, m.scale), m, xa))
    m = r.IsotonicRegression().fit(rf({"features": x[:, 0], "label": y}))
    pairs.append((interop.isotonic_model_from_reference(
        m.boundaries, m.predictions), m, x[:, :1]))
    for got, ref, xx in pairs:
        np.testing.assert_array_equal(
            got.transform(pf({"features": xx}))["prediction"],
            np.asarray(ref.transform(rf({"features": xx}))["prediction"]),
            type(got).__name__)


@pytest.mark.parametrize("name", ["NaiveBayes", "FMClassifier",
                                  "MultilayerPerceptronClassifier",
                                  "AFTSurvivalRegression",
                                  "IsotonicRegression"])
def test_reference_saved_models_load_in_the_port(ctx, pctx, tmp_path, name):
    r = _ref()
    rng = np.random.RandomState(5)
    x = np.abs(np.round(rng.randn(100, 3) * 3))
    y = (x[:, 0] > x[:, 1]).astype(np.float64)
    cols = {"features": x, "label": y}
    kw = {}
    if name == "FMClassifier":
        kw = dict(factorSize=2, maxIter=10)
    elif name == "MultilayerPerceptronClassifier":
        kw = dict(layers=[3, 4, 2], maxIter=10)
    elif name == "AFTSurvivalRegression":
        cols = {"features": x, "label": x[:, 2] + 1.0, "censor": y}
    elif name == "IsotonicRegression":
        cols = {"features": x[:, 0], "label": x[:, 1]}
    ref = getattr(r, name)(**kw).fit(r.MLFrame(ctx, dict(cols)))
    path = str(tmp_path / "m")
    ref.save(path)
    from cycloneml_tpu_torch.ml.util_io import load_instance
    got = load_instance(path)
    assert type(got).__name__ == type(ref).__name__
    feats = x[:, :1] if name == "IsotonicRegression" else x
    np.testing.assert_array_equal(
        got.transform(MLFrame(pctx, {"features": feats}))["prediction"],
        np.asarray(ref.transform(r.MLFrame(ctx, {"features": feats}))
                   ["prediction"]))
