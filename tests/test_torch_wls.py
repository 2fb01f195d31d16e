"""The port's WeightedLeastSquares (the normal-equation solver), the
LinearRegression fits that delegate to it, and RegressionEvaluator against
the JAX package's, on the same numpy data.

In float64 (``cyclone.compute.dtype=float64``) the moments agree to rtol
1e-12, and the solutions of every branch (Cholesky, the singular fallback
to quasi-Newton, OWL-QN over the moments, the constant-label and
zero-variance cases, weights, no intercept, unstandardized features or
label) to rtol 1e-8 / atol 1e-10 with the same objective histories.
RegressionEvaluator's metrics agree to 1e-12, and a CrossValidator over
LinearRegression to 1e-10 with the same best model. On the card
(``gpu``), the moments pass over a bf16 X against float64 sums of the
same rows.

The card's machine has no jax, so the reference is imported inside the
tests that use it.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.evaluation import RegressionEvaluator
from cycloneml_tpu_torch.ml.optim import wls
from cycloneml_tpu_torch.ml.regression import LinearRegression


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _data(n=300, d=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) * (rng.rand(d) * 3 + 0.2) + rng.randn(d)
    beta = rng.randn(d) * (rng.rand(d) > 0.3)
    y = x @ beta + 0.5 * rng.randn(n) + 2.0
    return x, y


def _same_wls(got, ref):
    np.testing.assert_allclose(got.coefficients, ref.coefficients,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=1e-8,
                               atol=1e-10)
    assert len(got.objective_history) == len(ref.objective_history)
    np.testing.assert_allclose(got.objective_history, ref.objective_history,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.diag_inv_atwa, ref.diag_inv_atwa,
                               rtol=1e-8)


def test_moments_match_reference():
    from cycloneml_tpu.ml.optim import wls as jwls
    x, y = _data(n=257, d=5, seed=1)
    w = np.random.RandomState(2).rand(257)
    w[-9:] = 0.0
    ref = jwls._moments(x, y, w)
    got = wls._moments(torch.as_tensor(x), torch.as_tensor(y),
                       torch.as_tensor(w))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12)


def _singular(n=200, seed=3):
    """A duplicated column: the port's AᵀWA is exactly singular, so its
    Cholesky fails and quasi-Newton from 0 keeps the two coordinates
    equal. The reference's einsum sums the two copies in different orders
    (their moments differ in the last bits), so its Cholesky may succeed
    on the rounded matrix; that branch is therefore held on identical
    moments."""
    x, y = _data(n=n, d=4, seed=seed)
    return np.c_[x, x[:, 1]], y


def _zero_variance(n=200, seed=4):
    x, y = _data(n=n, d=4, seed=seed)
    x[:, 2] = 1.5
    return x, y


_CASES = {
    "cholesky": (_data, dict(fit_intercept=True)),
    "cholesky-l2": (_data, dict(fit_intercept=True, reg_param=0.3)),
    "no-intercept": (_data, dict(fit_intercept=False, reg_param=0.1)),
    "elastic-net": (_data, dict(fit_intercept=True, reg_param=0.1,
                                elastic_net_param=0.5)),
    "lasso-unstandardized": (_data, dict(fit_intercept=True, reg_param=0.05,
                                         elastic_net_param=1.0,
                                         standardize_features=False)),
    "label-unstandardized": (_data, dict(fit_intercept=True, reg_param=0.2,
                                         standardize_label=False,
                                         standardize_features=False)),
    "singular-falls-back-to-qn": (_singular, dict(fit_intercept=True)),
    "zero-variance-column": (_zero_variance, dict(fit_intercept=True,
                                                  reg_param=0.05)),
    "quasi-newton": (_data, dict(fit_intercept=False,
                                 solver_type="quasi-newton")),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_solver_branches_match_reference(case, weighted):
    from cycloneml_tpu.ml.optim import wls as jwls
    make, kw = _CASES[case]
    x, y = make()
    w = np.random.RandomState(5).rand(len(y)) + 0.2 if weighted else None
    if case == "singular-falls-back-to-qn":
        m = wls._moments(torch.as_tensor(x), torch.as_tensor(y),
                         torch.as_tensor(np.ones(len(y)) if w is None
                                         else w))
        ref = jwls.WeightedLeastSquares(**kw)._solve_from_moments(m, 5)
        got = wls.WeightedLeastSquares(**kw)._solve_from_moments(m, 5)
        assert len(got.objective_history) > 1  # quasi-Newton ran
        assert got.coefficients[1] == got.coefficients[4]
    else:
        ref = jwls.WeightedLeastSquares(**kw).fit(x, y, w)
        got = wls.WeightedLeastSquares(**kw).fit(
            torch.as_tensor(x), torch.as_tensor(y),
            None if w is None else torch.as_tensor(w))
    _same_wls(got, ref)
    if case == "zero-variance-column":
        assert got.coefficients[2] == 0.0


@pytest.mark.parametrize("fit_intercept,value", [(True, 3.5), (False, 0.0),
                                                 (False, -2.0)])
def test_constant_label_matches_reference(fit_intercept, value):
    from cycloneml_tpu.ml.optim import wls as jwls
    x, _ = _data(n=120, d=4, seed=6)
    y = np.full(120, value)
    ref = jwls.WeightedLeastSquares(fit_intercept).fit(x, y)
    got = wls.WeightedLeastSquares(fit_intercept).fit(
        torch.as_tensor(x), torch.as_tensor(y))
    _same_wls(got, ref)


def test_refusals():
    x, _ = _data(n=50, d=3)
    with pytest.raises(ValueError, match="standard deviation of the label"):
        wls.WeightedLeastSquares(False, reg_param=0.1).fit(
            torch.as_tensor(x), torch.full((50,), 2.0, dtype=torch.float64))
    with pytest.raises(np.linalg.LinAlgError):
        xs, ys = _singular(n=60)
        wls.WeightedLeastSquares(True, solver_type="cholesky").fit(
            torch.as_tensor(xs), torch.as_tensor(ys))
    with pytest.raises(ValueError, match="at most 4096"):
        wls.WeightedLeastSquares(True).fit(torch.zeros((4, 4097)),
                                           torch.zeros(4))
    with pytest.raises(ValueError, match="unknown solver"):
        wls.WeightedLeastSquares(True, solver_type="newton")


@pytest.mark.parametrize("kw", [
    dict(), dict(regParam=0.1, standardization=False),
    dict(regParam=0.05, elasticNetParam=0.4, solver="normal"),
    dict(fitIntercept=False, regParam=0.02, solver="normal"),
], ids=["default", "auto-l2-unstandardized", "normal-elastic-net",
        "normal-no-intercept"])
def test_linear_regression_normal_fit_matches_reference(ctx, pctx, kw):
    from cycloneml_tpu.dataset.dataset import InstanceDataset as JaxDataset
    from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
    x, y = _data(n=400, d=8, seed=7)
    w = np.random.RandomState(8).rand(400) + 0.5
    ref = JaxLinReg(**kw).fit(JaxDataset.from_numpy(ctx, x, y, w))
    got = LinearRegression(**kw).fit(interop.dataset_from_numpy(x, y, w))
    np.testing.assert_allclose(got.coefficients.values,
                               np.asarray(ref.coefficients), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=1e-8,
                               atol=1e-10)
    assert got.summary.total_iterations == ref.summary.total_iterations
    np.testing.assert_allclose(got.summary.objective_history,
                               ref.summary.objective_history, rtol=1e-8,
                               atol=1e-12)


def test_fp8_codes_fall_back_once_for_the_normal_solver():
    """A default LinearRegression on e4m3 codes leaves the fp8 rung once,
    visibly, and fits the bf16 dequantization."""
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.data.dtype", "float8"))
    try:
        x, y = _data(n=500, d=6, seed=9)
        ds = interop.dataset_from_numpy(x, y, ctx=c,
                                        dtype=torch.float8_e4m3fn)
        assert ds.x_scale is not None
        model = LinearRegression().fit(ds)
        assert len(c.precision_fallbacks) == 1
        fb = c.precision_fallbacks[0]
        assert fb["estimator"] == "LinearRegression"
        assert fb["to_dtype"] == "bfloat16"
        assert "normal" in fb["reason"]
        plain = LinearRegression().fit(ds.dequantized())
        np.testing.assert_array_equal(model.coefficients.values,
                                      plain.coefficients.values)
    finally:
        c.stop()


@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2", "var"])
def test_regression_evaluator_matches_reference(ctx, pctx, metric):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.evaluation import \
        RegressionEvaluator as JaxRegEval
    rng = np.random.RandomState(10)
    y = rng.randn(150) * 3
    pred = y + rng.randn(150)
    cols = {"label": y, "prediction": pred}
    ref = JaxRegEval(metricName=metric)
    got = RegressionEvaluator(metricName=metric)
    np.testing.assert_allclose(got.evaluate(MLFrame(pctx, dict(cols))),
                               ref.evaluate(JaxFrame(ctx, dict(cols))),
                               rtol=1e-12)
    assert got.is_larger_better == ref.is_larger_better


def test_cross_validator_over_linear_regression_matches_reference(ctx, pctx):
    from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
    from cycloneml_tpu.ml.evaluation import \
        RegressionEvaluator as JaxRegEval
    from cycloneml_tpu.ml.regression import LinearRegression as JaxLinReg
    from cycloneml_tpu.ml.tuning import CrossValidator as JaxCV
    from cycloneml_tpu.ml.tuning import ParamGridBuilder as JaxGrid
    from cycloneml_tpu_torch.ml.tuning import (CrossValidator,
                                               ParamGridBuilder)
    x, y = _data(n=240, d=5, seed=11)
    cols = {"features": x, "label": y}
    regs = [0.0, 0.3, 3.0]
    jlr, plr = JaxLinReg(), LinearRegression()
    ref = JaxCV(estimator=jlr,
                estimator_param_maps=JaxGrid().add_grid(jlr.regParam,
                                                        regs).build(),
                evaluator=JaxRegEval(), numFolds=3).fit(JaxFrame(ctx, cols))
    got = CrossValidator(
        estimator=plr,
        estimator_param_maps=ParamGridBuilder().add_grid(plr.regParam,
                                                         regs).build(),
        evaluator=RegressionEvaluator(), numFolds=3).fit(
        MLFrame(pctx, cols))
    np.testing.assert_allclose(got.avg_metrics, ref.avg_metrics, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.best_model.coefficients.values,
                               np.asarray(ref.best_model.coefficients),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(1003, 37), (70_001, 300)])
def test_cuda_moments_match_float64(n, d):
    """The moments pass on a bf16 X on the card (float32 sums, TF32 off)
    against float64 sums of the same rows: |dA_ij| <= 1e-4
    sqrt(A_ii A_jj), the vectors to 1e-5 of their largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n + d)
    x = (torch.randn(n, d, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    y = torch.randn(n, generator=g, device=dev)
    w = torch.rand(n, generator=g, device=dev)
    w[-5:] = 0.0
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = wls._moments(x, y, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    truth = wls._moments(x, y.double(), w.double(), acc=torch.float64)
    a = truth["aa_sum"]
    scale = np.sqrt(np.outer(np.diag(a), np.diag(a)))
    assert np.all(np.abs(got["aa_sum"] - a) <= 1e-4 * scale)
    for k in ("a_sum", "ab_sum"):
        assert np.max(np.abs(got[k] - truth[k])) <= \
            1e-5 * np.max(np.abs(truth[k]))
    for k in ("w_sum", "b_sum", "bb_sum"):
        assert abs(got[k] - truth[k]) <= 1e-5 * abs(truth[k])
