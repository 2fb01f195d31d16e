"""The port's OneVsRest, CrossValidator, TrainValidationSplit and
evaluators against the JAX package's, on the same numpy data.

Ports tests/test_stacked.py's TestStackedOneVsRest and TestStackedTuning
(stacked equals serial; ``parallelism=1`` stays serial; heterogeneous maps,
array-valued params and multiclass labels fall back to the serial path;
the label matrices' dtypes), each also held against the JAX package's
output on the same frame, in float64 (``cyclone.compute.dtype=float64``):

- CV/TVS metrics to 1e-10 of the reference's and the same best model;
- OneVsRest models: the reference's tolerance between its stacked and
  serial paths (atol 1e-5; it observes ~1e-9, which these separable
  classes reach after 60 iterations at tol=0 in either package), and the
  same predictions;
- evaluators: area under ROC and PR, accuracy and f1 to 1e-12 on seeded
  scores.
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu.dataset.frame import MLFrame as JaxFrame
from cycloneml_tpu.ml.classification import LogisticRegression as JaxLR
from cycloneml_tpu.ml.classification import OneVsRest as JaxOvR
from cycloneml_tpu.ml.evaluation import (
    BinaryClassificationEvaluator as JaxBinEval,
    MulticlassClassificationEvaluator as JaxMultiEval,
)
from cycloneml_tpu.ml.tuning import CrossValidator as JaxCV
from cycloneml_tpu.ml.tuning import ParamGridBuilder as JaxGrid
from cycloneml_tpu.ml.tuning import TrainValidationSplit as JaxTVS
from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import LogisticRegression, OneVsRest
from cycloneml_tpu_torch.ml.evaluation import (
    BinaryClassificationEvaluator, MulticlassClassificationEvaluator,
)
from cycloneml_tpu_torch.ml.evaluation.evaluators import binary_curve_points
from cycloneml_tpu_torch.ml.tuning import (
    CrossValidator, ParamGridBuilder, TrainValidationSplit,
)
from cycloneml_tpu_torch.ops import kernels as tk


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _multiclass(seed=20, n=400, k=4):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, 3) * 4.0
    y = rng.randint(0, k, n).astype(np.float64)
    x = centers[y.astype(int)] + 0.6 * rng.randn(n, 3)
    return x, y


def _binary(seed=21, n=400):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4)
    y = (x @ rng.randn(4) + 0.5 * rng.randn(n) > 0).astype(np.float64)
    return x, y


def _frames(ctx, pctx, x, y):
    cols = {"features": x, "label": y}
    return JaxFrame(ctx, dict(cols)), MLFrame(pctx, dict(cols))


# -- OneVsRest ----------------------------------------------------------------

def test_ovr_stacked_matches_serial_and_reference(ctx, pctx):
    x, y = _multiclass()
    jf, pf = _frames(ctx, pctx, x, y)
    kw = dict(maxIter=60, tol=0.0, regParam=0.01)
    stacked = OneVsRest(classifier=LogisticRegression(**kw),
                        parallelism=4).fit(pf)
    serial = OneVsRest(classifier=LogisticRegression(**kw),
                       parallelism=1).fit(pf)
    ref = JaxOvR(classifier=JaxLR(**kw), parallelism=4).fit(jf)
    assert stacked.num_classes == serial.num_classes == ref.num_classes == 4
    for ms, mr, mj in zip(stacked.models, serial.models, ref.models):
        np.testing.assert_allclose(ms._coef, mr._coef, atol=1e-5)
        np.testing.assert_allclose(ms._icpt, mr._icpt, atol=1e-5)
        np.testing.assert_allclose(ms._coef, mj._coef, atol=1e-5)
        np.testing.assert_allclose(ms._icpt, mj._icpt, atol=1e-5)
        assert ms.summary.n_models == 4 == mj.summary.n_models
        assert mr.summary.n_models == 1
    pred = stacked.transform(pf)["prediction"]
    np.testing.assert_array_equal(pred, serial.transform(pf)["prediction"])
    np.testing.assert_array_equal(pred, np.asarray(
        ref.transform(jf)["prediction"]))
    carried = interop.ovr_model_from_reference(ref.models)
    np.testing.assert_array_equal(carried.transform(pf)["prediction"], pred)


def test_ovr_stacked_fit_is_one_fit_of_k_models(ctx, pctx, monkeypatch):
    """parallelism > 1 makes ONE fit_stacked call carrying a (K, n) label
    matrix in the data tier, and every evaluation of that fit is one
    aggregation of all K models."""
    x, y = _multiclass(seed=33, n=320, k=5)
    seen = []
    orig = LogisticRegression.fit_stacked

    def spy(self, frame, y_stack=None, reg_params=None):
        seen.append((tuple(y_stack.shape), y_stack.dtype))
        return orig(self, frame, y_stack, reg_params)

    monkeypatch.setattr(LogisticRegression, "fit_stacked", spy)
    m = OneVsRest(classifier=LogisticRegression(maxIter=40, tol=0.0),
                  parallelism=4).fit(MLFrame(pctx, {"features": x,
                                                    "label": y}))
    assert seen == [((5, 320), torch.float64)]  # the float64 parity tier
    assert m.num_classes == 5
    assert all(mm.summary.n_models == 5 for mm in m.models)


def test_ovr_parallelism_one_stays_serial(pctx):
    x, y = _multiclass(seed=5, n=200, k=3)
    m = OneVsRest(classifier=LogisticRegression(maxIter=20),
                  parallelism=1).fit(MLFrame(pctx, {"features": x,
                                                    "label": y}))
    assert all(mm.summary.n_models == 1 for mm in m.models)


def test_ovr_ineligible_classifier_falls_back(ctx, pctx):
    """Elastic net has an L1 part (OWL-QN): the serial path, as in the
    reference, with the reference's models."""
    x, y = _multiclass(seed=6, n=200, k=3)
    jf, pf = _frames(ctx, pctx, x, y)
    kw = dict(maxIter=20, regParam=0.1, elasticNetParam=0.5)
    m = OneVsRest(classifier=LogisticRegression(**kw), parallelism=4).fit(pf)
    ref = JaxOvR(classifier=JaxLR(**kw), parallelism=4).fit(jf)
    assert m.num_classes == 3
    assert all(mm.summary.n_models == 1 for mm in m.models)
    for mm, mj in zip(m.models, ref.models):
        np.testing.assert_allclose(mm._coef, mj._coef, rtol=1e-8, atol=1e-10)


def test_ovr_label_matrix_uses_the_accumulator_tier_serially(pctx,
                                                             monkeypatch):
    """The serial relabel is one transient vector per class in the
    accumulator tier (the reference's rule)."""
    x, y = _multiclass(seed=7, n=150, k=3)
    seen = []
    orig = MLFrame.with_column

    def spy(self, name, values):
        if name == "_ovr_label":
            seen.append(np.asarray(values).dtype)
        return orig(self, name, values)

    monkeypatch.setattr(MLFrame, "with_column", spy)
    OneVsRest(classifier=LogisticRegression(maxIter=5),
              parallelism=1).fit(MLFrame(pctx, {"features": x, "label": y}))
    assert seen and all(dt == np.float64 for dt in seen)


def test_ovr_on_a_dataset_matches_the_frame(pctx):
    """The fit takes an InstanceDataset (data made on the card) on both
    paths, with the frame's models."""
    x, y = _multiclass(seed=8, n=240, k=3)
    frame = MLFrame(pctx, {"features": x, "label": y})
    ds = interop.dataset_from_numpy(x, y, ctx=pctx)
    for par in (1, 3):
        a = OneVsRest(classifier=LogisticRegression(maxIter=15, tol=0.0),
                      parallelism=par).fit(frame)
        b = OneVsRest(classifier=LogisticRegression(maxIter=15, tol=0.0),
                      parallelism=par).fit(ds)
        for ma, mb in zip(a.models, b.models):
            np.testing.assert_array_equal(ma._coef, mb._coef)


# -- CrossValidator and TrainValidationSplit ----------------------------------

def _grids(jlr, plr, regs=(0.0, 0.1, 1.0)):
    return (JaxGrid().add_grid(jlr.regParam, list(regs)).build(),
            ParamGridBuilder().add_grid(plr.regParam, list(regs)).build())


@pytest.mark.parametrize("parallelism", [4, 1])
def test_cross_validator_matches_serial_and_reference(ctx, pctx,
                                                      parallelism):
    x, y = _binary()
    jf, pf = _frames(ctx, pctx, x, y)
    jlr, plr = JaxLR(maxIter=40, tol=0.0), LogisticRegression(maxIter=40,
                                                              tol=0.0)
    jgrid, pgrid = _grids(jlr, plr)
    ref = JaxCV(estimator=jlr, estimator_param_maps=jgrid,
                evaluator=JaxBinEval(), parallelism=parallelism,
                numFolds=3).fit(jf)
    got = CrossValidator(estimator=plr, estimator_param_maps=pgrid,
                         evaluator=BinaryClassificationEvaluator(),
                         parallelism=parallelism, numFolds=3).fit(pf)
    serial = CrossValidator(estimator=plr, estimator_param_maps=pgrid,
                            evaluator=BinaryClassificationEvaluator(),
                            parallelism=1, numFolds=3).fit(pf)
    np.testing.assert_allclose(got.avg_metrics, ref.avg_metrics, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.avg_metrics, serial.avg_metrics, atol=1e-8)
    assert np.argmax(got.avg_metrics) == np.argmax(ref.avg_metrics)
    np.testing.assert_allclose(got.best_model._coef, ref.best_model._coef,
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got.best_model._coef,
                               serial.best_model._coef, atol=1e-5)


@pytest.mark.parametrize("parallelism", [4, 1])
def test_train_validation_split_matches_serial_and_reference(ctx, pctx,
                                                             parallelism):
    x, y = _binary(seed=31)
    jf, pf = _frames(ctx, pctx, x, y)
    jlr, plr = JaxLR(maxIter=40, tol=0.0), LogisticRegression(maxIter=40,
                                                              tol=0.0)
    jgrid, pgrid = _grids(jlr, plr)
    ref = JaxTVS(estimator=jlr, estimator_param_maps=jgrid,
                 evaluator=JaxBinEval(), parallelism=parallelism).fit(jf)
    got = TrainValidationSplit(estimator=plr, estimator_param_maps=pgrid,
                               evaluator=BinaryClassificationEvaluator(),
                               parallelism=parallelism).fit(pf)
    serial = TrainValidationSplit(estimator=plr, estimator_param_maps=pgrid,
                                  evaluator=BinaryClassificationEvaluator(),
                                  parallelism=1).fit(pf)
    np.testing.assert_allclose(got.validation_metrics,
                               ref.validation_metrics, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.validation_metrics,
                               serial.validation_metrics, atol=1e-8)
    np.testing.assert_allclose(got.best_model._coef, ref.best_model._coef,
                               rtol=1e-8, atol=1e-10)


def test_stacked_grid_is_one_fit_per_fold(pctx, monkeypatch):
    x, y = _binary(seed=9)
    calls = []
    orig = LogisticRegression.fit_stacked

    def spy(self, frame, y_stack=None, reg_params=None):
        calls.append(list(reg_params))
        return orig(self, frame, y_stack, reg_params)

    monkeypatch.setattr(LogisticRegression, "fit_stacked", spy)
    plr = LogisticRegression(maxIter=10, tol=0.0)
    CrossValidator(estimator=plr,
                   estimator_param_maps=_grids(JaxLR(), plr)[1],
                   evaluator=BinaryClassificationEvaluator(), parallelism=3,
                   numFolds=2).fit(MLFrame(pctx, {"features": x,
                                                  "label": y}))
    assert calls == [[0.0, 0.1, 1.0]] * 2


def test_heterogeneous_maps_fall_back(ctx, pctx):
    """Maps varying a non-vmappable param (maxIter) take the serial path,
    with the reference's metrics."""
    x, y = _binary(seed=32)
    jf, pf = _frames(ctx, pctx, x, y)
    jlr, plr = JaxLR(tol=0.0), LogisticRegression(tol=0.0)
    cv = CrossValidator(
        estimator=plr,
        estimator_param_maps=ParamGridBuilder().add_grid(
            plr.maxIter, [5, 15]).build(),
        evaluator=BinaryClassificationEvaluator(), parallelism=4, numFolds=2)
    assert cv._stack_plan(pf) is None
    model = cv.fit(pf)
    ref = JaxCV(estimator=jlr,
                estimator_param_maps=JaxGrid().add_grid(
                    jlr.maxIter, [5, 15]).build(),
                evaluator=JaxBinEval(), parallelism=4, numFolds=2).fit(jf)
    np.testing.assert_allclose(model.avg_metrics, ref.avg_metrics, rtol=0,
                               atol=1e-10)


def test_array_valued_param_falls_back_cleanly(pctx):
    """A grid carrying an array-valued param, even held constant, falls
    back serially instead of crashing while planning."""
    x, y = _binary(seed=33, n=120)
    frame = MLFrame(pctx, {"features": x, "label": y})
    lr = LogisticRegression(maxIter=5, tol=0.0)
    grid = (ParamGridBuilder()
            .add_grid(lr.regParam, [0.0, 0.1])
            .add_grid(lr.lowerBoundsOnCoefficients, [np.full((1, 4), -10.0)])
            .build())
    cv = CrossValidator(estimator=lr, estimator_param_maps=grid,
                        evaluator=BinaryClassificationEvaluator(),
                        parallelism=4, numFolds=2)
    assert cv._stack_plan(frame) is None  # bounded fits are serial
    # (the port's bounded fit itself is ROADMAP slice 2)
    with pytest.raises(NotImplementedError, match="slice 2"):
        cv.fit(frame)


def test_multiclass_labels_fall_back(pctx):
    x, y = _multiclass(seed=34, n=200, k=3)
    lr = LogisticRegression(maxIter=10)
    cv = CrossValidator(estimator=lr,
                        estimator_param_maps=_grids(JaxLR(), lr)[1],
                        evaluator=BinaryClassificationEvaluator(),
                        parallelism=4, numFolds=2)
    assert cv._stack_plan(MLFrame(pctx, {"features": x, "label": y})) is None


def test_kernel_route_stacked_cv_launches_nothing_on_the_cpu(pctx):
    """usePallasKernels=true on the CPU: the stacked grid runs K1s's plain
    version (no launch), with the float64 route's best model."""
    x, y = _binary(seed=35)
    frame = MLFrame(pctx, {"features": x, "label": y})
    plr = LogisticRegression(maxIter=30, tol=0.0)
    grid = _grids(JaxLR(), plr)[1]

    def cv():
        return CrossValidator(estimator=plr, estimator_param_maps=grid,
                              evaluator=BinaryClassificationEvaluator(),
                              parallelism=3, numFolds=3).fit(frame)

    plain = cv()
    pctx.conf.set("cyclone.ml.usePallasKernels", "true")
    kern = cv()
    assert tk.glm_sweep_stacked.launches == 0
    assert np.argmax(kern.avg_metrics) == np.argmax(plain.avg_metrics)
    np.testing.assert_allclose(kern.avg_metrics, plain.avg_metrics,
                               atol=1e-4)


# -- evaluators ---------------------------------------------------------------

@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_evaluator_matches_reference(ctx, pctx, metric, weighted):
    rng = np.random.RandomState(50)
    n = 500
    y = (rng.rand(n) > 0.6).astype(np.float64)
    score = np.round(rng.randn(n) + y, 1)  # ties, collapsed per group
    raw = np.stack([-score, score], axis=1)
    cols = {"rawPrediction": raw, "label": y, "w": rng.rand(n) + 0.1}
    wcol = "w" if weighted else ""
    ref = JaxBinEval(metricName=metric, weightCol=wcol).evaluate(
        JaxFrame(ctx, dict(cols)))
    got = BinaryClassificationEvaluator(metricName=metric,
                                        weightCol=wcol).evaluate(
        MLFrame(pctx, dict(cols)))
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-12)
    assert BinaryClassificationEvaluator().is_larger_better


@pytest.mark.parametrize("metric", ["accuracy", "f1", "weightedPrecision",
                                    "weightedRecall", "hammingLoss",
                                    "logLoss"])
def test_multiclass_evaluator_matches_reference(ctx, pctx, metric):
    rng = np.random.RandomState(51)
    n, k = 400, 4
    y = rng.randint(0, k, n).astype(np.float64)
    probs = rng.dirichlet(np.ones(k), n)
    pred = np.where(rng.rand(n) < 0.7, y, rng.randint(0, k, n))
    cols = {"label": y, "prediction": pred.astype(np.float64),
            "probability": probs}
    ref = JaxMultiEval(metricName=metric).evaluate(JaxFrame(ctx, dict(cols)))
    ev = MulticlassClassificationEvaluator(metricName=metric)
    got = ev.evaluate(MLFrame(pctx, dict(cols)))
    assert got == pytest.approx(ref, rel=1e-12, abs=1e-12)
    assert ev.is_larger_better == JaxMultiEval(
        metricName=metric).is_larger_better


def test_curve_points_collapse_ties():
    thr, tps, fps, tp_tot, fp_tot = binary_curve_points(
        np.array([0.9, 0.5, 0.5, 0.1]), np.array([1.0, 1.0, 0.0, 0.0]))
    np.testing.assert_array_equal(thr, [0.9, 0.5, 0.1])
    np.testing.assert_array_equal(tps, [1, 2, 2])
    np.testing.assert_array_equal(fps, [0, 1, 2])
    assert (tp_tot, fp_tot) == (2.0, 2.0)
