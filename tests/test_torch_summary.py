"""The main path's summary and the other names the port lacked in files
counted as ported, against the JAX package's on the same numpy inputs:

- ``LogisticRegressionModel.evaluate`` and
  ``BinaryLogisticRegressionSummary`` (the reference's
  tests/test_compat_summary.py cases, through both packages; the sklearn
  case held against the reference's summary, float64, to 1e-12);
- evaluator persistence (``Evaluator.save``/``load``);
- ``RowMatrix.compute_column_summary_statistics``;
- ``RandomDatasets``' other families (tests/test_distributed_matrices.py
  :98-115's determinism and moment checks; the bits are the port's own);
- the conf keys ``cyclone.compute.matmulPrecision``,
  ``cyclone.dataset.blockSizeInMB`` and ``cyclone.default.parallelism``,
  the builder methods and ``registered_entries`` (tests/test_conf.py).

The port's context is ``cyclone.master=cpu`` at float64; the reference's
the suite's local-mesh[8] fixture.
"""

import numpy as np
import pytest

from cycloneml_tpu_torch import CycloneConf, CycloneContext, conf as pconf
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.dataset.random import RandomDatasets
from cycloneml_tpu_torch.linalg.distributed import RowMatrix
from cycloneml_tpu_torch.ml.classification import (
    BinaryLogisticRegressionSummary, LogisticRegression)
from cycloneml_tpu_torch.ml.evaluation import (
    BinaryClassificationEvaluator, MulticlassClassificationEvaluator)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ref():
    from cycloneml_tpu.dataset.frame import MLFrame as RefFrame
    from cycloneml_tpu.ml.classification.logistic_regression import (
        BinaryLogisticRegressionSummary as RefSummary,
        LogisticRegression as RefLR, LogisticRegressionModel as RefModel)
    return RefFrame, RefLR, RefModel, RefSummary


@pytest.fixture(params=["port", "reference"])
def pkg(request, pctx):
    """(context, MLFrame, LogisticRegression, BinaryLogisticRegressionSummary)
    of one package."""
    if request.param == "port":
        return pctx, MLFrame, LogisticRegression, \
            BinaryLogisticRegressionSummary
    RefFrame, RefLR, _, RefSummary = _ref()
    return request.getfixturevalue("ctx"), RefFrame, RefLR, RefSummary


def _curves(s):
    return {"roc": s.roc, "pr": s.pr, "auc": s.area_under_roc,
            "auc_alias": s.areaUnderROC,
            "precision": s.precision_by_threshold(),
            "recall": s.recall_by_threshold(),
            "f1": s.f_measure_by_threshold(),
            "f2": s.f_measure_by_threshold(beta=2.0),
            "accuracy": s.accuracy}


def _close(got, want, tol=1e-12):
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)


# -- tests/test_compat_summary.py, through both packages -----------------------

def test_binary_summary_known_values(pkg):
    _, _, _, Summary = pkg
    s = Summary(np.array([0.9, 0.8, 0.3, 0.2]), np.array([1.0, 0.0, 1.0, 0.0]))
    assert s.area_under_roc == pytest.approx(0.75)
    np.testing.assert_allclose(s.recall_by_threshold()[:, 1],
                               [0.5, 0.5, 1.0, 1.0])
    assert s.accuracy == pytest.approx(0.5)


def test_evaluate_respects_custom_label_col(pkg):
    ctx, Frame, LR, _ = pkg
    rng = np.random.RandomState(4)
    x = rng.randn(150, 3)
    y = (x @ rng.randn(3) > 0).astype(float)
    frame = Frame(ctx, {"features": x, "target": y, "label": np.zeros(150)})
    model = LR(maxIter=10, labelCol="target").fit(frame)
    assert model.evaluate(frame).accuracy > 0.9


def test_summary_accuracy_respects_threshold(pkg):
    ctx, Frame, LR, Summary = pkg
    rng = np.random.RandomState(2)
    x = rng.randn(200, 4)
    y = (x @ rng.randn(4) > 0).astype(float)
    frame = Frame(ctx, {"features": x, "label": y})
    model = LR(maxIter=20).fit(frame)
    model.set("threshold", 0.95)
    s = model.evaluate(frame)
    pred = np.asarray(model.transform(frame)["prediction"])
    assert s.accuracy == pytest.approx(float((pred == y).mean()))
    with pytest.raises(ValueError, match="empty"):
        Summary(np.array([]), np.array([]))


def test_multinomial_evaluate_rejected(pkg):
    ctx, Frame, LR, _ = pkg
    rng = np.random.RandomState(0)
    x = rng.randn(90, 4)
    y = rng.randint(0, 3, 90).astype(float)
    model = LR(maxIter=5, family="multinomial").fit(
        Frame(ctx, {"features": x, "label": y}))
    with pytest.raises(ValueError, match="binary-only"):
        model.evaluate(Frame(ctx, {"features": x, "label": y}))


def test_binary_summary_against_the_references(pctx, ctx):
    """The sklearn case (test_compat_summary.py:48) held against the
    reference's summary instead of sklearn: the port's float64 fit scored
    by the port's evaluate and by the reference's evaluate of a model with
    the same coefficients give every curve to 1e-12; the reference's own
    fit of the same frame gives the same area to 1e-9; the case's own
    shape checks hold."""
    RefFrame, RefLR, RefModel, _ = _ref()
    rng = np.random.RandomState(0)
    x = rng.randn(400, 6)
    y = (x @ rng.randn(6) + 0.3 * rng.randn(400) > 0).astype(float)
    model = LogisticRegression(maxIter=30).fit(
        MLFrame(pctx, {"features": x, "label": y}))
    summary = model.evaluate(MLFrame(pctx, {"features": x, "label": y}))
    rframe = RefFrame(ctx, {"features": x, "label": y})
    twin = RefModel(model._coef.copy(), model._icpt.copy())
    _close(_curves(summary), _curves(twin.evaluate(rframe)))
    ref_fit = RefLR(maxIter=30).fit(rframe).evaluate(rframe)
    assert summary.area_under_roc == pytest.approx(ref_fit.area_under_roc,
                                                   abs=1e-9)
    roc = summary.roc
    assert roc[0].tolist() == [0.0, 0.0] and roc[-1].tolist() == [1.0, 1.0]
    assert np.all(np.diff(roc[:, 0]) >= 0)
    pr = summary.pr
    assert pr[0, 0] == 0.0 and pr[-1, 0] == 1.0
    f1 = summary.f_measure_by_threshold()
    assert 0.0 < f1[np.argmax(f1[:, 1]), 0] < 1.0
    assert summary.accuracy > 0.8


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_evaluate_parity_on_a_port_fit_with_ties(pctx, ctx,
                                                  threshold):
    """A float64 fit of the port on rows with repeated scores (tied
    thresholds collapse to one point): AUC, ROC, PR and the by-threshold
    curves against the reference's summary to 1e-12."""
    RefFrame, _, RefModel, _ = _ref()
    rng = np.random.default_rng(11)
    x = np.repeat(rng.normal(size=(60, 3)), 3, axis=0)
    y = (x[:, 0] + 0.5 * rng.normal(size=180) > 0).astype(float)
    frame = MLFrame(pctx, {"features": x, "label": y})
    model = LogisticRegression(maxIter=25, regParam=0.01,
                               threshold=threshold).fit(frame)
    twin = RefModel(model._coef.copy(), model._icpt.copy())
    twin.set("threshold", threshold)
    _close(_curves(model.evaluate(frame)),
           _curves(twin.evaluate(RefFrame(ctx, {"features": x,
                                                "label": y}))))


# -- evaluator persistence -----------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: BinaryClassificationEvaluator(metricName="areaUnderPR",
                                          labelCol="y"),
    lambda: MulticlassClassificationEvaluator(metricName="accuracy"),
])
def test_evaluator_save_load_round_trips_params(tmp_path, make):
    ev = make()
    path = str(tmp_path / "ev")
    ev.save(path)
    back = type(ev).load(path)
    assert type(back) is type(ev) and back.uid == ev.uid
    assert back._params_to_json() == ev._params_to_json()
    with pytest.raises(OSError, match="overwrite"):
        ev.save(path)
    ev.write().overwrite().save(path)


def test_evaluator_directory_of_the_reference_loads_in_the_port(tmp_path):
    from cycloneml_tpu.ml.evaluation import (
        BinaryClassificationEvaluator as RefEval)
    path = str(tmp_path / "ref_ev")
    RefEval(metricName="areaUnderPR", labelCol="target").save(path)
    back = BinaryClassificationEvaluator.load(path)
    assert back.get("metricName") == "areaUnderPR"
    assert back.get("labelCol") == "target"


# -- RowMatrix, RandomDatasets ---------------------------------------------------

def test_column_summary_statistics_equal_the_references(pctx, ctx):
    from cycloneml_tpu.linalg.distributed import RowMatrix as RefRowMatrix
    x = np.random.default_rng(6).normal(size=(37, 5))
    x[:, 2] = 0.0
    got = RowMatrix.from_numpy(pctx, x).compute_column_summary_statistics()
    want = RefRowMatrix.from_numpy(ctx, x).compute_column_summary_statistics()
    for f in ("mean", "variance", "max", "min", "norm_l1", "norm_l2",
              "num_nonzeros"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert got.count == want.count == 37


def test_random_determinism_and_shard_independence(pctx):
    a = RandomDatasets.uniform(pctx, 1000, 2, seed=5)
    b = RandomDatasets.uniform(pctx, 1000, 2, seed=5)
    c = RandomDatasets.uniform(pctx, 1000, 2, seed=6)
    assert np.array_equal(a.to_numpy()[0], b.to_numpy()[0])
    assert not np.array_equal(a.to_numpy()[0], c.to_numpy()[0])
    xa = a.to_numpy()[0]
    assert len(np.unique(np.round(xa[:, 0], 6))) > 900
    assert xa.min() >= 0.0 and xa.max() < 1.0


def test_random_families(pctx):
    p = RandomDatasets.poisson(pctx, 20_000, seed=1, lam=4.0).to_numpy()[0]
    assert abs(p.mean() - 4.0) < 0.15 and np.all(p == np.round(p))
    e = RandomDatasets.exponential(pctx, 20_000, seed=2,
                                   mean=2.5).to_numpy()[0]
    assert abs(e.mean() - 2.5) < 0.15
    g = RandomDatasets.gamma(pctx, 20_000, seed=3, shape=2.0,
                             scale=1.5).to_numpy()[0]
    assert abs(g.mean() - 3.0) < 0.2 and abs(g.var() - 4.5) < 0.45
    g = RandomDatasets.gamma(pctx, 20_000, seed=3, shape=0.5).to_numpy()[0]
    assert abs(g.mean() - 0.5) < 0.05 and g.min() >= 0.0
    ln = RandomDatasets.log_normal(pctx, 20_000, seed=4).to_numpy()[0]
    assert abs(ln.mean() - np.exp(0.5)) < 0.2
    for make in (RandomDatasets.poisson, RandomDatasets.exponential,
                 RandomDatasets.gamma, RandomDatasets.log_normal):
        one, two = (make(pctx, 500, 3, seed=8).to_numpy()[0]
                    for _ in range(2))
        assert np.array_equal(one, two)


# -- conf ----------------------------------------------------------------------------

NEW_KEYS = ("cyclone.compute.matmulPrecision", "cyclone.dataset.blockSizeInMB",
            "cyclone.default.parallelism")


@pytest.mark.parametrize("key", NEW_KEYS)
def test_new_conf_keys_match_the_references_entries(key):
    from cycloneml_tpu.conf import CycloneConf as RefConf
    from cycloneml_tpu.conf import registered_entries as ref_entries
    mine, ref = pconf.registered_entries()[key], ref_entries()[key]
    assert (mine.default, mine.value_type, mine.version) == \
        (ref.default, ref.value_type, ref.version)
    assert mine.doc
    probes = {"cyclone.compute.matmulPrecision": ["highest", "default",
                                                  "fast"],
              "cyclone.dataset.blockSizeInMB": ["0.5", "128"],
              "cyclone.default.parallelism": ["0", "4", "-1"]}[key]
    for raw in probes:
        outcome = []
        for conf in (CycloneConf(load_defaults=False),
                     RefConf(load_defaults=False)):
            conf.set(key, raw)
            try:
                outcome.append(conf.get(key))
            except ValueError:
                outcome.append("rejected")
        assert outcome[0] == outcome[1], (key, raw, outcome)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_builder_methods_and_conf_helpers(package):
    """version, with_alternative, mutable and fallback_conf, set_if_missing
    and registered_entries give the same reads in both packages (the
    fallback case of tests/test_conf.py:32 over a parent of its own)."""
    if package == "port":
        mod = pconf
    else:
        import cycloneml_tpu.conf as mod
    tag = f"cyclone.test.torch21.{package}"
    parent = (mod.ConfigBuilder(tag + ".parent").doc("p").version("2.1.0")
              .int_conf(100))
    child = mod.ConfigBuilder(tag + ".child").doc("c").fallback_conf(parent)
    alt = (mod.ConfigBuilder(tag + ".new").doc("a")
           .with_alternative(tag + ".old").mutable().str_conf("x"))
    conf = mod.CycloneConf(load_defaults=False)
    assert conf.get(child) == 100
    conf.set(parent, 777)
    assert conf.get(child) == 777
    conf.set(child, 1234)
    assert conf.get(child) == 1234
    assert conf.get(alt) == "x"
    conf.set(tag + ".old", "y")
    assert conf.get(alt) == "y"
    conf.set_if_missing(tag + ".new", "z")
    assert conf.get(alt) == "z"
    conf.set_if_missing(alt, "w")
    assert conf.get(alt) == "z"
    assert (parent.version, alt.mutable, child.fallback is parent) == \
        ("2.1.0", True, True)
    entries = mod.registered_entries()
    assert entries[tag + ".child"] is child and all(
        e.doc for e in entries.values())
    assert dict(conf)[tag + ".new"] == "z"


def test_matmul_precision_resolves_at_loss_build(pctx):
    """'highest' by default, 'default' when set; an invalid value raises
    (the reference's tests/test_optim.py:201); on the CPU the TF32 flag is
    untouched."""
    import torch
    from cycloneml_tpu_torch.ml.optim.aggregators import matmul_precision
    flag = torch.backends.cuda.matmul.allow_tf32
    assert matmul_precision() == "highest"
    pctx.conf.set("cyclone.compute.matmulPrecision", "default")
    try:
        assert matmul_precision() == "default"
        pctx.conf.set("cyclone.compute.matmulPrecision", "fast")
        with pytest.raises(ValueError):
            matmul_precision()
    finally:
        pctx.conf.set("cyclone.compute.matmulPrecision", "highest")
    assert matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 == flag


@pytest.mark.parametrize("name,inside", [("highest", False),
                                         ("default", True)])
@pytest.mark.parametrize("leftover", [False, True])
def test_precision_scope_sets_tf32_inside_and_restores_it(name, inside,
                                                          leftover):
    """On a CUDA device the scope sets the TF32 flag for the loss
    function's own products and puts the caller's value back after, also
    when the body raises; on the CPU it touches nothing."""
    import torch
    from cycloneml_tpu_torch.ml.optim.aggregators import precision_scope
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = leftover
    try:
        with precision_scope(name, torch.device("cuda")):
            assert torch.backends.cuda.matmul.allow_tf32 is inside
        assert torch.backends.cuda.matmul.allow_tf32 is leftover
        with pytest.raises(KeyError):
            with precision_scope(name, torch.device("cuda")):
                raise KeyError("body")
        assert torch.backends.cuda.matmul.allow_tf32 is leftover
        with precision_scope(name, torch.device("cpu")):
            assert torch.backends.cuda.matmul.allow_tf32 is leftover
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_default_precision_fit_leaves_no_tf32_behind(pctx):
    """A fit with 'default', then the conf set back to 'highest': the
    flag is at its earlier value after each, and every aggregation of the
    fit ran inside the scope of the precision its loss was built with."""
    import torch
    from cycloneml_tpu_torch.ml.optim import aggregators
    seen = []
    real = aggregators.precision_scope

    def spy(name, device):
        seen.append(name)
        return real(name, device)

    rng = np.random.default_rng(7)
    x = rng.standard_normal((200, 4))
    y = (x @ np.array([1.0, -2.0, 0.5, 0.0]) > 0).astype(np.float64)
    frame = MLFrame(pctx, {"features": x, "label": y})
    flag = torch.backends.cuda.matmul.allow_tf32
    aggregators.precision_scope = spy
    try:
        pctx.conf.set("cyclone.compute.matmulPrecision", "default")
        LogisticRegression(maxIter=5).fit(frame)
        assert seen and set(seen) == {"default"}
        assert torch.backends.cuda.matmul.allow_tf32 == flag
        pctx.conf.set("cyclone.compute.matmulPrecision", "highest")
        seen.clear()
        LogisticRegression(maxIter=5).fit(frame)
        assert seen and set(seen) == {"highest"}
        assert torch.backends.cuda.matmul.allow_tf32 == flag
    finally:
        aggregators.precision_scope = real
        pctx.conf.set("cyclone.compute.matmulPrecision", "highest")
