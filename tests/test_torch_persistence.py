"""Model persistence in the port (``ml/util_io.py``, ``Pipeline``) against
the JAX package's, on the float64 tier with seeded numpy data.

- A round trip in the port keeps every learned array bit for bit, the uid
  and both param maps, and the loaded model transforms as the original.
- A directory the reference wrote loads in the port (its ``class`` read
  under the port's package) and predicts what the reference model
  predicts, to 1e-12.
- A port-written directory has the reference's layout: the same metadata
  keys, npz array names, stage and best-model directories; its ``class``
  differs only by the package prefix.
- ``overwrite`` and the "Path exists" error behave as the reference's.
"""

import json
import os
import types

import numpy as np
import pytest

import cycloneml_tpu.ml.base as r_base
import cycloneml_tpu.ml.classification as r_cls
import cycloneml_tpu.ml.clustering as r_clu
import cycloneml_tpu.ml.evaluation as r_eval
import cycloneml_tpu.ml.feature as r_feat
import cycloneml_tpu.ml.recommendation as r_rec
import cycloneml_tpu.ml.regression as r_reg
import cycloneml_tpu.ml.tuning as r_tun
from cycloneml_tpu.dataset.frame import MLFrame as RFrame
from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml import base as p_base
from cycloneml_tpu_torch.ml import classification as p_cls
from cycloneml_tpu_torch.ml import clustering as p_clu
from cycloneml_tpu_torch.ml import evaluation as p_eval
from cycloneml_tpu_torch.ml import feature as p_feat
from cycloneml_tpu_torch.ml import recommendation as p_rec
from cycloneml_tpu_torch.ml import regression as p_reg
from cycloneml_tpu_torch.ml import tuning as p_tun
from cycloneml_tpu_torch.ml import util_io


def _pkg(base, cls, clu, ev, feat, rec, reg, tun, frame):
    return types.SimpleNamespace(
        Pipeline=base.Pipeline, LogisticRegression=cls.LogisticRegression,
        LinearSVC=cls.LinearSVC, OneVsRest=cls.OneVsRest, KMeans=clu.KMeans,
        BinaryClassificationEvaluator=ev.BinaryClassificationEvaluator,
        BisectingKMeans=clu.BisectingKMeans,
        GaussianMixture=clu.GaussianMixture, LDA=clu.LDA,
        PCA=feat.PCA, ALS=rec.ALS, LinearRegression=reg.LinearRegression,
        GeneralizedLinearRegression=reg.GeneralizedLinearRegression,
        CrossValidator=tun.CrossValidator,
        ParamGridBuilder=tun.ParamGridBuilder,
        TrainValidationSplit=tun.TrainValidationSplit, MLFrame=frame)


PORT = _pkg(p_base, p_cls, p_clu, p_eval, p_feat, p_rec, p_reg, p_tun,
            MLFrame)
REF = _pkg(r_base, r_cls, r_clu, r_eval, r_feat, r_rec, r_reg, r_tun, RFrame)


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _columns(kind, seed=0, n=240, d=5):
    rng = np.random.RandomState(seed)
    if kind == "ratings":
        users = rng.randint(0, 30, 600)
        items = rng.randint(0, 20, 600)
        return {"user": users, "item": items,
                "rating": rng.rand(600) * 4 + 1}
    if kind == "docs":
        return {"features": rng.poisson(2.0, (n // 4, 12)).astype(np.float64)}
    x = rng.randn(n, d)
    beta = rng.randn(d)
    m = x @ beta
    label = {"binary": (m + rng.randn(n) > 0).astype(np.float64),
             "multiclass": np.digitize(m, [-0.7, 0.7]).astype(np.float64),
             "regression": m + 0.1 * rng.randn(n),
             "counts": rng.poisson(np.exp(0.3 * m)).astype(np.float64)}[kind]
    return {"features": x, "label": label}


def _lr(pkg, **kw):
    return pkg.LogisticRegression(maxIter=12, regParam=0.01, **kw)


def _grid(pkg, lr):
    return pkg.ParamGridBuilder().add_grid(lr.regParam, [0.01, 0.1]).build()


def _cv(pkg):
    lr = _lr(pkg)
    return pkg.CrossValidator(estimator=lr, estimator_param_maps=_grid(
        pkg, lr), evaluator=pkg.BinaryClassificationEvaluator(), numFolds=2,
        seed=3)


def _tvs(pkg):
    lr = _lr(pkg)
    return pkg.TrainValidationSplit(
        estimator=lr, estimator_param_maps=_grid(pkg, lr),
        evaluator=pkg.BinaryClassificationEvaluator(), seed=3)


#: name -> (estimator from a package's classes, the data it fits)
CASES = {
    "logistic": (lambda p: _lr(p), "binary"),
    "logistic_multinomial": (lambda p: _lr(p, family="multinomial"),
                             "multiclass"),
    "linear_regression": (lambda p: p.LinearRegression(regParam=0.01),
                          "regression"),
    "linear_svc": (lambda p: p.LinearSVC(maxIter=12, regParam=0.01),
                   "binary"),
    "glm": (lambda p: p.GeneralizedLinearRegression(
        family="poisson", link="log", maxIter=10), "counts"),
    "kmeans": (lambda p: p.KMeans(k=3, seed=1, maxIter=5), "binary"),
    "bisecting_kmeans": (lambda p: p.BisectingKMeans(k=4, seed=1,
                                                     maxIter=5), "binary"),
    "gaussian_mixture": (lambda p: p.GaussianMixture(k=3, seed=2,
                                                     maxIter=8), "binary"),
    "lda": (lambda p: p.LDA(k=3, seed=3, maxIter=4), "docs"),
    "pca": (lambda p: p.PCA(k=2, inputCol="features", outputCol="pca"),
            "binary"),
    "one_vs_rest": (lambda p: p.OneVsRest(classifier=_lr(p)), "multiclass"),
    "cross_validator": (_cv, "binary"),
    "train_validation_split": (_tvs, "binary"),
    "als": (lambda p: p.ALS(rank=3, maxIter=3, seed=0, regParam=0.1),
            "ratings"),
    "pipeline": (lambda p: p.Pipeline([
        p.PCA(k=3, inputCol="features", outputCol="pca"),
        _lr(p, featuresCol="pca")]), "binary"),
}

_ARRAYS = ("_coef", "_icpt", "_num_classes", "_is_multinomial", "_centers",
           "training_cost", "pc", "explained_variance", "user_ids",
           "item_ids", "user_factors", "item_factors", "_node_index",
           "weights", "_means", "_covs", "_lam")


def _state(model, prefix=""):
    """Every learned array of a model, nested models included, by name."""
    out = {}
    if hasattr(model, "stages"):
        for i, s in enumerate(model.stages):
            out.update(_state(s, f"{prefix}stage{i}."))
    if hasattr(model, "models"):
        for i, s in enumerate(model.models):
            out.update(_state(s, f"{prefix}model{i}."))
    if hasattr(model, "best_model"):
        out.update(_state(model.best_model, prefix + "best."))
        out[prefix + "avg_metrics"] = np.asarray(model.avg_metrics)
    for name in _ARRAYS:
        v = getattr(model, name, None)
        if v is not None:
            out[prefix + name] = v
    return out


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _params(obj):
    return obj.uid, obj._params_to_json(), obj._default_params_to_json()


def _outputs(model, frame):
    out = model.transform(frame)
    return {c: np.asarray(out[c]) for c in out.columns
            if c not in frame.columns}


def _fit(pkg, ctx, name):
    make, kind = CASES[name]
    frame = pkg.MLFrame(ctx, _columns(kind))
    return make(pkg), make(pkg).fit(frame), frame


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_keeps_arrays_bitwise_and_params(pctx, tmp_path, name):
    est, model, frame = _fit(PORT, pctx, name)
    model.save(str(tmp_path / "m"))
    loaded = type(model).load(str(tmp_path / "m"))
    assert type(loaded) is type(model)
    want, got = _state(model), _state(loaded)
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert _same_bits(got[k], want[k]), k
    assert _params(loaded) == _params(model)
    for c, v in _outputs(model, frame).items():
        assert _same_bits(_outputs(loaded, frame)[c], v), c
    est.write().save(str(tmp_path / "e"))
    est2 = type(est).read().load(str(tmp_path / "e"))
    assert _params(est2) == _params(est)


def test_round_trip_of_nested_estimators(pctx, tmp_path):
    """OneVsRest keeps its classifier, a Pipeline its stages."""
    ovr = CASES["one_vs_rest"][0](PORT)
    ovr.save(str(tmp_path / "ovr"))
    back = PORT.OneVsRest.load(str(tmp_path / "ovr"))
    assert _params(back.classifier) == _params(ovr.classifier)
    pipe = CASES["pipeline"][0](PORT)
    pipe.save(str(tmp_path / "p"))
    back = PORT.Pipeline.load(str(tmp_path / "p"))
    assert [_params(s) for s in back.get_stages()] == \
        [_params(s) for s in pipe.get_stages()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_directory_loads_and_predicts_the_same(ctx, pctx,
                                                         tmp_path, name):
    _, ref_model, ref_frame = _fit(REF, ctx, name)
    path = str(tmp_path / "ref")
    ref_model.save(path)
    loaded = util_io.load_instance(path)
    assert type(loaded).__name__ == type(ref_model).__name__
    assert type(loaded).__module__.startswith("cycloneml_tpu_torch.")
    want = _state(ref_model)
    got = _state(loaded)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    frame = MLFrame(pctx, _columns(CASES[name][1]))
    ref_out = _outputs(ref_model, ref_frame)
    out = _outputs(loaded, frame)
    assert sorted(out) == sorted(ref_out)
    for c in ref_out:
        np.testing.assert_allclose(out[c], ref_out[c], rtol=1e-12,
                                   atol=1e-12, err_msg=c)


def _layout(path):
    """What the reference's layout fixes: the metadata keys, the class
    name without its package, the npz array names, the files beside them
    and the same of every stage and best model (uids masked)."""
    meta = util_io.load_metadata(path)
    cls = meta["class"].split(".", 1)[1]
    out = {"keys": sorted(meta), "class": cls,
           "files": sorted(f for f in os.listdir(path)
                           if f not in ("stages", "bestModel"))}
    npz = os.path.join(path, "data", "data.npz")
    if os.path.exists(npz):
        out["arrays"] = sorted(np.load(npz).files)
    sdir = os.path.join(path, "stages")
    if os.path.isdir(sdir):
        entries = sorted(os.listdir(sdir), key=lambda s: int(s.split("_")[0]))
        out["stages"] = [(e.split("_")[0], _layout(os.path.join(sdir, e)))
                         for e in entries]
    if os.path.isdir(os.path.join(path, "bestModel")):
        out["bestModel"] = _layout(os.path.join(path, "bestModel"))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_directory_has_the_reference_layout(ctx, pctx, tmp_path, name):
    ref_est, ref_model, _ = _fit(REF, ctx, name)
    est, model, _ = _fit(PORT, pctx, name)
    for a, b, tag in ((model, ref_model, "m"), (est, ref_est, "e")):
        a.save(str(tmp_path / f"port_{tag}"))
        b.save(str(tmp_path / f"ref_{tag}"))
        assert _layout(str(tmp_path / f"port_{tag}")) == \
            _layout(str(tmp_path / f"ref_{tag}"))
        port_cls = util_io.load_metadata(str(tmp_path / f"port_{tag}"))
        ref_cls = util_io.load_metadata(str(tmp_path / f"ref_{tag}"))
        assert port_cls["class"] == "cycloneml_tpu_torch." + \
            ref_cls["class"][len("cycloneml_tpu."):]


def test_overwrite_and_path_exists_behave_as_the_reference(ctx, pctx,
                                                           tmp_path):
    for pkg, c, tag in ((PORT, pctx, "port"), (REF, ctx, "ref")):
        _, model, _ = _fit(pkg, c, "logistic")
        path = str(tmp_path / tag)
        model.save(path)
        with pytest.raises(IOError, match="Path exists"):
            model.save(path)
        with pytest.raises(IOError, match="Path exists"):
            model.write().save(path)
        stale = os.path.join(path, "stale.txt")
        open(stale, "w").close()
        model.write().overwrite().save(path)
        assert not os.path.exists(stale)        # overwrite replaces the dir
        model.save(path, overwrite=True)
        assert type(model).read().load(path).uid == model.uid


def test_load_checks_the_class(pctx, tmp_path):
    _, model, _ = _fit(PORT, pctx, "kmeans")
    model.save(str(tmp_path / "k"))
    with pytest.raises(TypeError, match="expected PCAModel"):
        p_feat.PCAModel.load(str(tmp_path / "k"))


def test_unported_class_raises_with_its_roadmap_item(tmp_path):
    for cls, item in (
            ("cycloneml_tpu.ml.feature.scalers.MinMaxScalerModel", 11),
            ("cycloneml_tpu.ml.tree.random_forest.RandomForestModel", 11),
            ("cycloneml_tpu.ml.feature.scalers.StandardScalerModel", 11),
            ("cycloneml_tpu.streaming.query.StreamingQuery", 12),
            ("cycloneml_tpu.util.status.StatusStore", 12)):
        os.makedirs(tmp_path / "metadata", exist_ok=True)
        with open(tmp_path / "metadata" / "part-00000", "w") as fh:
            json.dump({"class": cls, "uid": "u"}, fh)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 item {item}"):
            util_io.load_instance(str(tmp_path))
    with open(tmp_path / "metadata" / "part-00000", "w") as fh:
        json.dump({"class": "os.path.join", "uid": "u"}, fh)
    with pytest.raises(ValueError, match="not a class of cycloneml"):
        util_io.load_instance(str(tmp_path))


def test_class_paths_map_by_name():
    assert util_io.port_class_path("cycloneml_tpu.ml.feature.pca.PCA") == \
        "cycloneml_tpu_torch.ml.feature.pca.PCA"
    assert util_io.port_class_path(
        "cycloneml_tpu_torch.ml.feature.pca.PCA") == \
        "cycloneml_tpu_torch.ml.feature.pca.PCA"


def test_model_save_no_longer_raises(pctx, tmp_path):
    model = p_cls.LogisticRegressionModel(np.ones((1, 3)), np.zeros(1))
    model.save(str(tmp_path / "m"))
    back = p_cls.LogisticRegressionModel.load(str(tmp_path / "m"))
    assert _same_bits(back._coef, model._coef)
