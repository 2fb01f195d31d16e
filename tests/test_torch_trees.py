"""The tree engine and the tree estimators of the port — DecisionTree,
RandomForest and GBT, classification and regression — against the JAX
package's, on the same seeded numpy inputs.

- Every case of the reference's ``tests/test_trees.py`` runs on the port
  (``cyclone.master=cpu``, ``cyclone.compute.dtype=float64``); those that
  call sklearn import it with ``pytest.importorskip``.
- Parity: on the same data both packages grow the same trees — the same
  feature, threshold, children and prediction at every node, counts
  exactly, gains, impurities and weights to rtol 1e-6 (both sum the
  level histogram in float32, the reference over its 8-device mesh's
  shards, the port in row order) — for DecisionTree (gini, entropy,
  multiclass, variance, weighted), RandomForest (bootstrap with feature
  subsets, Bernoulli subsampling) and GBT (logistic, squared, absolute).
  Both draw the counts and subsets from ``RandomState`` in the same order.
- The reference's chunked (interleaved padding) dataset case
  (``tests/test_oocore.py::test_chunked_dataset_trains_tree_mlp_svc``)
  for the DecisionTree.
- ``kernels.tree_hist_plain`` against a float64 numpy sum of the same
  table; the reference's ``hist_fn`` is a closure inside ``grow_forest``,
  so it is held through the tree parity above.
- A forest of the reference carried across by ``interop`` and a model the
  reference saved both predict as the reference does.

The ``gpu`` tests hold ``kernels.tree_hist`` (``csrc/tree_hist.cu``)
against its plain twin on the card over maxBins 2, 32, 33 and 256, 1 and
20 trees, 2 and 10 classes, regression channels, an odd d and rows at
position -1 (against the twin in float64: counts exactly, sums within 129
float roundings; two launches bitwise equal), and fits through it (launches counted, refits bitwise equal, the
plain route's classification trees equal). The card's machine has no jax,
so the reference is imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_trees.py
"""

import types

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.dataset import InstanceDataset
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.classification import (
    DecisionTreeClassificationModel, DecisionTreeClassifier, GBTClassifier,
    RandomForestClassificationModel, RandomForestClassifier,
)
from cycloneml_tpu_torch.ml.regression import (
    DecisionTreeRegressor, GBTRegressionModel, GBTRegressor,
    RandomForestRegressor,
)
from cycloneml_tpu_torch.ml.tree import impl
from cycloneml_tpu_torch.ops import kernels

RTOL = 1e-6


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


def _cls_data(ctx, n=400, d=8, k=2, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    logits = x[:, 0] * 2.0 + x[:, 1] - 0.5 * x[:, 2]
    if k == 2:
        y = (logits > 0).astype(np.float64)
    else:
        y = np.digitize(logits, np.quantile(logits, np.linspace(0, 1, k + 1)[1:-1])
                        ).astype(np.float64)
    return MLFrame(ctx, {"features": x, "label": y}), x, y


def _reg_data(ctx, n=500, d=6, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = np.where(x[:, 0] > 0, 3.0, -1.0) + np.where(x[:, 1] > 0.5, 2.0, 0.0)
    return MLFrame(ctx, {"features": x, "label": y}), x, y


# -- the reference's cases on the port ------------------------------------------

def test_decision_tree_classifier_separable(pctx):
    frame, x, y = _cls_data(pctx)
    model = DecisionTreeClassifier(maxDepth=6).fit(frame)
    out = model.transform(frame)
    acc = (out["prediction"] == y).mean()
    assert acc > 0.93
    assert model.depth <= 6
    assert model.num_nodes >= 3
    p = out["probability"]
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-9)


def test_decision_tree_vs_sklearn(pctx):
    sk_tree = pytest.importorskip("sklearn.tree")
    frame, x, y = _cls_data(pctx, n=600)
    ours = DecisionTreeClassifier(maxDepth=4, maxBins=64).fit(frame)
    sk = sk_tree.DecisionTreeClassifier(max_depth=4, random_state=0).fit(x, y)
    acc_ours = (ours.transform(frame)["prediction"] == y).mean()
    assert acc_ours >= sk.score(x, y) - 0.04


def test_decision_tree_multiclass(pctx):
    frame, x, y = _cls_data(pctx, k=3, n=600)
    model = DecisionTreeClassifier(maxDepth=7, maxBins=48).fit(frame)
    acc = (model.transform(frame)["prediction"] == y).mean()
    assert acc > 0.8
    assert model.num_classes == 3


def test_decision_tree_min_instances(pctx):
    frame, x, y = _cls_data(pctx, n=200)
    big = DecisionTreeClassifier(maxDepth=10, minInstancesPerNode=50).fit(frame)
    small = DecisionTreeClassifier(maxDepth=10, minInstancesPerNode=1).fit(frame)
    assert big.num_nodes < small.num_nodes


def test_decision_tree_pure_node_stops(pctx):
    x = np.array([[0.0], [1.0], [2.0], [10.0], [11.0], [12.0]])
    y = np.array([0.0, 0, 0, 1, 1, 1])
    frame = MLFrame(pctx, {"features": x, "label": y})
    model = DecisionTreeClassifier(maxDepth=5).fit(frame)
    assert model.depth == 1
    assert model.num_nodes == 3


def test_decision_tree_feature_importances(pctx):
    frame, x, y = _cls_data(pctx)
    model = DecisionTreeClassifier(maxDepth=5).fit(frame)
    imp = model.feature_importances
    assert imp.shape == (x.shape[1],)
    np.testing.assert_allclose(imp.sum(), 1.0, atol=1e-9)
    assert imp[0] == imp.max()


def test_decision_tree_regressor(pctx):
    frame, x, y = _reg_data(pctx)
    model = DecisionTreeRegressor(maxDepth=4).fit(frame)
    pred = model.transform(frame)["prediction"]
    ss_res = ((pred - y) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    assert 1 - ss_res / ss_tot > 0.97


def test_decision_tree_regressor_vs_sklearn(pctx):
    sk_tree = pytest.importorskip("sklearn.tree")
    rng = np.random.RandomState(11)
    x = rng.randn(500, 5)
    y = x[:, 0] ** 2 + 0.5 * x[:, 1] + 0.1 * rng.randn(500)
    frame = MLFrame(pctx, {"features": x, "label": y})
    ours = DecisionTreeRegressor(maxDepth=5, maxBins=64).fit(frame)
    sk = sk_tree.DecisionTreeRegressor(max_depth=5, random_state=0).fit(x, y)
    mse_ours = ((ours.transform(frame)["prediction"] - y) ** 2).mean()
    mse_sk = ((sk.predict(x) - y) ** 2).mean()
    assert mse_ours <= mse_sk * 1.35


def test_random_forest_classifier(pctx):
    frame, x, y = _cls_data(pctx, n=500)
    model = RandomForestClassifier(numTrees=15, maxDepth=5, seed=7).fit(frame)
    assert model.num_trees == 15
    acc = (model.transform(frame)["prediction"] == y).mean()
    assert acc > 0.9
    np.testing.assert_allclose(model.feature_importances.sum(), 1.0,
                               atol=1e-9)


def test_random_forest_subsampling_and_subset(pctx):
    frame, x, y = _cls_data(pctx, n=300)
    model = RandomForestClassifier(
        numTrees=8, maxDepth=4, subsamplingRate=0.7,
        featureSubsetStrategy="sqrt", seed=1).fit(frame)
    acc = (model.transform(frame)["prediction"] == y).mean()
    assert acc > 0.8
    f = model._forest
    assert len({int(f.feature[t, 0]) for t in range(f.num_trees)}) > 1


def test_random_forest_regressor(pctx):
    frame, x, y = _reg_data(pctx)
    model = RandomForestRegressor(numTrees=10, maxDepth=5, seed=3).fit(frame)
    pred = model.transform(frame)["prediction"]
    ss_res = ((pred - y) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    assert 1 - ss_res / ss_tot > 0.9


def test_gbt_classifier(pctx):
    frame, x, y = _cls_data(pctx, n=400)
    model = GBTClassifier(maxIter=15, maxDepth=3, stepSize=0.3).fit(frame)
    out = model.transform(frame)
    assert (out["prediction"] == y).mean() > 0.95
    assert model.num_trees == 15
    p = out["probability"]
    assert ((p >= 0) & (p <= 1)).all()
    np.testing.assert_allclose(p.sum(axis=1), 1.0, atol=1e-9)


def test_gbt_improves_over_single_tree(pctx):
    rng = np.random.RandomState(2)
    x = rng.randn(500, 6)
    y = ((x[:, 0] * x[:, 1] + x[:, 2]) > 0).astype(np.float64)
    frame = MLFrame(pctx, {"features": x, "label": y})
    dt = DecisionTreeClassifier(maxDepth=3).fit(frame)
    gbt = GBTClassifier(maxIter=25, maxDepth=3, stepSize=0.3).fit(frame)
    acc_dt = (dt.transform(frame)["prediction"] == y).mean()
    acc_gbt = (gbt.transform(frame)["prediction"] == y).mean()
    assert acc_gbt > acc_dt


@pytest.mark.parametrize("loss", ["squared", "absolute"])
def test_gbt_regressor_squared_and_absolute(pctx, loss):
    frame, x, y = _reg_data(pctx)
    model = GBTRegressor(maxIter=20, maxDepth=3, stepSize=0.3,
                         lossType=loss).fit(frame)
    pred = model.transform(frame)["prediction"]
    ss_res = ((pred - y) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    assert 1 - ss_res / ss_tot > 0.9


def test_tree_persistence_roundtrip(pctx, tmp_path):
    frame, x, y = _cls_data(pctx)
    model = DecisionTreeClassifier(maxDepth=4).fit(frame)
    p = str(tmp_path / "dt")
    model.save(p)
    loaded = DecisionTreeClassificationModel.load(p)
    np.testing.assert_array_equal(model.transform(frame)["prediction"],
                                  loaded.transform(frame)["prediction"])
    assert loaded.get("maxDepth") == 4


def test_rf_persistence_roundtrip(pctx, tmp_path):
    frame, x, y = _cls_data(pctx, n=200)
    model = RandomForestClassifier(numTrees=5, maxDepth=3, seed=2).fit(frame)
    p = str(tmp_path / "rf")
    model.save(p)
    loaded = RandomForestClassificationModel.load(p)
    np.testing.assert_array_equal(model.transform(frame)["prediction"],
                                  loaded.transform(frame)["prediction"])


def test_gbt_persistence_roundtrip(pctx, tmp_path):
    frame, x, y = _reg_data(pctx, n=200)
    model = GBTRegressor(maxIter=5, maxDepth=3).fit(frame)
    p = str(tmp_path / "gbt")
    model.save(p)
    loaded = GBTRegressionModel.load(p)
    np.testing.assert_allclose(model.transform(frame)["prediction"],
                               loaded.transform(frame)["prediction"])


def test_tree_determinism(pctx):
    frame, x, y = _cls_data(pctx)
    m1 = RandomForestClassifier(numTrees=5, maxDepth=4, seed=9).fit(frame)
    m2 = RandomForestClassifier(numTrees=5, maxDepth=4, seed=9).fit(frame)
    np.testing.assert_array_equal(m1.transform(frame)["prediction"],
                                  m2.transform(frame)["prediction"])


def test_tree_in_pipeline(pctx):
    """The reference's case scales first with its StandardScaler, which
    the port does not have yet (ROADMAP Queue 1 item 11 b); the same
    scaling is applied to the column here and the Pipeline holds the
    tree."""
    from cycloneml_tpu_torch.ml.base import Pipeline
    frame, x, y = _cls_data(pctx)
    scaled = (x - x.mean(0)) / x.std(0, ddof=1)
    frame = frame.with_column("scaled", scaled)
    pipe = Pipeline(stages=[
        DecisionTreeClassifier(featuresCol="scaled", maxDepth=4)])
    model = pipe.fit(frame)
    acc = (model.transform(frame)["prediction"] == y).mean()
    assert acc > 0.9


def test_tree_weighted_instances(pctx):
    rng = np.random.RandomState(0)
    x = rng.randn(300, 4)
    y = (x[:, 0] > 0).astype(np.float64)
    y_noisy = y.copy()
    y_noisy[:80] = 1.0 - y_noisy[:80]
    w = np.ones(300)
    w[:80] = 0.0
    f_w = MLFrame(pctx, {"features": x, "label": y_noisy, "w": w})
    m_w = DecisionTreeClassifier(maxDepth=3, weightCol="w").fit(f_w)
    pred = m_w.transform(f_w)["prediction"]
    assert (pred[80:] == y[80:]).mean() > 0.98
    m_plain = DecisionTreeClassifier(maxDepth=3).fit(f_w)
    pred_p = m_plain.transform(f_w)["prediction"]
    assert (pred[80:] == y[80:]).mean() >= (pred_p[80:] == y[80:]).mean()


def test_debug_string(pctx):
    frame, x, y = _cls_data(pctx, n=100)
    model = DecisionTreeClassifier(maxDepth=2).fit(frame)
    s = model.to_debug_string()
    assert "If (feature" in s and "Predict:" in s


# -- parity with the reference ----------------------------------------------------

def _assert_same_forest(got, ref, rtol=RTOL):
    assert np.array_equal(got.n_nodes, ref.n_nodes)
    for name in ("feature", "left", "right", "threshold", "count"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(ref, name)), name)
    scale = max(float(np.abs(ref.impurity).max()), 1.0)
    for name in ("prediction", "impurity", "gain", "weight"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(ref, name)), rtol=rtol,
                                   atol=rtol * scale, err_msg=name)
    np.testing.assert_array_equal(got.tree_weights, ref.tree_weights)
    assert got.num_features == ref.num_features
    assert got.is_classification == ref.is_classification


def _fit_both(ctx, pctx, cls_name, x, y, w=None, **kw):
    r = _ref()
    cols = {"features": x, "label": y}
    if w is not None:
        cols["w"] = w
        kw["weightCol"] = "w"
    ref = getattr(r, cls_name)(**kw).fit(r.MLFrame(ctx, dict(cols)))
    import cycloneml_tpu_torch.ml.classification as pc
    import cycloneml_tpu_torch.ml.regression as pr
    est = getattr(pc, cls_name, None) or getattr(pr, cls_name)
    got = est(**kw).fit(MLFrame(pctx, dict(cols)))
    return got, ref


@pytest.mark.parametrize("cls_name,data,kw", [
    ("DecisionTreeClassifier", "cls2", dict(maxDepth=6)),
    ("DecisionTreeClassifier", "cls2", dict(maxDepth=5, impurity="entropy",
                                            maxBins=16)),
    ("DecisionTreeClassifier", "cls3", dict(maxDepth=7, maxBins=48)),
    ("DecisionTreeClassifier", "cls2", dict(maxDepth=10,
                                            minInstancesPerNode=20)),
    ("DecisionTreeClassifier", "cls2w", dict(maxDepth=4,
                                             minWeightFractionPerNode=0.05)),
    ("DecisionTreeRegressor", "reg", dict(maxDepth=4)),
    ("DecisionTreeRegressor", "quad", dict(maxDepth=5, maxBins=64)),
    ("RandomForestClassifier", "cls2", dict(numTrees=15, maxDepth=5,
                                            seed=7)),
    ("RandomForestClassifier", "cls2", dict(
        numTrees=8, maxDepth=4, subsamplingRate=0.7,
        featureSubsetStrategy="sqrt", seed=1)),
    ("RandomForestClassifier", "cls3", dict(
        numTrees=6, maxDepth=4, bootstrap=False, subsamplingRate=0.6,
        featureSubsetStrategy="0.5", seed=4)),
    ("RandomForestRegressor", "reg", dict(numTrees=10, maxDepth=5, seed=3)),
    ("RandomForestRegressor", "quad", dict(
        numTrees=4, maxDepth=6, featureSubsetStrategy="onethird", seed=8)),
])
def test_forest_matches_reference(ctx, pctx, cls_name, data, kw):
    """Node for node: features, thresholds, children and counts exactly,
    predictions, impurities, gains and weights to rtol 1e-6."""
    if data.startswith("cls"):
        _, x, y = _cls_data(pctx, n=500, k=3 if data == "cls3" else 2)
    elif data == "reg":
        _, x, y = _reg_data(pctx)
    else:
        rng = np.random.RandomState(11)
        x = rng.randn(500, 5)
        y = x[:, 0] ** 2 + 0.5 * x[:, 1] + 0.1 * rng.randn(500)
    w = (np.random.RandomState(4).uniform(0.2, 2.0, len(y))
         if data == "cls2w" else None)
    got, ref = _fit_both(ctx, pctx, cls_name, x, y, w, **kw)
    _assert_same_forest(got._forest, ref._forest)
    frame = MLFrame(pctx, {"features": x, "label": y})
    out = got.transform(frame)
    ref_out = ref.transform(_ref().MLFrame(ctx, {"features": x, "label": y}))
    np.testing.assert_allclose(out["prediction"],
                               np.asarray(ref_out["prediction"]), rtol=RTOL)


@pytest.mark.parametrize("cls_name,kw", [
    ("GBTClassifier", dict(maxIter=15, maxDepth=3, stepSize=0.3)),
    ("GBTRegressor", dict(maxIter=10, maxDepth=3, stepSize=0.3)),
    ("GBTRegressor", dict(maxIter=8, maxDepth=3, lossType="absolute",
                          subsamplingRate=0.8, featureSubsetStrategy="sqrt")),
])
def test_gbt_matches_reference(ctx, pctx, cls_name, kw):
    if cls_name == "GBTClassifier":
        _, x, y = _cls_data(pctx, n=400)
    else:
        _, x, y = _reg_data(pctx)
    got, ref = _fit_both(ctx, pctx, cls_name, x, y, **kw)
    assert len(got._forests) == len(ref._forests)
    np.testing.assert_array_equal(got.tree_weights, ref.tree_weights)
    for a, b in zip(got._forests, ref._forests):
        _assert_same_forest(a, b)


def test_chunked_dataset_trains_the_tree(ctx, pctx):
    """The reference's chunked-ingest case (tests/test_oocore.py:550) for
    the DecisionTree: the dataset's real rows come from its mask, and the
    tree is the one grown on the same rows in one block."""
    rng = np.random.RandomState(6)
    x = rng.randn(900, 6)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(float)

    def chunks():
        for lo in range(0, 900, 200):
            yield x[lo:lo + 200], y[lo:lo + 200], None

    ds = InstanceDataset.from_dense_chunks(pctx, chunks(), 6)
    ref = InstanceDataset.from_numpy(pctx, x, y)
    assert ds._valid_mask is not None and not ds._valid_mask.all()
    est = DecisionTreeClassifier(maxDepth=4, seed=3)
    m_chunked = est.fit(ds)
    m_ref = est.fit(ref)
    frame = MLFrame(pctx, {"features": x, "label": y})
    px = np.asarray(m_chunked.transform(frame)["prediction"])
    assert float((px == y).mean()) > 0.85
    _assert_same_forest(m_chunked._forest, m_ref._forest, rtol=0)
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RDataset
    from cycloneml_tpu.ml.classification import (
        DecisionTreeClassifier as RDT)

    def rchunks():
        for lo in range(0, 900, 200):
            yield x[lo:lo + 200], y[lo:lo + 200], None

    rds = RDataset.from_dense_chunks(ctx, rchunks(), 6)
    _assert_same_forest(m_chunked._forest,
                        RDT(maxDepth=4, seed=3).fit(rds)._forest)


def test_binning_matches_reference(ctx, pctx):
    """The same sample (past sample_cap), thresholds and bins."""
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RDataset
    from cycloneml_tpu.ml.tree import BinnedDataset as RBinned
    rng = np.random.RandomState(21)
    x = np.round(rng.randn(3000, 5), 2)
    x[:, 4] = rng.randint(0, 3, 3000)         # a 3-valued feature
    ref = RBinned.from_instance_dataset(RDataset.from_numpy(ctx, x), 32, 5,
                                        sample_cap=1000)
    got = impl.BinnedDataset.from_instance_dataset(
        InstanceDataset.from_numpy(pctx, x), 32, 5, sample_cap=1000)
    np.testing.assert_array_equal(got.thresholds, ref.thresholds)
    np.testing.assert_array_equal(got.n_bins, ref.n_bins)
    np.testing.assert_array_equal(
        got.bins[:3000].numpy(), np.asarray(ref.bins)[ref.valid_idx])


# -- the histogram's plain twin -------------------------------------------------

def _hist_inputs(n, d, T, C, B, a_pad, seed, dead=0.2):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, d)).astype(np.int32)
    pos = rng.randint(0, a_pad, size=(n, T)).astype(np.int32)
    pos[rng.rand(n, T) < dead] = -1
    chans = rng.rand(n, T, C).astype(np.float32)
    chans[..., 0] = rng.poisson(1.0, size=(n, T))
    return bins, chans, pos


def _hist_numpy(bins, chans, pos, a_pad, B):
    n, d = bins.shape
    T, C = chans.shape[1:]
    out = np.zeros((T, a_pad, d, B, C))
    for t in range(T):
        for i in range(n):
            if pos[i, t] >= 0:
                out[t, pos[i, t], np.arange(d), bins[i]] += chans[i, t]
    return out


@pytest.mark.parametrize("n,d,T,C,B,a_pad", [
    (300, 5, 1, 3, 32, 1), (257, 7, 4, 11, 33, 4), (200, 3, 3, 4, 2, 8)])
def test_tree_hist_plain_matches_float64(n, d, T, C, B, a_pad):
    bins, chans, pos = _hist_inputs(n, d, T, C, B, a_pad, seed=n)
    got = kernels.tree_hist_plain(torch.from_numpy(bins),
                                  torch.from_numpy(chans),
                                  torch.from_numpy(pos), a_pad, B)
    assert got.dtype == torch.float32
    truth = _hist_numpy(bins, chans, pos, a_pad, B)
    np.testing.assert_array_equal(got.numpy()[..., 0], truth[..., 0])
    np.testing.assert_allclose(got.numpy(), truth, rtol=1e-5, atol=1e-5)
    # the wrapper on CPU tensors is the twin, and launches nothing
    kernels.reset_launch_counts()
    again = kernels.tree_hist(torch.from_numpy(bins), torch.from_numpy(chans),
                              torch.from_numpy(pos), a_pad, B)
    assert torch.equal(again, got) and kernels.tree_hist.launches == 0


def test_tree_pieces_cover_every_key_in_order():
    """The pieces of a launch: each key's sorted rows cut in order into
    pieces of at most piece_rows, a key with no rows has none, and the
    piece size grows until the partial tables fit the budget."""
    offsets = np.array([0, 0, 5, 20_000, 20_001], dtype=np.int64)
    pk, pf, pl, kp, rows = kernels.tree_pieces(offsets, dbc=10,
                                               out_elems=40)
    assert rows == kernels.TREE_PIECE_ROWS
    assert list(kp) == [0, 0, 1, 1 + -(-19_995 // rows), len(pk)]
    for key in range(4):
        got = [(int(pf[p]), int(pl[p])) for p in range(kp[key], kp[key + 1])]
        covered = [i for f, m in got for i in range(f, f + m)]
        assert covered == list(range(offsets[key], offsets[key + 1]))
        assert all(int(pk[p]) == key for p in range(kp[key], kp[key + 1]))
    # a budget of one table a key forces whole keys
    big = kernels.tree_pieces(offsets, dbc=kernels.TREE_SCRATCH_BYTES // 12,
                              out_elems=1)
    assert big[4] >= 19_995 and len(big[0]) == 3


def test_tree_order_is_the_stable_sort_past_the_counting_keys():
    keys = torch.from_numpy(np.random.RandomState(2).randint(
        -1, 5000, 20_000).astype(np.int32))
    order, offsets = kernels.tree_order(keys, 5000)
    kept = (keys >= 0).numpy()
    want = np.argsort(np.where(kept, keys.numpy(), 5000), kind="stable")
    n_kept = int(kept.sum())
    np.testing.assert_array_equal(order[:n_kept].numpy(), want[:n_kept])
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate(
            [[0], np.cumsum(np.bincount(keys.numpy()[kept],
                                        minlength=5000))]))


def test_plain_route_is_the_default_route_on_the_cpu(pctx):
    frame, x, y = _cls_data(pctx, n=300)
    a = RandomForestClassifier(numTrees=4, maxDepth=4, seed=3).fit(frame)
    pctx.conf.set("cyclone.ml.usePallasKernels", "false")
    b = RandomForestClassifier(numTrees=4, maxDepth=4, seed=3).fit(frame)
    _assert_same_forest(a._forest, b._forest, rtol=0)


# -- carried across from the reference ------------------------------------------

def test_forest_from_reference_predicts_the_same(ctx, pctx):
    r = _ref()
    _, x, y = _cls_data(pctx, n=300)
    ref = r.RandomForestClassifier(numTrees=5, maxDepth=4, seed=2).fit(
        r.MLFrame(ctx, {"features": x, "label": y}))
    got = interop.forest_model_from_reference(
        "RandomForestClassificationModel", ref._forest.to_arrays(),
        num_classes=ref.num_classes)
    frame = MLFrame(pctx, {"features": x})
    np.testing.assert_array_equal(
        got.transform(frame)["probability"],
        np.asarray(ref.transform(r.MLFrame(ctx, {"features": x}))
                   ["probability"]))
    _, xr, yr = _reg_data(pctx, n=200)
    gbt = r.GBTRegressor(maxIter=4, maxDepth=3).fit(
        r.MLFrame(ctx, {"features": xr, "label": yr}))
    got = interop.gbt_model_from_reference(
        "GBTRegressionModel", [f.to_arrays() for f in gbt._forests],
        gbt.tree_weights)
    np.testing.assert_array_equal(
        got.transform(MLFrame(pctx, {"features": xr}))["prediction"],
        np.asarray(gbt.transform(r.MLFrame(ctx, {"features": xr}))
                   ["prediction"]))


@pytest.mark.parametrize("cls_name,model_name", [
    ("DecisionTreeClassifier", "DecisionTreeClassificationModel"),
    ("GBTClassifier", "GBTClassificationModel"),
    ("DecisionTreeRegressor", "DecisionTreeRegressionModel"),
])
def test_reference_saved_trees_load_in_the_port(ctx, pctx, tmp_path,
                                                cls_name, model_name):
    r = _ref()
    _, x, y = _cls_data(pctx, n=200)
    kw = dict(maxIter=3) if cls_name.startswith("GBT") else {}
    ref = getattr(r, cls_name)(maxDepth=3, **kw).fit(
        r.MLFrame(ctx, {"features": x, "label": y}))
    path = str(tmp_path / "m")
    ref.save(path)
    import cycloneml_tpu_torch.ml.classification as pc
    import cycloneml_tpu_torch.ml.regression as pr
    cls = getattr(pc, model_name, None) or getattr(pr, model_name)
    got = cls.load(path)
    np.testing.assert_array_equal(
        got.transform(MLFrame(pctx, {"features": x}))["prediction"],
        np.asarray(ref.transform(r.MLFrame(ctx, {"features": x}))
                   ["prediction"]))


def test_tree_fit_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CycloneContext(CycloneConf().set("cyclone.master", "cuda"))
    with pytest.raises(ValueError, match="no kernel"):
        kernels.tree_hist(torch.zeros((50, 3), dtype=torch.int32,
                                      device="meta"),
                          torch.zeros((50, 1, 3), device="meta"),
                          torch.zeros((50, 1), dtype=torch.int32,
                                      device="meta"), 1, 2)


# -- on the card ------------------------------------------------------------------

def _cuda_context(**conf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = CycloneConf().set("cyclone.master", "cuda")
    for key, v in conf.items():
        c.set(key, v)
    return CycloneContext(c)


def _cuda_hist_check(n, d, T, C, B, a_pad, seed, dead=0.2):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bins, chans, pos = _hist_inputs(n, d, T, C, B, a_pad, seed, dead)
    dev = torch.device("cuda")
    b, c, p = (torch.from_numpy(a).to(dev) for a in (bins, chans, pos))
    kernels.reset_launch_counts()
    got = kernels.tree_hist(b, c, p, a_pad, B)
    again = kernels.tree_hist(b, c, p, a_pad, B)
    torch.cuda.synchronize()
    assert kernels.tree_hist.launches == 2
    # the twin in float64 (the channels upcast exactly) is the table's
    # truth; the kernel sums blocks of 128 rows in float and the rest in
    # double, so it stays within 129 float roundings of it (the channels
    # here are nonnegative: relative to the cell itself)
    twin = kernels.tree_hist_plain(b, c.double(), p, a_pad, B)
    g, tw = got.double().cpu().numpy(), twin.cpu().numpy()
    np.testing.assert_array_equal(g[..., 0], tw[..., 0])
    np.testing.assert_allclose(g, tw, rtol=129 * 2.0 ** -24, atol=1e-30)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 32, 33, 256])
@pytest.mark.parametrize("T,C", [(1, 3), (20, 3), (4, 11), (3, 4)])
def test_cuda_tree_hist_matches_its_twin(B, T, C):
    """maxBins 2, 32, 33 and 256; 1 and 20 trees; 2 and 10 classes (C = 3,
    11); regression channels (C = 4); d = 7 (a ragged feature block)."""
    _cuda_hist_check(50_021, 7, T, C, B, 8, seed=B + T)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,a_pad,dead", [
    (200_003, 28, 1, 0.0), (100_000, 9, 64, 0.5), (30_000, 3, 4096, 0.1),
    (20_000, 33, 8192, 0.3), (1000, 5, 2, 1.0)])
def test_cuda_tree_hist_shapes(n, d, a_pad, dead):
    """One node holding every row (many pieces of one key), deep levels
    past the counting sort's keys, d past one feature block, every row at
    -1."""
    _cuda_hist_check(n, d, 2, 3, 32, a_pad, seed=d, dead=dead)


@pytest.mark.gpu
@pytest.mark.parametrize("cls_name", ["RandomForestClassifier",
                                      "DecisionTreeRegressor"])
def test_cuda_forest_fits_through_tree_hist(cls_name):
    """Launched once a level, refits bitwise equal; the classification
    forest equals the plain route's (unit weights keep the counts and
    class sums exact in float32 in any order)."""
    rng = np.random.RandomState(1)
    x = rng.randn(60_000, 12).astype(np.float32)
    y = ((x[:, 0] * x[:, 1] + x[:, 2]) > 0).astype(np.float32)
    if cls_name == "DecisionTreeRegressor":
        y = x[:, 0] ** 2 + x[:, 3]
    ctx = _cuda_context()
    try:
        import cycloneml_tpu_torch.ml.classification as pc
        import cycloneml_tpu_torch.ml.regression as pr
        est = (getattr(pc, cls_name, None) or getattr(pr, cls_name))(
            maxDepth=6, seed=3, **({"numTrees": 6}
                                   if cls_name.startswith("Random") else {}))
        frame = MLFrame(ctx, {"features": x, "label": y})
        kernels.reset_launch_counts()
        a = est.fit(frame)
        # one launch a level: levels 0 .. the deepest tree's depth
        assert kernels.tree_hist.launches == 1 + max(
            a._forest.tree_depth(t) for t in range(a._forest.num_trees))
        b = est.fit(frame)
        _assert_same_forest(a._forest, b._forest, rtol=0)
        if cls_name.startswith("Random"):
            ctx.conf.set("cyclone.ml.usePallasKernels", "false")
            kernels.reset_launch_counts()
            plain = est.fit(frame)
            assert kernels.tree_hist.launches == 0
            _assert_same_forest(a._forest, plain._forest, rtol=0)
    finally:
        ctx.stop()
