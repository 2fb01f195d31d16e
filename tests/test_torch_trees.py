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
  table, on int32 and one-byte bins; the reference's ``hist_fn`` is a
  closure inside ``grow_forest``, so it is held through the tree parity
  above. One-byte bins against int32 bins and the reference's binning;
  the piece table built by torch ops against a numpy build; a numpy model
  of the kernel's summation order against its error bound.
- A forest of the reference carried across by ``interop`` and a model the
  reference saved both predict as the reference does.

The ``gpu`` tests hold ``kernels.tree_hist`` (``csrc/tree_hist.cu``)
against its plain twin on the card over maxBins 2 to 257 on one-byte and
int32 bins, 1 and 20 trees, 2 and 10 classes, regression channels, an odd
d and rows at position -1, both instances (against the twin in float64:
counts exactly, sums within 129 float roundings; two launches bitwise
equal); one-byte bins against int32 bins bitwise; a cell against the numpy
model of the summation order bitwise; a call under
``torch.cuda.set_sync_debug_mode("error")``; and fits through it (launches
counted, refits bitwise equal, the plain route's classification trees
equal). The card's machine has no jax, so the reference is imported
inside the tests that use it:

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
    """The reference's case: the port's StandardScaler, then the tree, in
    one Pipeline."""
    from cycloneml_tpu_torch.ml.base import Pipeline
    from cycloneml_tpu_torch.ml.feature.scalers import StandardScaler
    frame, x, y = _cls_data(pctx)
    pipe = Pipeline(stages=[
        StandardScaler(inputCol="features", outputCol="scaled"),
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


@pytest.mark.parametrize("max_bins", [32, 256])
def test_one_byte_bins_equal_the_int32_bins(ctx, pctx, monkeypatch,
                                           max_bins):
    """Bins are stored as uint8 up to maxBins 256 (rows padded to 4
    bytes): value for value the int32 bins of the same binning, and the
    reference's."""
    from cycloneml_tpu.dataset.dataset import InstanceDataset as RDataset
    from cycloneml_tpu.ml.tree import BinnedDataset as RBinned
    rng = np.random.RandomState(22)
    x = np.round(rng.randn(2000, 7) * 3, 2)
    ds = InstanceDataset.from_numpy(pctx, x)
    got = impl.BinnedDataset.from_instance_dataset(ds, max_bins, 5,
                                                   sample_cap=1500)
    assert got.bins.dtype == torch.uint8 and got.bins.shape == (2000, 7)
    assert got.bins.stride() == (8, 1)
    monkeypatch.setattr(impl, "bin_storage", lambda n, d, mb, dev: torch.empty(
        (n, d), dtype=torch.int32, device=dev))
    wide = impl.BinnedDataset.from_instance_dataset(ds, max_bins, 5,
                                                    sample_cap=1500)
    assert wide.bins.dtype == torch.int32
    np.testing.assert_array_equal(got.bins.numpy(), wide.bins.numpy())
    ref = RBinned.from_instance_dataset(RDataset.from_numpy(ctx, x),
                                        max_bins, 5, sample_cap=1500)
    np.testing.assert_array_equal(got.bins.numpy(),
                                  np.asarray(ref.bins)[ref.valid_idx])
    # either width through the engine's other readers
    pos = torch.from_numpy(rng.randint(-1, 4, (2000, 3)).astype(np.int32))
    tabs = [rng.randint(-1, 7, (3, 4)).astype(np.int32),
            rng.randint(0, max_bins, (3, 4)).astype(np.int32),
            rng.randint(0, 8, (3, 4)).astype(np.int32),
            rng.randint(0, 8, (3, 4)).astype(np.int32)]
    assert torch.equal(impl._reassign(got.bins, pos, *tabs),
                       impl._reassign(wide.bins, pos, *tabs))
    from cycloneml_tpu_torch.ml.classification.trees import _unbin
    np.testing.assert_array_equal(_unbin(got), _unbin(wide))


def test_past_256_bins_are_int32(pctx):
    rng = np.random.RandomState(23)
    ds = InstanceDataset.from_numpy(pctx, rng.randn(3000, 3))
    binned = impl.BinnedDataset.from_instance_dataset(ds, 300, 5)
    assert binned.bins.dtype == torch.int32 and binned.max_bins > 256


def _lane_row_sum(vals, cell=0, half=0, piece_rows=kernels.TREE_PIECE_ROWS,
                  flush_rows=128):
    """The lane-a-row instance's order for one cell whose rows are all
    ``vals`` (float32, sorted order), in numpy: the feature's 16 lane
    copies (slots 16 half .. 16 half + 15 of the cell's 32) and each
    piece's blocks of 16 x flush_rows rows, lane l summing rows l, l + 16,
    ... in float32; at a block's end the lane partials added into the
    piece's double four slots at a time, groups q = (cell + g) mod 8 for
    g = 0 .. 7 (slots 4q .. 4q + 3) that are the feature's; the piece
    rounded to float32; the pieces added in double, rounded once to
    float32."""
    total = 0.0
    block = 16 * flush_rows
    slots = [4 * q + r - 16 * half for q in ((cell + g) % 8 for g in range(8))
             if q // 4 == half for r in range(4)]
    for p0 in range(0, len(vals), piece_rows):
        piece = vals[p0:p0 + piece_rows]
        acc = 0.0
        for b0 in range(0, len(piece), block):
            blk = piece[b0:b0 + block]
            rows = np.zeros(block, dtype=np.float32)
            rows[:len(blk)] = blk
            lanes = np.zeros(16, dtype=np.float32)
            for r in rows.reshape(flush_rows, 16):  # float32, row by row
                lanes = lanes + r
            for s in slots:
                acc += float(lanes[s])
        total += float(np.float32(acc))
    return np.float32(total)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lane_row_order_stays_within_its_bound(seed):
    """Thousands of GBT-like residuals in one bin (a node of bf16-valued
    features puts them there): the kernel's order stays within
    (kFlushRows + 1) float roundings of the float64 sum, relative to the
    magnitudes, where a float32 running sum need not."""
    rng = np.random.RandomState(seed)
    n = 30_011
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    vals = ((rng.rand(n) < 0.5) - p).astype(np.float32)
    exact = vals.astype(np.float64).sum()
    mag = np.abs(vals.astype(np.float64)).sum()
    for cell, half in ((0, 0), (17, 0), (5, 1), (40, 1)):
        got = _lane_row_sum(vals, cell=cell, half=half)
        assert abs(float(got) - exact) <= 129 * 2.0 ** -24 * mag


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
    # one-byte bins: the same table, bit for bit
    narrow = kernels.tree_hist_plain(torch.from_numpy(bins.astype(np.uint8)),
                                     torch.from_numpy(chans),
                                     torch.from_numpy(pos), a_pad, B)
    assert torch.equal(narrow, got)
    # the wrapper on CPU tensors is the twin, and launches nothing
    kernels.reset_launch_counts()
    again = kernels.tree_hist(torch.from_numpy(bins), torch.from_numpy(chans),
                              torch.from_numpy(pos), a_pad, B)
    assert torch.equal(again, got) and kernels.tree_hist.launches == 0


def _pieces_numpy(order, offsets, tg, a_pad, piece_rows, n_windows):
    """The yardstick of the piece table, in numpy loops: window by window
    (piece_rows x a_pad rows each; one window: every row), key by key,
    the key's sorted rows
    whose row (``order`` value // tg) falls in the window, cut in order
    into pieces of ``piece_rows``; each piece's (key, first, length)."""
    window = piece_rows * a_pad if n_windows > 1 else 2 ** 62
    out = []
    for w in range(n_windows):
        for k in range(len(offsets) - 1):
            pos = [i for i in range(offsets[k], offsets[k + 1])
                   if w * window <= order[i] // tg < (w + 1) * window]
            for j in range(0, len(pos), piece_rows):
                out.append((k, pos[j], len(pos[j:j + piece_rows])))
    return out


def _piece_inputs(case, n=5000, tg=3, a_pad=4, seed=4):
    """The sort of random positions (some rows out of a tree), every row
    at one node, or no rows at all."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(-1, a_pad, size=(n, tg)).astype(np.int32)
    if case == "one_key":
        pos[:] = -1
        pos[:, 1] = 2
    elif case == "no_rows":
        pos[:] = -1
    elif case == "empty_keys":
        pos[pos == 1] = -1
    p = torch.from_numpy(pos)
    order, offsets = kernels.tree_order(kernels.tree_keys(p, 0, tg, a_pad),
                                        tg * a_pad)
    return order, offsets


PIECE_CASES = ["random", "empty_keys", "one_key", "no_rows"]


@pytest.mark.parametrize("windows", ["many", "one"])
@pytest.mark.parametrize("case", PIECE_CASES)
def test_tree_pieces_on_the_card_equal_the_numpy_table(case, windows):
    """The piece table the card builds (its torch twin here) equals the
    numpy loops: windows of piece_rows x a_pad rows in order (or one of
    every row), in each the keys' sorted rows cut into pieces; past the
    real count every piece is empty; each key's pieces cover its rows in
    order."""
    tg, a_pad, piece_rows = 3, 4, 64
    order, offsets = _piece_inputs(case, tg=tg, a_pad=a_pad)
    k = tg * a_pad
    n_windows = -(-5000 // (piece_rows * a_pad)) if windows == "many" else 1
    bound = -(-5000 * tg // piece_rows) + k * n_windows
    seg, table = kernels.tree_pieces(order, offsets, tg, a_pad, piece_rows,
                                     n_windows, bound)
    want = _pieces_numpy(order.numpy(), offsets.numpy(), tg, a_pad,
                         piece_rows, n_windows)
    n = len(want)
    assert int(seg[-1]) == n <= bound
    np.testing.assert_array_equal(table[:, :n].T.numpy(),
                                  np.array(want, dtype=np.int64).reshape(n, 3))
    assert (table[0, n:] == k).all() and (table[1:, n:] == 0).all()
    for key in range(k):
        mine = [(int(f), int(m)) for kk, f, m in table[:, :n].T.tolist()
                if kk == key for _ in [0]]
        covered = sorted(i for f, m in mine for i in range(f, f + m))
        assert covered == list(range(int(offsets[key]),
                                     int(offsets[key + 1])))


def test_tree_pieces_cover_every_key_in_order():
    """The pieces of a launch: each key's sorted rows cut in order into
    pieces of at most piece_rows (a key with no rows has none), the
    entries past the real count empty; the piece size and windows from
    shapes alone, the size doubled until the bound on the pieces fits the
    budget."""
    pos = np.full((20_001, 1), 2, dtype=np.int32)
    pos[[3, 700, 9000, 15_000, 20_000], 0] = 1
    pos[12_345, 0] = 3
    p = torch.from_numpy(pos)
    order, offsets = kernels.tree_order(kernels.tree_keys(p, 0, 1, 4), 4)
    assert offsets.tolist() == [0, 0, 5, 20_000, 20_001]
    rows, windows, bound = kernels.tree_piece_rows(20_001, 20_001, 4, 4,
                                                   dbc=10, out_elems=40)
    assert rows == kernels.TREE_PIECE_ROWS and windows == 1
    assert bound == -(-20_001 // rows) + 4
    seg, table = kernels.tree_pieces(order, offsets, 1, 4, rows, windows,
                                     bound)
    n = int(seg[-1])
    assert n == 1 + -(-19_995 // rows) + 1
    for key in range(4):
        got = [(f, m) for k, f, m in table[:, :n].T.tolist() if k == key]
        assert all(m <= rows for _, m in got)
        covered = [i for f, m in got for i in range(f, f + m)]
        assert covered == list(range(offsets[key], offsets[key + 1]))
    assert table[2, n:].tolist() == [0] * (bound - n)
    # a budget of about one table a key forces pieces of whole keys
    big, windows, n_big = kernels.tree_piece_rows(
        20_001, 20_001, 4, 1, dbc=kernels.TREE_SCRATCH_BYTES // 20,
        out_elems=1)
    assert big >= 20_001 and windows == 1 and n_big == 5


def test_tree_keys_are_row_major_and_sort_each_node_in_row_order():
    """The sort's keys: tree x a_pad + node at row x trees + tree, -1 out
    of a tree; sorted stably, each (tree, node)'s rows come in row order."""
    pos = np.array([[0, -1, 1], [1, 0, -1], [0, 0, 1]], dtype=np.int32)
    keys = kernels.tree_keys(torch.from_numpy(pos), 0, 3, 2)
    assert keys.tolist() == [0, -1, 5, 1, 2, -1, 0, 2, 5]
    assert torch.equal(kernels.tree_keys(torch.from_numpy(pos), 1, 2, 2),
                       kernels.tree_keys_plain(torch.from_numpy(pos[:, 1:]),
                                               2))
    order, offsets = kernels.tree_order(keys, 6)
    assert offsets.tolist() == [0, 2, 3, 5, 5, 5, 7]
    assert order[:7].tolist() == [0, 6, 3, 4, 7, 2, 8]


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


def _cuda_hist_check(n, d, T, C, B, a_pad, seed, dead=0.2,
                     dtype=torch.int32):
    """The kernel against its twin in float64 (counts exactly, sums within
    129 float roundings), twice bitwise; returns the table and the
    instance it took."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bins, chans, pos = _hist_inputs(n, d, T, C, B, a_pad, seed, dead)
    dev = torch.device("cuda")
    b = torch.from_numpy(bins).to(dev).to(dtype)
    c, p = (torch.from_numpy(a).to(dev) for a in (chans, pos))
    kernels.reset_launch_counts()
    got = kernels.tree_hist(b, c, p, a_pad, B)
    again = kernels.tree_hist(b, c, p, a_pad, B)
    torch.cuda.synchronize()
    assert kernels.tree_hist.launches == 2
    instance = kernels.tree_hist_plan(B, C, d, dtype)["instance"]
    assert kernels.tree_hist.launches_by_instance[instance] == 2
    # the twin in float64 (the channels upcast exactly) is the table's
    # truth; the kernel sums blocks of 128 rows a lane in float and the
    # rest in double, so it stays within 129 float roundings of it (the
    # channels here are nonnegative: relative to the cell itself)
    twin = kernels.tree_hist_plain(b, c.double(), p, a_pad, B)
    g, tw = got.double().cpu().numpy(), twin.cpu().numpy()
    np.testing.assert_array_equal(g[..., 0], tw[..., 0])
    np.testing.assert_allclose(g, tw, rtol=129 * 2.0 ** -24, atol=1e-30)
    assert torch.equal(got, again)
    return got, instance


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 32, 33, 64, 255, 256, 257])
@pytest.mark.parametrize("T", [1, 20])
@pytest.mark.parametrize("C", [3, 4, 11])
@pytest.mark.parametrize("width", ["uint8", "int32"])
def test_cuda_tree_hist_matches_its_twin(B, T, C, width):
    """maxBins 2 to 257 on one-byte and int32 bins (one byte up to 256);
    1 and 20 trees; 2 and 10 classes (C = 3, 11); regression channels (C =
    4); d = 7 (a ragged feature block). B = 255-257 at C = 11 take the
    lane-a-bin instance (one feature's lane copies past an H100's 227 KB
    of shared memory a CTA), the rest the lane-a-row one."""
    if width == "uint8" and B > 256:
        pytest.skip("one-byte bins hold at most 256 bins")
    dtype = torch.uint8 if width == "uint8" else torch.int32
    _, instance = _cuda_hist_check(20_011 if T > 1 else 50_021, 7, T, C, B,
                                   8, seed=B + T, dtype=dtype)
    wide = B * C * 136 + 2 * 256 * (1 + (C | 1)) * 4 > 232_448
    assert instance == (kernels.LANE_A_BIN if wide else kernels.LANE_A_ROW)


@pytest.mark.gpu
@pytest.mark.parametrize("B,C", [(32, 3), (256, 4), (256, 11), (64, 11)])
def test_cuda_one_byte_bins_give_the_int32_bits(B, C):
    """The kernel on uint8 bins (rows padded to 4 bytes) equals the kernel
    on int32 bins bitwise, in either instance; a contiguous 7-wide uint8
    tensor, whose rows its 4-byte copies cannot start on, raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bins, chans, pos = _hist_inputs(60_013, 7, 3, C, B, 16, seed=C)
    dev = torch.device("cuda")
    c, p = (torch.from_numpy(a).to(dev) for a in (chans, pos))
    wide = kernels.tree_hist(torch.from_numpy(bins).to(dev), c, p, 16, B)
    padded = torch.zeros((60_013, 8), dtype=torch.uint8, device=dev)
    padded[:, :7] = torch.from_numpy(bins.astype(np.uint8)).to(dev)
    assert torch.equal(kernels.tree_hist(padded[:, :7], c, p, 16, B), wide)
    with pytest.raises(ValueError, match="4-byte boundary"):
        kernels.tree_hist(padded[:, :7].contiguous(), c, p, 16, B)


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [-(-50_000 // 512), 1])
@pytest.mark.parametrize("case", PIECE_CASES)
def test_cuda_piece_table_is_its_twins(case, windows):
    """The segments and the piece table the kernels build on the card
    equal their torch twin, past the real count too, in windows of 512
    rows and in one window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    order, offsets = (t.to(dev) for t in _piece_inputs(case, n=50_000,
                                                        a_pad=8))
    lp = kernels.TreeLaunch(order, offsets, 24, 64, windows,
                            -(-150_000 // 64) + 24 * windows)
    scratch = kernels.tree_launch_scratch(lp, 3)
    empty = torch.empty(1, device=dev)
    kernels._tree_launch(torch.zeros((1, 4), dtype=torch.uint8, device=dev),
                         torch.zeros((1, 1, 3), device=dev), lp, 0, 8, 32,
                         scratch, empty, stages=1)
    seg, table = kernels.tree_pieces(order, offsets, 3, 8, 64, lp.n_windows,
                                     lp.max_pieces)
    assert torch.equal(scratch[0], seg)
    assert torch.equal(scratch[1].view(3, -1), table)


@pytest.mark.gpu
def test_cuda_tree_keys_are_the_plain_keys():
    """``tree_keys_kernel`` gives the plain keys, row-major, for a group of
    trees inside a forest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, pos = _hist_inputs(30_011, 3, 20, 3, 8, 64, seed=5)
    p = torch.from_numpy(pos).to("cuda")
    got = kernels.tree_keys(p, 3, 11, 64)
    assert torch.equal(got, kernels.tree_keys_plain(p[:, 3:14], 64))


@pytest.mark.gpu
def test_cuda_tree_hist_reads_nothing_back():
    """No host synchronisation inside tree_hist: the piece table is built
    on the card, at a DecisionTree's and a deep forest level, and past the
    counting sort's keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for T, a_pad in ((1, 1), (20, 32), (2, 4096)):
        bins, chans, pos = _hist_inputs(100_003, 28, T, 3, 32, a_pad, seed=T)
        b = torch.from_numpy(bins.astype(np.uint8)).to(dev)
        c, p = (torch.from_numpy(a).to(dev) for a in (chans, pos))
        kernels.tree_hist(b, c, p, a_pad, 32)  # built and planned first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = kernels.tree_hist(b, c, p, a_pad, 32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.isfinite(out).all()


@pytest.mark.gpu
def test_cuda_tree_hist_sums_in_the_modelled_order():
    """One key's 50,021 rows in one bin: each cell is, bit for bit, the
    numpy model of the lane-a-row order (pieces of 8,192 rows, blocks of
    2,048, 16 lanes a feature in float32, the lane partials in the order
    of groups of four slots (cell + g) mod 8 in double), for both features
    of a pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(9)
    n, C = 50_021, 4
    p = 1.0 / (1.0 + np.exp(-rng.randn(n)))
    chans = ((rng.rand(n, 1, C) < 0.5) - p[:, None, None]).astype(np.float32)
    dev = torch.device("cuda")
    b = torch.zeros((n, 4), dtype=torch.uint8, device=dev)[:, :2]
    b[:, 1] = 1
    got = kernels.tree_hist(b, torch.from_numpy(chans).to(dev),
                            torch.zeros((n, 1), dtype=torch.int32,
                                        device=dev), 1, 2).cpu().numpy()
    assert kernels.tree_hist_plan(2, C, 2)["instance"] == kernels.LANE_A_ROW
    for f in range(2):  # feature f's rows all in bin f: cell f x C + c
        for c in range(C):
            assert got[0, 0, f, f, c] == _lane_row_sum(
                chans[:, 0, c], cell=f * C + c, half=f)
            assert got[0, 0, f, 1 - f, c] == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,a_pad,dead", [
    (200_003, 28, 1, 0.0), (100_000, 9, 64, 0.5), (30_000, 3, 4096, 0.1),
    (20_000, 33, 8192, 0.3), (1000, 5, 2, 1.0)])
def test_cuda_tree_hist_shapes(n, d, a_pad, dead):
    """One node holding every row (many pieces of one key), deep levels
    past the counting sort's keys, d past one feature block, every row at
    -1."""
    _cuda_hist_check(n, d, 2, 3, 32, a_pad, seed=d, dead=dead,
                     dtype=torch.uint8)


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
