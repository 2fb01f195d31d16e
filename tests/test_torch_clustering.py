"""The rest of the clustering family in the port — BisectingKMeans,
GaussianMixture, LDA and PowerIterationClustering — against the JAX
package's, on the same seeded numpy inputs.

- In float64 (``cyclone.compute.dtype=float64`` on the CPU), at rtol 1e-8:
  GaussianMixture's weights, means, covariances, log-likelihood and
  iteration count; BisectingKMeans' tree (``node_index``, every node's
  center), leaf centers and costs, euclidean and cosine, weighted; LDA's
  lambda at ``subsamplingRate=1.0`` (online and em), its bound and
  perplexity; PowerIterationClustering's embedding (the reference's read
  where its 1-D k-means receives it) and labels, for both init modes.
  Both packages draw every random number from ``RandomState(seed)`` in
  the same order; the sums differ only in their order (the port's center
  sums and chunked E-steps against the reference's one-hot and whole-
  block products).
- The reference's golden GaussianMixture cases
  (tests/test_ref_golden_parity.py ``test_gmm_golden``: R's mvnormalmixEM
  and the suite's univariate data) on the port, at absTol 1e-3.
- The online LDA's mini-batch mask is the port's own (a ``torch.Generator``
  seeded by a SplitMix64 mix of (seed, iteration)): one seed replays
  exactly.

The ``gpu`` tests run BisectingKMeans through the center sums (float32
and float64 X) and PowerIterationClustering through S2 (float32) and the
center sums (float64) on the card: launches counted, two fits bitwise
equal, against their plain versions. The card's machine has
no jax, so the reference is imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_clustering.py
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.clustering import (
    LDA, BisectingKMeans, BisectingKMeansModel, GaussianMixture,
    GaussianMixtureModel, LDAModel, PowerIterationClustering,
)
from cycloneml_tpu_torch.ml.clustering import lda as lda_mod
from cycloneml_tpu_torch.ml.clustering import power_iteration as pic_mod
from cycloneml_tpu_torch.ml.clustering.gaussian_mixture import e_step
from cycloneml_tpu_torch.ops import kernels

RTOL = 1e-8


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ref():
    import cycloneml_tpu.ml.clustering as r
    from cycloneml_tpu.dataset.frame import MLFrame as RFrame
    return types.SimpleNamespace(
        MLFrame=RFrame, **{n: getattr(r, n) for n in r.__all__})


# -- GaussianMixture -----------------------------------------------------------

def _gmm_data(n, d, k, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(k, d) * 5
    labels = rng.randint(0, k, n)
    scales = rng.rand(k, d) * 0.8 + 0.3
    return means[labels] + rng.randn(n, d) * scales[labels]


def _assert_same_gmm(got, ref, rtol=RTOL):
    assert got.num_iterations == ref.num_iterations
    np.testing.assert_allclose(got.weights, ref.weights, rtol=rtol)
    np.testing.assert_allclose(got._means, np.asarray(ref._means),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got._covs, np.asarray(ref._covs),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.log_likelihood, ref.log_likelihood,
                               rtol=rtol)


@pytest.mark.parametrize("n,d,k,seed,kw", [
    (300, 2, 3, 0, dict(maxIter=40, tol=1e-7)),
    (457, 4, 3, 1, dict(maxIter=15, tol=0.0)),
    (200, 3, 2, 2, dict(maxIter=100)),
    (50, 2, 30, 3, dict(maxIter=5)),        # degenerate slices: global moments
])
def test_f64_gmm_matches_reference(ctx, pctx, n, d, k, seed, kw):
    x = _gmm_data(n, d, min(k, 4), seed)
    cols = {"features": x}
    ref = _ref().GaussianMixture(k=k, seed=seed + 5, **kw).fit(
        _ref().MLFrame(ctx, cols))
    got = GaussianMixture(k=k, seed=seed + 5, **kw).fit(MLFrame(pctx, cols))
    _assert_same_gmm(got, ref)
    probe = x[:17]
    np.testing.assert_allclose(
        got.transform(MLFrame(pctx, {"features": probe}))["probability"],
        ref.transform(_ref().MLFrame(ctx, {"features": probe}))["probability"],
        rtol=1e-7, atol=1e-12)
    assert got.predict(probe[0]) == ref.predict(probe[0])
    np.testing.assert_allclose(got.predict_probability(probe[1]),
                               ref.predict_probability(probe[1]),
                               rtol=1e-7, atol=1e-12)
    for g, r in zip(got.gaussians, ref.gaussians):
        np.testing.assert_allclose(g.mean, r.mean, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(g.cov, r.cov, rtol=RTOL, atol=RTOL)


def test_f64_weighted_gmm_matches_reference(ctx, pctx):
    rng = np.random.RandomState(9)
    x = np.concatenate([rng.randn(50, 2) - 5, rng.randn(500, 2) + 5])
    w = np.concatenate([np.full(50, 10.0), np.ones(500)])
    cols = {"features": x, "w": w}
    kw = dict(k=2, seed=5, maxIter=50, weightCol="w")
    ref = _ref().GaussianMixture(**kw).fit(_ref().MLFrame(ctx, cols))
    got = GaussianMixture(**kw).fit(MLFrame(pctx, cols))
    _assert_same_gmm(got, ref)
    assert 0.25 < got.weights.min() < 0.75


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 15])
def test_gmm_e_step_chunks_agree_with_one_block(chunk):
    """The E-step's sums are the same (to float64 rounding) whatever the
    row chunk, padding rows (w = 0) contributing nothing."""
    rng = np.random.RandomState(4)
    x = torch.as_tensor(rng.randn(101, 3))
    w = torch.as_tensor(np.r_[rng.rand(95) + 0.5, np.zeros(6)])
    wts = torch.as_tensor([0.3, 0.7], dtype=torch.float64)
    mus = torch.as_tensor(rng.randn(2, 3))
    a = rng.randn(2, 3, 3)
    chols = torch.linalg.cholesky(torch.as_tensor(
        a @ a.transpose(0, 2, 1) + np.eye(3)))
    got = e_step(x, w, wts, mus, chols, chunk_rows=chunk)
    full = e_step(x[:95], w[:95], wts, mus, chols, chunk_rows=1000)
    for key in full:
        np.testing.assert_allclose(got[key].numpy(), full[key].numpy(),
                                   rtol=1e-12, atol=1e-12)


def _golden_cases():
    path = os.path.join(os.path.dirname(__file__), "ref_parity",
                        "golden.json")
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)["gmm"]


@pytest.mark.parametrize("case", _golden_cases(), ids=lambda c: c["id"])
def test_gmm_golden(pctx, case):
    """The reference suite's committed mixtures (R mixtools' mvnormalmixEM
    constants among them) on the port, sorted by weight, at absTol 1e-3
    (GaussianMixtureSuite.scala:329-340)."""
    from tests.test_ref_golden_parity import _dataset
    frame = MLFrame(pctx, _dataset(case["dataset"]))
    model = GaussianMixture(k=case["k"], seed=11, maxIter=200,
                            tol=1e-6).fit(frame)
    got = sorted(zip(model.weights, model._means, model._covs),
                 key=lambda t: t[0])
    tol = case["abs_tol"]
    for (w, mu, cov), ew, emu, ecov in zip(
            got, case["weights"], case["means"], case["covs"]):
        np.testing.assert_allclose(w, ew, atol=tol, rtol=0)
        np.testing.assert_allclose(mu, emu, atol=tol, rtol=0)
        np.testing.assert_allclose(cov, ecov, atol=tol, rtol=0)
    if "log_likelihood" in case:
        np.testing.assert_allclose(model.log_likelihood,
                                   case["log_likelihood"],
                                   atol=case["llk_abs_tol"], rtol=0)


# -- BisectingKMeans -----------------------------------------------------------

def _blobs(n, d, k, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * spread
    return centers[rng.randint(k, size=n)] + rng.randn(n, d)


def _assert_same_tree(got, ref, frame, rframe, rtol=RTOL):
    np.testing.assert_array_equal(got._node_index, np.asarray(ref._node_index))
    assert sorted(got._tree) == sorted(ref._tree)
    for node in ref._tree:
        np.testing.assert_allclose(got._tree[node], ref._tree[node],
                                   rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got._centers, np.asarray(ref._centers),
                               rtol=rtol, atol=rtol)
    np.testing.assert_allclose(got.compute_cost(frame),
                               ref.compute_cost(rframe), rtol=rtol)
    np.testing.assert_array_equal(got.transform(frame)["prediction"],
                                  ref.transform(rframe)["prediction"])


@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,d,k,seed,kw", [
    (400, 3, 5, 0, dict(maxIter=20)),
    (333, 5, 8, 1, dict(maxIter=5)),
    (500, 2, 6, 2, dict(maxIter=30, minDivisibleClusterSize=0.2)),
])
def test_f64_bisecting_kmeans_matches_reference(ctx, pctx, measure, n, d, k,
                                                seed, kw):
    x = _blobs(n, d, 6, seed) + (3.0 if measure == "cosine" else 0.0)
    cols = {"features": x}
    kw = dict(kw, k=k, seed=seed + 3, distanceMeasure=measure)
    frame, rframe = MLFrame(pctx, cols), _ref().MLFrame(ctx, cols)
    ref = _ref().BisectingKMeans(**kw).fit(rframe)
    got = BisectingKMeans(**kw).fit(frame)
    _assert_same_tree(got, ref, frame, rframe)
    assert len(got.level_passes) >= 1
    assert all(1 <= p <= kw["maxIter"] for p in got.level_passes)


def test_f64_weighted_bisecting_kmeans_matches_reference(ctx, pctx):
    x = _blobs(300, 3, 4, 5)
    w = np.random.RandomState(6).rand(300) * 2 + 0.1
    cols = {"features": x, "w": w}
    kw = dict(k=4, seed=2, maxIter=25, weightCol="w")
    frame, rframe = MLFrame(pctx, cols), _ref().MLFrame(ctx, cols)
    _assert_same_tree(BisectingKMeans(**kw).fit(frame),
                      _ref().BisectingKMeans(**kw).fit(rframe), frame, rframe)


def test_bisecting_kmeans_gates_match_reference(ctx, pctx):
    """The divisibility gates: a zero-cost cluster is not split, and a
    minimum size stops the tree early, as in the reference."""
    rng = np.random.RandomState(26)
    x = np.concatenate([np.zeros((50, 2)), rng.randn(50, 2) + 10,
                        rng.randn(10, 2) - 40])
    cols = {"features": x}
    frame, rframe = MLFrame(pctx, cols), _ref().MLFrame(ctx, cols)
    for kw in (dict(k=6, seed=1), dict(k=8, seed=1,
                                       minDivisibleClusterSize=40.0)):
        got = BisectingKMeans(**kw).fit(frame)
        _assert_same_tree(got, _ref().BisectingKMeans(**kw).fit(rframe),
                          frame, rframe)
    assert len(np.unique(got.transform(frame)["prediction"][:50])) == 1


# -- LDA -----------------------------------------------------------------------

def _corpus(n_docs=120, vocab=30, k=3, seed=41, length=50):
    rng = np.random.RandomState(seed)
    beta = rng.dirichlet(np.full(vocab, 0.1), size=k)
    theta = rng.dirichlet(np.full(k, 0.3), size=n_docs)
    docs = np.zeros((n_docs, vocab))
    for i in range(n_docs):
        words = rng.choice(vocab, size=length, p=theta[i] @ beta)
        docs[i] = np.bincount(words, minlength=vocab)
    return docs


@pytest.mark.parametrize("optimizer,kw", [
    ("online", dict(subsamplingRate=1.0, maxIter=12)),
    ("online", dict(subsamplingRate=1.0, maxIter=6, learningOffset=10.0,
                    learningDecay=0.7, docConcentration=0.2,
                    topicConcentration=0.05)),
    ("em", dict(maxIter=10)),
])
def test_f64_lda_matches_reference(ctx, pctx, optimizer, kw):
    docs = _corpus()
    cols = {"features": docs}
    frame, rframe = MLFrame(pctx, cols), _ref().MLFrame(ctx, cols)
    kw = dict(kw, k=3, seed=7, optimizer=optimizer)
    ref = _ref().LDA(**kw).fit(rframe)
    got = LDA(**kw).fit(frame)
    np.testing.assert_allclose(got._lam, ref._lam, rtol=RTOL)
    assert (got._alpha, got._eta, got.vocab_size) == \
        (ref._alpha, ref._eta, ref.vocab_size)
    np.testing.assert_allclose(got.topics_matrix(), ref.topics_matrix(),
                               rtol=RTOL)
    for (gi, gw), (ri, rw) in zip(got.describe_topics(5),
                                  ref.describe_topics(5)):
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gw, rw, rtol=RTOL)
    np.testing.assert_allclose(got.log_likelihood(frame),
                               ref.log_likelihood(rframe), rtol=RTOL)
    np.testing.assert_allclose(got.log_perplexity(frame),
                               ref.log_perplexity(rframe), rtol=RTOL)
    np.testing.assert_allclose(
        got.transform(frame)["topicDistribution"],
        ref.transform(rframe)["topicDistribution"], rtol=1e-7, atol=1e-12)


def test_lda_bound_chunks_agree(pctx, monkeypatch):
    """The bound is the same whatever the row chunk it is scored in."""
    docs = _corpus(n_docs=40, seed=3)
    frame = MLFrame(pctx, {"features": docs})
    model = LDA(k=3, seed=2, maxIter=4, subsamplingRate=1.0).fit(frame)
    whole = model.log_likelihood(frame)
    monkeypatch.setattr(lda_mod, "SCORE_ELEMS", 3 * 30 * 3)
    np.testing.assert_allclose(model.log_likelihood(frame), whole,
                               rtol=1e-12)


def test_lda_online_mask_replays_with_one_seed(pctx):
    """The mini-batch mask below rate 1: one seed replays exactly, another
    seed draws other batches, each iteration another batch."""
    docs = _corpus(n_docs=200, seed=5)
    frame = MLFrame(pctx, {"features": docs})
    kw = dict(k=3, maxIter=6, subsamplingRate=0.3, optimizer="online")
    a = LDA(seed=11, **kw).fit(frame)
    b = LDA(seed=11, **kw).fit(frame)
    c = LDA(seed=12, **kw).fit(frame)
    np.testing.assert_array_equal(a._lam, b._lam)
    assert not np.array_equal(a._lam, c._lam)
    from cycloneml_tpu_torch.ml.optim.gradient_descent import mask_seed
    assert mask_seed(11, 0) != mask_seed(11, 1) != mask_seed(12, 1)


def test_lda_em_batch_mode_is_normalized(pctx):
    frame = MLFrame(pctx, {"features": _corpus(seed=42)})
    lda = LDA(k=2, seed=1, maxIter=30, optimizer="em").fit(frame)
    assert np.all(np.isclose(lda.topics_matrix().sum(0), 1.0, atol=1e-6))


# -- PowerIterationClustering --------------------------------------------------

def _graph(seed, n_per=20, p_in=0.4, p_out=0.02, weighted=True):
    rng = np.random.RandomState(seed)
    n = 2 * n_per
    src, dst = np.triu_indices(n, 1)
    same = (src < n_per) == (dst < n_per)
    keep = rng.rand(len(src)) < np.where(same, p_in, p_out)
    src, dst = src[keep], dst[keep]
    ids = rng.permutation(10 * n)[:n] * 7 + 3  # arbitrary ids
    cols = {"src": ids[src].astype(np.float64),
            "dst": ids[dst].astype(np.float64)}
    if weighted:
        cols["weight"] = rng.rand(len(src)) + 0.1
    return cols


@pytest.mark.parametrize("init", ["random", "degree"])
@pytest.mark.parametrize("seed,weighted,max_iter", [
    (0, True, 20), (1, False, 30), (2, True, 500)])
def test_f64_pic_matches_reference(ctx, pctx, monkeypatch, init, seed,
                                   weighted, max_iter):
    """The embedding (the reference's as its 1-D k-means receives it) to
    1e-8, the same steps, the same ids and labels."""
    import cycloneml_tpu.ml.clustering.power_iteration as rpic
    seen = []
    k1d = rpic._kmeans_1d

    def spy(v, k, rng):
        seen.append(np.array(v))
        return k1d(v, k, rng)

    monkeypatch.setattr(rpic, "_kmeans_1d", spy)
    cols = _graph(seed, weighted=weighted)
    kw = dict(k=2, seed=seed + 1, initMode=init, maxIter=max_iter)
    if weighted:
        kw["weightCol"] = "weight"
    ref = _ref().PowerIterationClustering(**kw).assign_clusters(
        _ref().MLFrame(ctx, cols))
    frame = MLFrame(pctx, cols)
    pic = PowerIterationClustering(**kw)
    emb = pic._embedding(frame, np.random.RandomState(seed + 1))
    np.testing.assert_allclose(emb.values, seen[0], rtol=RTOL, atol=1e-14)
    assert emb.iterations <= max_iter
    got = pic.assign_clusters(frame)
    np.testing.assert_array_equal(got["id"], ref["id"])
    np.testing.assert_array_equal(got["cluster"], ref["cluster"])


def test_pic_relabels_as_the_references_dict():
    """np.unique + searchsorted gives each id the label the reference's
    dict over the sorted unique ids gives."""
    rng = np.random.RandomState(3)
    src = rng.randint(-50, 10 ** 6, 400)
    dst = rng.randint(-50, 10 ** 6, 400)
    ids = np.unique(np.concatenate([src, dst]))
    lookup = {int(v): i for i, v in enumerate(ids)}
    np.testing.assert_array_equal(np.searchsorted(ids, src),
                                  [lookup[int(v)] for v in src])
    np.testing.assert_array_equal(np.searchsorted(ids, dst),
                                  [lookup[int(v)] for v in dst])


def test_pic_rejects_bad_graphs(pctx):
    pic = PowerIterationClustering(k=2, weightCol="weight")
    with pytest.raises(ValueError, match="non-negative"):
        pic.assign_clusters(MLFrame(pctx, {"src": [0.0], "dst": [1.0],
                                           "weight": [-1.0]}))
    with pytest.raises(ValueError, match="positive degree"):
        pic.assign_clusters(MLFrame(pctx, {"src": [0.0, 1.0],
                                           "dst": [1.0, 2.0],
                                           "weight": [1.0, 0.0]}))


@pytest.mark.parametrize("mode,dev,dtype,route", [
    ("auto", "cuda", torch.float32, pic_mod.S2),
    ("true", "cuda", torch.float32, pic_mod.S2),
    ("auto", "cuda", torch.float64, pic_mod.SUMS),
    ("true", "cuda", torch.float64, pic_mod.SUMS),
    ("false", "cuda", torch.float32, pic_mod.PLAIN),
    ("false", "cuda", torch.float64, pic_mod.PLAIN),
    ("auto", "cpu", torch.float32, pic_mod.PLAIN),
    ("true", "cpu", torch.float64, pic_mod.PLAIN),
])
def test_pic_step_route_follows_the_compute_dtype(mode, dev, dtype, route):
    """S2 (float32 values) only at a float32 accumulator on the card; a
    float64 fit there takes the center sums, which read float64."""
    assert pic_mod.step_route(mode, torch.device(dev), dtype) == route


@pytest.mark.parametrize("init", ["random", "degree"])
def test_pic_center_sums_route_matches_plain(pctx, monkeypatch, init):
    """The float64 card route's step (the center sums, one cluster a
    vertex; their plain version on the CPU) gives the plain route's
    embedding and steps."""
    cols = _graph(4, weighted=True)
    kw = dict(k=2, seed=9, initMode=init, maxIter=40, weightCol="weight")
    frame = MLFrame(pctx, cols)
    plain = PowerIterationClustering(**kw)._embedding(
        frame, np.random.RandomState(9))
    monkeypatch.setattr(pic_mod, "step_route",
                        lambda mode, dev, dtype: pic_mod.SUMS)
    sums = PowerIterationClustering(**kw)._embedding(
        frame, np.random.RandomState(9))
    assert sums.iterations == plain.iterations
    np.testing.assert_allclose(sums.values, plain.values, rtol=1e-12,
                               atol=0)


def test_power_iterate_stops_on_acceleration():
    """The stop: steps end when |delta_t - delta_{t-1}| < 1e-5/n."""
    v = torch.tensor([0.25, 0.75], dtype=torch.float64)
    out, steps = pic_mod.power_iterate(lambda t: t.flip(0), v, 100, 2)
    # delta is 1.0 every step: the second step's acceleration is 0
    assert steps == 2
    np.testing.assert_array_equal(out.numpy(), [0.25, 0.75])
    _, steps = pic_mod.power_iterate(lambda t: t.flip(0), v, 1, 2)
    assert steps == 1


# -- models: persistence and the reference's directories ----------------------

def test_models_round_trip_and_load_from_reference(ctx, pctx, tmp_path):
    x = _blobs(200, 3, 4, 8)
    docs = _corpus(n_docs=60, seed=9)
    cols, dcols = {"features": x}, {"features": docs}
    fits = (
        (BisectingKMeans, BisectingKMeansModel, dict(k=4, seed=1), cols,
         "prediction"),
        (GaussianMixture, GaussianMixtureModel, dict(k=3, seed=2, maxIter=10),
         cols, "probability"),
        (LDA, LDAModel, dict(k=3, seed=3, maxIter=5), dcols,
         "topicDistribution"),
    )
    for est, model_cls, kw, c, out_col in fits:
        name = est.__name__
        ref_est = getattr(_ref(), name)
        ref_model = ref_est(**kw).fit(_ref().MLFrame(ctx, c))
        ref_model.save(str(tmp_path / f"ref_{name}"))
        loaded = model_cls.load(str(tmp_path / f"ref_{name}"))
        frame = MLFrame(pctx, c)
        np.testing.assert_allclose(
            loaded.transform(frame)[out_col],
            ref_model.transform(_ref().MLFrame(ctx, c))[out_col],
            rtol=1e-9, atol=1e-12)
        model = est(**kw).fit(frame)
        model.save(str(tmp_path / name))
        back = model_cls.load(str(tmp_path / name))
        assert back.uid == model.uid
        for attr in ("_centers", "_node_index", "weights", "_means", "_covs",
                     "_lam"):
            if hasattr(model, attr):
                a, b = getattr(model, attr), getattr(back, attr)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(back.transform(frame)[out_col],
                                      model.transform(frame)[out_col])


# -- on the card --------------------------------------------------------------

def _cuda_context(**conf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = CycloneConf().set("cyclone.master", "cuda")
    for key, v in conf.items():
        c.set(key, v)
    return CycloneContext(c)


def _same_tree(a, b):
    return (np.array_equal(a._node_index, b._node_index)
            and a._centers.tobytes() == b._centers.tobytes()
            and sorted(a._tree) == sorted(b._tree)
            and all(a._tree[i].tobytes() == b._tree[i].tobytes()
                    for i in a._tree))


@pytest.mark.gpu
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_cuda_bisecting_kmeans_through_the_center_sums(measure):
    """On the card: the sums of every pass and the counts and costs of
    every level through the center sums (passes + 2 a level launches),
    two fits bitwise equal, and the tree of the plain route (index_add_
    sums) with centers within float32 rounding."""
    x = _blobs(20_011, 16, 12, 4, spread=8.0) + 2.0
    kw = dict(k=9, seed=5, maxIter=15, distanceMeasure=measure)
    ctx = _cuda_context()
    try:
        ds = interop.dataset_from_numpy(x, dtype=torch.float32)
        kernels.reset_launch_counts()
        a = BisectingKMeans(**kw).fit(ds)
        launches = kernels.center_sums.launches
        assert launches == sum(a.level_passes) + 2 * len(a.level_passes)
        b = BisectingKMeans(**kw).fit(ds)
        assert _same_tree(a, b)
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        kernels.reset_launch_counts()
        plain = BisectingKMeans(**kw).fit(ds)
        assert kernels.center_sums.launches == 0
        np.testing.assert_array_equal(plain._node_index, a._node_index)
        np.testing.assert_allclose(plain._centers, a._centers, rtol=1e-5,
                                   atol=1e-5)
    finally:
        ctx.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("measure", ["euclidean", "cosine"])
def test_cuda_f64_bisecting_kmeans_through_the_center_sums(measure):
    """On the card at cyclone.compute.dtype=float64 and the default
    usePallasKernels: float64 X through the center sums too (passes + 2 a
    level launches), two fits bitwise equal, and the tree of the explicit
    plain route with centers within float64 rounding."""
    x = _blobs(20_011, 16, 12, 4, spread=8.0) + 2.0
    kw = dict(k=9, seed=5, maxIter=15, distanceMeasure=measure)
    ctx = _cuda_context(**{"cyclone.compute.dtype": "float64"})
    try:
        ds = interop.dataset_from_numpy(x, dtype=torch.float64)
        assert ds.x.dtype == torch.float64 and ds.x.device.type == "cuda"
        kernels.reset_launch_counts()
        a = BisectingKMeans(**kw).fit(ds)
        assert kernels.center_sums.launches == \
            sum(a.level_passes) + 2 * len(a.level_passes)
        b = BisectingKMeans(**kw).fit(ds)
        assert _same_tree(a, b)
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        kernels.reset_launch_counts()
        plain = BisectingKMeans(**kw).fit(ds)
        assert kernels.center_sums.launches == 0
        np.testing.assert_array_equal(plain._node_index, a._node_index)
        np.testing.assert_allclose(plain._centers, a._centers, rtol=1e-10,
                                   atol=1e-12)
    finally:
        ctx.stop()


@pytest.mark.gpu
def test_cuda_f64_pic_through_the_center_sums():
    """On the card at cyclone.compute.dtype=float64: every step through
    the center sums and none through S2 (whose values are float32), two
    runs bitwise equal, and the plain float64 route's steps and embedding
    within float64 rounding."""
    cols = _graph(7, n_per=300, p_in=0.05, p_out=0.002)
    kw = dict(k=2, seed=3, maxIter=15, weightCol="weight")
    ctx = _cuda_context(**{"cyclone.compute.dtype": "float64"})
    try:
        frame = MLFrame(ctx, cols)
        pic = PowerIterationClustering(**kw)
        kernels.reset_launch_counts()
        a = pic._embedding(frame, np.random.RandomState(3))
        assert kernels.center_sums.launches == a.iterations >= 1
        assert kernels.ell_cols.launches == 0
        b = pic._embedding(frame, np.random.RandomState(3))
        assert a.values.tobytes() == b.values.tobytes()
        ctx.conf.set("cyclone.ml.usePallasKernels", "false")
        kernels.reset_launch_counts()
        truth = pic._embedding(frame, np.random.RandomState(3))
        assert kernels.center_sums.launches == 0
        assert truth.iterations == a.iterations
        np.testing.assert_allclose(a.values, truth.values, rtol=1e-12,
                                   atol=0)
    finally:
        ctx.stop()


@pytest.mark.gpu
def test_cuda_pic_through_s2():
    """On the card: one S2 launch a power-iteration step, two runs bitwise
    equal, the embedding within 1e-5 (relative to its largest entry) of
    the float64 plain route (index_add_) after as many steps."""
    cols = _graph(7, n_per=300, p_in=0.05, p_out=0.002)
    kw = dict(k=2, seed=3, maxIter=15, weightCol="weight")
    ctx = _cuda_context()
    try:
        frame = MLFrame(ctx, cols)
        pic = PowerIterationClustering(**kw)
        kernels.reset_launch_counts()
        a = pic._embedding(frame, np.random.RandomState(3))
        assert kernels.ell_cols.launches == a.iterations >= 1
        b = pic._embedding(frame, np.random.RandomState(3))
        assert a.values.tobytes() == b.values.tobytes()
        labels = pic.assign_clusters(frame)["cluster"]
        assert len(labels) == len(a.ids)
    finally:
        ctx.stop()
    ctx = _cuda_context(**{"cyclone.ml.usePallasKernels": "false",
                           "cyclone.compute.dtype": "float64"})
    try:
        kernels.reset_launch_counts()
        pic = PowerIterationClustering(**dict(kw, maxIter=a.iterations))
        truth = pic._embedding(MLFrame(ctx, cols), np.random.RandomState(3))
        assert kernels.ell_cols.launches == 0
        assert truth.iterations == a.iterations
        assert np.abs(a.values - truth.values).max() <= \
            1e-5 * np.abs(truth.values).max()
    finally:
        ctx.stop()
