"""The feature transformers and ``ml/stat/tests.py`` in the port, against
the JAX package's, on the same seeded numpy inputs.

- Every case of the reference's ``tests/test_feature.py`` and
  ``tests/test_formula.py`` runs on the port (``cyclone.master=cpu``,
  ``cyclone.compute.dtype=float64``) with the reference's assertions, but
  the three ``SQLTransformer`` cases: ``SQLTransformer`` raises
  ``NotImplementedError`` naming ROADMAP Queue 1 item 12, when built and
  when a saved one is loaded. The Word2Vec oracle cases are in
  ``tests/test_torch_word2vec.py``.
- The reference's three ``ml/stat`` cases of ``tests/test_evaluation_
  tuning.py`` (chi-squared, ANOVA/F-value/KS, correlation) run on the
  port, and the results equal the reference's exactly (the same host
  numpy and scipy).
- Every fitted feature model, fitted by both packages on the same
  columns, transforms equally: exactly for the host statistics, within
  rtol 1e-12 where the device ``Summarizer`` fits them (the scalers; the
  two sum their moments in other orders). A model the reference saved
  loads in the port and transforms as the reference's does; so does the
  same model carried across by ``interop.feature_model_from_reference``.

These modules add no kernel: they are host numpy, as the reference's are
(its scalers fit on the device Summarizer, which is the port's too).
"""

import os
import types

import numpy as np
import pytest

from cycloneml_tpu_torch import CycloneConf, CycloneContext, interop
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml import util_io
from cycloneml_tpu_torch.ml.feature import (
    Binarizer, Bucketizer, BucketedRandomProjectionLSH, ChiSqSelector,
    CountVectorizer, DCT, ElementwiseProduct, FeatureHasher, HashingTF, IDF,
    Imputer, IndexToString, Interaction, MaxAbsScaler, MinHashLSH,
    MinMaxScaler, NGram, Normalizer, OneHotEncoder, PCA, PolynomialExpansion,
    QuantileDiscretizer, RegexTokenizer, RFormula, RFormulaModel,
    RobustScaler, StandardScaler, StandardScalerModel, StopWordsRemover,
    StringIndexer, Tokenizer, UnivariateFeatureSelector,
    VarianceThresholdSelector, VectorAssembler, VectorIndexer,
    VectorSizeHint, VectorSlicer, Word2Vec,
)
from cycloneml_tpu_torch.ml.stat import (
    ANOVATest, ChiSquareTest, Correlation, FValueTest, KolmogorovSmirnovTest,
)

SUMMARIZER_RTOL = 1e-12   # statistics fitted by the device Summarizer


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _ref():
    import cycloneml_tpu.ml.feature as rf
    import cycloneml_tpu.ml.stat as rs
    from cycloneml_tpu.dataset.frame import MLFrame as RFrame
    return types.SimpleNamespace(MLFrame=RFrame, feature=rf, stat=rs)


@pytest.fixture
def xframe(pctx):
    rng = np.random.RandomState(60)
    x = rng.randn(100, 4) * np.array([1.0, 5.0, 0.1, 2.0]) + \
        np.array([0, 3, -1, 0])
    return MLFrame(pctx, {"features": x}), x


# -- tests/test_feature.py on the port ----------------------------------------

def test_standard_scaler(pctx, xframe):
    frame, x = xframe
    m = StandardScaler(withMean=True, withStd=True, inputCol="features",
                       outputCol="out").fit(frame)
    out = m.transform(frame)["out"]
    np.testing.assert_allclose(out.mean(0), 0.0, atol=1e-12)
    np.testing.assert_allclose(out.std(0, ddof=1), 1.0, rtol=1e-10)
    m2 = StandardScaler(inputCol="features", outputCol="out").fit(frame)
    out2 = m2.transform(frame)["out"]
    np.testing.assert_allclose(out2, x / x.std(0, ddof=1), rtol=1e-10)


def test_minmax_maxabs_robust(pctx, xframe):
    frame, x = xframe
    mm = MinMaxScaler(inputCol="features", outputCol="o").fit(frame) \
        .transform(frame)["o"]
    np.testing.assert_allclose(mm.min(0), 0.0, atol=1e-12)
    np.testing.assert_allclose(mm.max(0), 1.0, atol=1e-12)
    ma = MaxAbsScaler(inputCol="features", outputCol="o").fit(frame) \
        .transform(frame)["o"]
    assert np.abs(ma).max() <= 1.0 + 1e-12
    rs = RobustScaler(withCentering=True, inputCol="features",
                      outputCol="o").fit(frame)
    out = rs.transform(frame)["o"]
    np.testing.assert_allclose(np.median(out, axis=0), 0.0, atol=1e-12)


def test_normalizer(pctx, xframe):
    frame, x = xframe
    out = Normalizer(p=2.0, inputCol="features", outputCol="o") \
        .transform(frame)["o"]
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-12)
    out1 = Normalizer(p=1.0, inputCol="features", outputCol="o") \
        .transform(frame)["o"]
    np.testing.assert_allclose(np.abs(out1).sum(1), 1.0, rtol=1e-12)


def test_binarizer_bucketizer_quantile(pctx):
    f = MLFrame(pctx, {"v": np.array([-1.0, 0.2, 0.5, 0.8, 2.0])})
    b = Binarizer(threshold=0.4, inputCol="v", outputCol="o").transform(f)
    np.testing.assert_allclose(b["o"], [0, 0, 1, 1, 1])
    bk = Bucketizer(splits=[-np.inf, 0.0, 0.5, np.inf], inputCol="v",
                    outputCol="o").transform(f)
    np.testing.assert_allclose(bk["o"], [0, 1, 2, 2, 2])
    qd = QuantileDiscretizer(numBuckets=2, inputCol="v", outputCol="o").fit(f)
    out = qd.transform(f)["o"]
    assert set(out) == {0.0, 1.0}


def test_bucketizer_handle_invalid(pctx):
    f = MLFrame(pctx, {"v": np.array([0.5, 5.0])})
    bk = Bucketizer(splits=[0.0, 1.0, 2.0], inputCol="v", outputCol="o")
    with pytest.raises(ValueError):
        bk.transform(f)
    bk.set("handleInvalid", "keep")
    np.testing.assert_allclose(bk.transform(f)["o"], [0, 2])
    bk.set("handleInvalid", "skip")
    assert bk.transform(f).n_rows == 1


def test_elementwise_poly_dct_assembler_slicer(pctx):
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    f = MLFrame(pctx, {"features": x, "extra": np.array([10.0, 20.0])})
    ew = ElementwiseProduct(scaling_vec=[2.0, 0.5], inputCol="features",
                            outputCol="o").transform(f)
    np.testing.assert_allclose(ew["o"], [[2, 1], [6, 2]])
    pe = PolynomialExpansion(degree=2, inputCol="features",
                             outputCol="o").transform(f)
    assert pe["o"].shape[1] == 5
    np.testing.assert_allclose(pe["o"][0], [1, 2, 1, 2, 4])
    from scipy.fft import dct as sdct
    d = DCT(inputCol="features", outputCol="o").transform(f)
    np.testing.assert_allclose(d["o"], sdct(x, type=2, norm="ortho", axis=1))
    va = VectorAssembler(input_cols=["features", "extra"],
                         output_col="o").transform(f)
    np.testing.assert_allclose(va["o"], [[1, 2, 10], [3, 4, 20]])
    vs = VectorSlicer(indices=[1], inputCol="features",
                      outputCol="o").transform(f)
    np.testing.assert_allclose(vs["o"], [[2], [4]])
    vh = VectorSizeHint(size=2, inputCol="features")
    assert vh.transform(f).n_rows == 2
    with pytest.raises(ValueError):
        VectorSizeHint(size=3, inputCol="features").transform(f)


def test_interaction(pctx):
    f = MLFrame(pctx, {"a": np.array([[1.0, 2.0]]),
                       "b": np.array([[3.0, 4.0]])})
    out = Interaction(input_cols=["a", "b"]).transform(f)["interacted"]
    np.testing.assert_allclose(out, [[3, 4, 6, 8]])


def test_imputer(pctx):
    f = MLFrame(pctx, {"a": np.array([1.0, np.nan, 3.0]),
                       "b": np.array([np.nan, 4.0, 8.0])})
    m = Imputer(input_cols=["a", "b"], output_cols=["ia", "ib"]).fit(f)
    out = m.transform(f)
    np.testing.assert_allclose(out["ia"], [1, 2, 3])
    np.testing.assert_allclose(out["ib"], [6, 4, 8])
    m2 = Imputer(input_cols=["a"], output_cols=["ia"],
                 strategy="median").fit(f)
    np.testing.assert_allclose(m2.transform(f)["ia"], [1, 2, 3])


def test_tokenizers_and_text_chain(pctx):
    docs = np.array(["Hello World hello", "the quick brown fox the"],
                    dtype=object)
    f = MLFrame(pctx, {"text": docs})
    tok = Tokenizer(inputCol="text", outputCol="tokens").transform(f)
    assert tok["tokens"][0] == ["hello", "world", "hello"]
    rt = RegexTokenizer(pattern=r"o", inputCol="text",
                        outputCol="t2").transform(f)
    assert rt["t2"][0] == ["hell", " w", "rld hell"]
    sw = StopWordsRemover(inputCol="tokens", outputCol="clean").transform(tok)
    assert sw["clean"][1] == ["quick", "brown", "fox"]
    ng = NGram(n=2, inputCol="tokens", outputCol="ngrams").transform(tok)
    assert ng["ngrams"][0] == ["hello world", "world hello"]


def _token_docs():
    docs = np.empty(3, dtype=object)
    docs[0] = ["a", "b", "a"]
    docs[1] = ["b", "c"]
    docs[2] = ["a", "c", "c", "c"]
    return docs


def test_hashingtf_idf_countvectorizer(pctx):
    f = MLFrame(pctx, {"tokens": _token_docs()})
    tf = HashingTF(numFeatures=32, inputCol="tokens",
                   outputCol="tf").transform(f)
    assert tf["tf"].shape == (3, 32)
    assert tf["tf"][0].sum() == 3.0
    cv = CountVectorizer(inputCol="tokens", outputCol="counts").fit(f)
    assert cv.vocabulary[0] in ("a", "c")
    assert cv.vocabulary[0] == "c"
    out = cv.transform(f)["counts"]
    assert out.shape == (3, 3)
    idf_m = IDF(inputCol="tf", outputCol="tfidf").fit(tf)
    tfidf = idf_m.transform(tf)["tfidf"]
    assert tfidf.shape == (3, 32)
    fh = FeatureHasher(input_cols=["tokens"], numFeatures=16)
    assert fh.transform(f)["features"].shape == (3, 16)


def test_string_indexer_roundtrip(pctx):
    f = MLFrame(pctx, {"cat": np.array(["b", "a", "b", "c", "b"],
                                       dtype=object)})
    m = StringIndexer(inputCol="cat", outputCol="idx").fit(f)
    assert m.labels[0] == "b"
    out = m.transform(f)
    assert out["idx"][0] == 0.0
    back = IndexToString(labels=m.labels, inputCol="idx",
                         outputCol="orig").transform(out)
    assert list(back["orig"]) == list(f["cat"])
    f2 = MLFrame(pctx, {"cat": np.array(["z"], dtype=object)})
    with pytest.raises(ValueError):
        m.transform(f2)
    m.set("handleInvalid", "keep")
    assert m.transform(f2)["idx"][0] == 3.0


def test_onehot(pctx):
    f = MLFrame(pctx, {"idx": np.array([0.0, 1.0, 2.0, 1.0])})
    m = OneHotEncoder(input_cols=["idx"], output_cols=["vec"]).fit(f)
    out = m.transform(f)["vec"]
    assert out.shape == (4, 2)
    np.testing.assert_allclose(out[0], [1, 0])
    np.testing.assert_allclose(out[2], [0, 0])
    m.set("dropLast", False)
    assert m.transform(f)["vec"].shape == (4, 3)


def test_vector_indexer(pctx):
    x = np.array([[0.0, 1.5], [1.0, 2.5], [0.0, 3.5], [2.0, -1.0]])
    f = MLFrame(pctx, {"features": x})
    m = VectorIndexer(maxCategories=3, inputCol="features",
                      outputCol="o").fit(f)
    assert m.category_feature_indices == [0]
    out = m.transform(f)["o"]
    np.testing.assert_allclose(out[:, 0], [0, 1, 0, 2])
    np.testing.assert_allclose(out[:, 1], x[:, 1])


def test_selectors(pctx):
    rng = np.random.RandomState(61)
    n = 300
    y = rng.randint(0, 2, n).astype(float)
    informative = y + 0.1 * rng.randn(n)
    noise = rng.randn(n, 3)
    x = np.column_stack([informative, noise])
    f = MLFrame(pctx, {"features": x, "label": y})
    sel = UnivariateFeatureSelector(
        featureType="continuous", labelType="categorical",
        selectorType="numTopFeatures", numTopFeatures=1,
        inputCol="features", outputCol="sel").fit(f)
    assert sel.selected_features == [0]
    xv = np.column_stack([np.ones(n), rng.randn(n)])
    fv = MLFrame(pctx, {"features": xv})
    vt = VarianceThresholdSelector(inputCol="features", outputCol="o").fit(fv)
    assert vt.selected_features == [1]
    xc = np.column_stack([y, rng.randint(0, 2, n)]).astype(float)
    fc = MLFrame(pctx, {"features": xc, "label": y})
    cs = ChiSqSelector(numTopFeatures=1, inputCol="features",
                       outputCol="o").fit(fc)
    assert cs.selected_features == [0]


def test_pca_transformer(pctx):
    rng = np.random.RandomState(62)
    base = rng.randn(200, 2)
    x = np.column_stack([base[:, 0], base[:, 0] * 2 + 0.01 * rng.randn(200),
                         base[:, 1]])
    f = MLFrame(pctx, {"features": x})
    m = PCA(k=2, inputCol="features", outputCol="pca").fit(f)
    out = m.transform(f)["pca"]
    assert out.shape == (200, 2)
    assert m.explained_variance.sum() > 0.99


def test_lsh_brp(pctx):
    rng = np.random.RandomState(63)
    x = rng.randn(50, 8)
    f = MLFrame(pctx, {"features": x})
    m = BucketedRandomProjectionLSH(bucketLength=2.0, numHashTables=4,
                                    inputCol="features", outputCol="h",
                                    seed=1).fit(f)
    out = m.transform(f)
    assert out["h"].shape == (50, 4)
    nn = m.approx_nearest_neighbors(f, x[7] + 1e-6, 1)
    np.testing.assert_allclose(nn["features"][0], x[7])
    join = m.approx_similarity_join(f, f, threshold=1e-9)
    assert join.n_rows >= 50


def test_lsh_minhash(pctx):
    rng = np.random.RandomState(64)
    x = (rng.rand(30, 20) < 0.3).astype(float)
    x[x.sum(1) == 0, 0] = 1.0
    f = MLFrame(pctx, {"features": x})
    m = MinHashLSH(numHashTables=3, inputCol="features", outputCol="h",
                   seed=2).fit(f)
    assert m.transform(f)["h"].shape == (30, 3)
    nn = m.approx_nearest_neighbors(f, x[3], 1)
    np.testing.assert_allclose(nn["features"][0], x[3])


def _topic_sentences():
    sentences = np.empty(40, dtype=object)
    for i in range(40):
        sentences[i] = (["cat", "dog", "pet", "fur"] if i % 2 == 0
                        else ["car", "road", "wheel", "engine"]) * 3
    return sentences


def test_word2vec(pctx):
    f = MLFrame(pctx, {"tokens": _topic_sentences()})
    m = Word2Vec(vectorSize=16, minCount=1, maxIter=3, seed=3,
                 inputCol="tokens", outputCol="vec").fit(f)
    syn = m.find_synonyms("cat", 2)
    assert set(w for w, _ in syn) <= {"dog", "pet", "fur"}
    out = m.transform(f)
    assert out["vec"].shape == (40, 16)
    v = out["vec"]
    assert np.linalg.norm(v[0] - v[2]) < np.linalg.norm(v[0] - v[1])


def test_scaler_persistence(pctx, xframe, tmp_path):
    frame, x = xframe
    m = StandardScaler(withMean=True, inputCol="features",
                       outputCol="o").fit(frame)
    p = str(tmp_path / "ss")
    m.save(p)
    back = StandardScalerModel.load(p)
    np.testing.assert_allclose(back.mean, m.mean)
    np.testing.assert_allclose(back.transform(frame)["o"],
                               m.transform(frame)["o"])


def test_word2vec_hierarchical_softmax(pctx):
    from cycloneml_tpu_torch.ml.feature.word2vec import _huffman_paths
    freqs = np.array([100, 50, 20, 20, 5, 3, 1])
    points, codes, lengths = _huffman_paths(freqs)
    assert lengths[0] == lengths.min()
    binary = ["".join(str(b) for b in codes[w, :lengths[w]])
              for w in range(len(freqs))]
    assert len(set(binary)) == len(freqs)
    for i, a in enumerate(binary):
        for j, b in enumerate(binary):
            if i != j:
                assert not b.startswith(a)
    assert points.max() < len(freqs) - 1
    f = MLFrame(pctx, {"tokens": _topic_sentences()})
    m = Word2Vec(vectorSize=16, minCount=1, maxIter=4, seed=3, solver="hs",
                 inputCol="tokens", outputCol="vec").fit(f)
    losses = m.training_loss_
    assert len(losses) == 4 and losses[-1] < losses[0]
    syn = m.find_synonyms("cat", 2)
    assert set(w for w, _ in syn) <= {"dog", "pet", "fur"}
    v = m.transform(f)["vec"]
    assert np.linalg.norm(v[0] - v[2]) < np.linalg.norm(v[0] - v[1])


# -- tests/test_formula.py on the port ----------------------------------------

@pytest.fixture
def fframe(pctx):
    return MLFrame(pctx, {
        "y": np.array([1.0, 0.0, 1.0, 0.0]),
        "a": np.array([1.0, 2.0, 3.0, 4.0]),
        "b": np.array([10.0, 20.0, 30.0, 40.0]),
        "s": np.array(["x", "y", "x", "z"], dtype=object),
    })


def test_rformula_numeric_terms(fframe):
    out = RFormula(formula="y ~ a + b").fit(fframe).transform(fframe)
    np.testing.assert_allclose(out["features"],
                               np.column_stack([fframe["a"], fframe["b"]]))
    np.testing.assert_allclose(out["label"], fframe["y"])


def test_rformula_dot_and_exclusion(fframe):
    out = RFormula(formula="y ~ . - s").fit(fframe).transform(fframe)
    assert out["features"].shape == (4, 2)


def test_rformula_string_dummy_coding(fframe):
    feats = RFormula(formula="y ~ s").fit(fframe).transform(fframe)[
        "features"]
    assert feats.shape == (4, 2)
    np.testing.assert_allclose(feats[0], [1.0, 0.0])
    np.testing.assert_allclose(feats[1], [0.0, 1.0])
    np.testing.assert_allclose(feats[3], [0.0, 0.0])


def test_rformula_interaction(fframe):
    out = RFormula(formula="y ~ a:b").fit(fframe).transform(fframe)
    np.testing.assert_allclose(out["features"][:, 0],
                               fframe["a"] * fframe["b"])


def test_rformula_string_label(pctx):
    frame = MLFrame(pctx, {"cls": np.array(["pos", "neg", "pos"],
                                           dtype=object),
                           "v": np.array([1.0, 2.0, 3.0])})
    out = RFormula(formula="cls ~ v").fit(frame).transform(frame)
    np.testing.assert_allclose(out["label"], [0.0, 1.0, 0.0])


def test_rformula_persistence(fframe, tmp_path):
    model = RFormula(formula="y ~ a + s").fit(fframe)
    path = str(tmp_path / "rf")
    model.save(path)
    back = RFormulaModel.load(path)
    np.testing.assert_allclose(back.transform(fframe)["features"],
                               model.transform(fframe)["features"])


def test_rformula_rejects_unsupported_operators(fframe):
    with pytest.raises(ValueError, match="unsupported formula"):
        RFormula(formula="y ~ a*b").fit(fframe)
    with pytest.raises(ValueError, match="no terms"):
        RFormula(formula="y ~ ").fit(fframe)
    with pytest.raises(ValueError, match="unsupported formula"):
        RFormula(formula="y ~ a b").fit(fframe)


def test_rformula_unseen_category_errors(fframe, pctx):
    model = RFormula(formula="y ~ s").fit(fframe)
    bad = MLFrame(pctx, {"y": np.array([1.0]),
                         "s": np.array(["never-seen"], dtype=object)})
    with pytest.raises(ValueError, match="unseen at fit time"):
        model.transform(bad)


def test_rformula_nonstring_categories_survive_persistence(pctx, tmp_path):
    frame = MLFrame(pctx, {"y": np.array([1.0, 0.0, 1.0]),
                           "c": np.array([10, 20, 10], dtype=object)})
    model = RFormula(formula="y ~ c").fit(frame)
    before = model.transform(frame)["features"]
    path = str(tmp_path / "rf")
    model.save(path)
    after = RFormulaModel.load(path).transform(frame)["features"]
    np.testing.assert_allclose(before, after)


def test_rformula_in_pipeline_with_logistic_regression(pctx, tmp_path):
    """The reference's pipeline case (test_sql_transformer_in_pipeline)
    less its SQLTransformer stage: the product column made by hand, then
    RFormula and LogisticRegression, saved and reloaded."""
    from cycloneml_tpu_torch.ml.base import Pipeline, PipelineModel
    from cycloneml_tpu_torch.ml.classification import LogisticRegression
    rng = np.random.RandomState(0)
    a, b = rng.randn(100), rng.randn(100)
    frame = MLFrame(pctx, {"a": a, "b": b, "ab": a * b,
                           "label": (rng.rand(100) > 0.5).astype(float)})
    pipe = Pipeline(stages=[RFormula(formula="label ~ a + b + ab"),
                            LogisticRegression(maxIter=5)])
    model = pipe.fit(frame)
    out = model.transform(frame)
    assert out["features"].shape == (100, 3)
    path = str(tmp_path / "pipe")
    model.save(path)
    np.testing.assert_allclose(
        PipelineModel.load(path).transform(frame)["prediction"],
        out["prediction"])


def test_sql_transformer_raises_naming_item_12(ctx, tmp_path):
    """The reference's SQLTransformer parses through its SQL engine, which
    is ROADMAP Queue 1 item 12's: building one raises, and so does loading
    one the reference saved."""
    from cycloneml_tpu_torch.ml.feature.formula import SQLTransformer
    import cycloneml_tpu_torch.ml.feature as feat
    assert "SQLTransformer" not in feat.__all__
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        SQLTransformer(statement="SELECT a FROM __THIS__")
    r = _ref()
    path = str(tmp_path / "sql")
    r.feature.SQLTransformer(statement="SELECT a FROM __THIS__").save(path)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        util_io.load_instance(path)


# -- the ml/stat cases of tests/test_evaluation_tuning.py, both packages ------

def test_chisquare_vs_scipy(ctx, pctx):
    from scipy.stats import chi2_contingency
    rng = np.random.RandomState(73)
    y = rng.randint(0, 2, 200).astype(float)
    x0 = np.where(rng.rand(200) < 0.8, y, 1 - y)
    x1 = rng.randint(0, 3, 200).astype(float)
    cols = {"features": np.column_stack([x0, x1]), "label": y}
    res = ChiSquareTest.test(MLFrame(pctx, cols), "features", "label")
    table = np.zeros((2, 2))
    np.add.at(table, (x0.astype(int), y.astype(int)), 1)
    ref = chi2_contingency(table, correction=False)
    assert res["statistics"][0] == pytest.approx(ref.statistic)
    assert res["pValues"][0] == pytest.approx(ref.pvalue)
    assert res["pValues"][0] < 0.001 < res["pValues"][1]
    r = _ref()
    want = r.stat.ChiSquareTest.test(r.MLFrame(ctx, cols), "features",
                                     "label")
    for k in want:
        np.testing.assert_array_equal(res[k], want[k])


def test_anova_fvalue_ks(ctx, pctx):
    from scipy.stats import f_oneway
    rng = np.random.RandomState(74)
    y = rng.randint(0, 3, 150).astype(float)
    x = rng.randn(150, 2)
    x[:, 0] += y
    r = _ref()
    res = ANOVATest.test(MLFrame(pctx, {"features": x, "label": y}),
                         "features", "label")
    ref = f_oneway(*[x[y == c, 0] for c in range(3)])
    assert res["fValues"][0] == pytest.approx(ref.statistic)
    assert res["pValues"][0] == pytest.approx(ref.pvalue)
    want = r.stat.ANOVATest.test(r.MLFrame(ctx, {"features": x, "label": y}),
                                 "features", "label")
    for k in want:
        np.testing.assert_array_equal(res[k], want[k])
    yy = x[:, 0] * 2 + 0.1 * rng.randn(150)
    res2 = FValueTest.test(MLFrame(pctx, {"features": x, "label": yy}),
                           "features", "label")
    assert res2["pValues"][0] < 1e-10
    assert res2["pValues"][1] > 0.001
    want2 = r.stat.FValueTest.test(
        r.MLFrame(ctx, {"features": x, "label": yy}), "features", "label")
    for k in want2:
        np.testing.assert_array_equal(res2[k], want2[k])
    s3, s4 = rng.randn(500), rng.randn(500) + 3
    ks = KolmogorovSmirnovTest.test(MLFrame(pctx, {"sample": s3}), "sample",
                                    "norm", 0.0, 1.0)
    assert ks["pValue"] > 0.01
    ks2 = KolmogorovSmirnovTest.test(MLFrame(pctx, {"sample": s4}), "sample",
                                     "norm", 0.0, 1.0)
    assert ks2["pValue"] < 1e-10
    assert ks == r.stat.KolmogorovSmirnovTest.test(
        r.MLFrame(ctx, {"sample": s3}), "sample", "norm", 0.0, 1.0)


def test_correlation_pearson_spearman(ctx, pctx):
    rng = np.random.RandomState(75)
    a = rng.randn(200)
    x = np.column_stack([a, 2 * a + 0.01 * rng.randn(200), rng.randn(200)])
    f = MLFrame(pctx, {"features": x})
    c = Correlation.corr(f, "features").to_array()
    np.testing.assert_allclose(np.diag(c), 1.0)
    assert c[0, 1] > 0.999
    assert abs(c[0, 2]) < 0.2
    cs = Correlation.corr(f, "features", "spearman").to_array()
    from scipy.stats import spearmanr
    np.testing.assert_allclose(cs, spearmanr(x).statistic, atol=1e-10)
    r = _ref()
    for method in ("pearson", "spearman"):
        np.testing.assert_array_equal(
            Correlation.corr(f, "features", method).to_array(),
            r.stat.Correlation.corr(r.MLFrame(ctx, {"features": x}),
                                    "features", method).to_array())


# -- every fitted feature model, both packages --------------------------------

def _cols_scaler(rng):
    return {"features": rng.randn(120, 4) * np.array([1.0, 5.0, 0.1, 2.0])
            + np.array([0.0, 3.0, -1.0, 0.0])}


def _cols_imputer(rng):
    a, b = rng.randn(50), rng.randn(50)
    a[::7], b[3::5] = np.nan, np.nan
    return {"a": a, "b": b}


def _cols_tf(rng):
    return {"tf": rng.poisson(0.7, size=(30, 12)).astype(float)}


def _cols_tokens(rng):
    words = ["w%d" % i for i in range(9)]
    docs = np.empty(25, dtype=object)
    for i in range(25):
        docs[i] = [words[j] for j in rng.randint(0, 9, rng.randint(1, 8))]
    return {"tokens": docs}


def _cols_cat(rng):
    return {"cat": np.array(["abcde"[j] for j in rng.randint(0, 5, 60)],
                            dtype=object)}


def _cols_idx(rng):
    return {"idx": rng.randint(0, 4, 40).astype(float),
            "idx2": rng.randint(0, 3, 40).astype(float)}


def _cols_vi(rng):
    return {"features": np.column_stack([rng.randint(0, 3, 40),
                                         rng.randn(40),
                                         rng.randint(0, 2, 40)]).astype(float)}


def _cols_select(rng):
    y = rng.randint(0, 3, 200).astype(float)
    x = np.column_stack([y + 0.3 * rng.randn(200), rng.randn(200, 3),
                         rng.randint(0, 2, 200)])
    return {"features": x, "label": y, "cont": x[:, 0] * 2 + rng.randn(200)}


def _cols_binary(rng):
    x = (rng.rand(40, 15) < 0.3).astype(float)
    x[x.sum(1) == 0, 0] = 1.0
    return {"features": x}


def _cols_formula(rng):
    return {"y": rng.randint(0, 2, 30).astype(float), "a": rng.randn(30),
            "b": rng.randn(30),
            "s": np.array(["xyz"[j] for j in rng.randint(0, 3, 30)],
                          dtype=object)}


def _cols_w2v(rng):
    return {"tokens": _topic_sentences()}


# (name, estimator, params, columns, device-Summarizer fit)
SPECS = [
    ("standard", "StandardScaler", dict(withMean=True, inputCol="features",
                                        outputCol="o"), _cols_scaler, True),
    ("minmax", "MinMaxScaler", dict(inputCol="features", outputCol="o",
                                    min=-1.0), _cols_scaler, True),
    ("maxabs", "MaxAbsScaler", dict(inputCol="features", outputCol="o"),
     _cols_scaler, True),
    ("robust", "RobustScaler", dict(withCentering=True, inputCol="features",
                                    outputCol="o"), _cols_scaler, False),
    ("imputer", "Imputer", dict(input_cols=["a", "b"],
                                output_cols=["ia", "ib"],
                                strategy="median"), _cols_imputer, False),
    ("idf", "IDF", dict(inputCol="tf", outputCol="o", minDocFreq=2),
     _cols_tf, False),
    ("count_vectorizer", "CountVectorizer", dict(inputCol="tokens",
                                                 outputCol="o", minDF=2.0),
     _cols_tokens, False),
    ("string_indexer", "StringIndexer", dict(inputCol="cat", outputCol="o"),
     _cols_cat, False),
    ("onehot", "OneHotEncoder", dict(input_cols=["idx", "idx2"],
                                     output_cols=["o", "o2"]),
     _cols_idx, False),
    ("vector_indexer", "VectorIndexer", dict(maxCategories=3,
                                             inputCol="features",
                                             outputCol="o"), _cols_vi, False),
    ("chisq", "ChiSqSelector", dict(numTopFeatures=2, inputCol="features",
                                    outputCol="o"), _cols_select, False),
    ("variance", "VarianceThresholdSelector", dict(
        varianceThreshold=0.5, inputCol="features", outputCol="o"),
     _cols_select, False),
    ("univariate_anova", "UnivariateFeatureSelector", dict(
        featureType="continuous", labelType="categorical",
        selectorType="percentile", percentile=0.4, inputCol="features",
        outputCol="o"), _cols_select, False),
    ("univariate_fvalue", "UnivariateFeatureSelector", dict(
        featureType="continuous", labelType="continuous", labelCol="cont",
        selectorType="fpr", fpr=0.05, inputCol="features", outputCol="o"),
     _cols_select, False),
    ("univariate_chi2", "UnivariateFeatureSelector", dict(
        featureType="categorical", labelType="categorical",
        selectorType="fdr", fdr=0.1, inputCol="features", outputCol="o"),
     _cols_select, False),
    ("brp_lsh", "BucketedRandomProjectionLSH", dict(
        bucketLength=1.5, numHashTables=3, seed=4, inputCol="features",
        outputCol="o"), _cols_scaler, False),
    ("minhash_lsh", "MinHashLSH", dict(numHashTables=4, seed=5,
                                       inputCol="features", outputCol="o"),
     _cols_binary, False),
    ("rformula", "RFormula", dict(formula="y ~ a + s + a:b"),
     _cols_formula, False),
    ("word2vec_hs", "Word2Vec", dict(vectorSize=8, minCount=1, maxIter=2,
                                     seed=3, solver="hs", inputCol="tokens",
                                     outputCol="o"), _cols_w2v, False),
]


def _outputs(frame, before):
    return {c: frame[c] for c in frame.columns if c not in before}


def _same_outputs(got, want, rtol):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = got[c], np.asarray(want[c])
        if g.dtype == object:
            assert list(g) == list(w), c
        elif rtol:
            # centering can leave an output near 0: the bound is relative
            # to the column's largest magnitude there
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=rtol * np.abs(w).max(),
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _fit_both(ctx, pctx, spec, seed=0):
    name, est, kw, cols_of, summarized = spec
    cols = cols_of(np.random.RandomState(seed))
    r = _ref()
    import cycloneml_tpu_torch.ml.feature as feat
    rframe, pframe = r.MLFrame(ctx, dict(cols)), MLFrame(pctx, dict(cols))
    ref = getattr(r.feature, est)(**kw).fit(rframe)
    got = getattr(feat, est)(**kw).fit(pframe)
    # Word2Vec's HS fit sums float32 updates in other orders
    rtol = SUMMARIZER_RTOL if summarized else (1e-5 if est == "Word2Vec"
                                               else 0)
    return ref, got, rframe, pframe, rtol


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_fitted_models_transform_as_the_reference(ctx, pctx, spec):
    ref, got, rframe, pframe, rtol = _fit_both(ctx, pctx, spec)
    assert type(got).__name__ == type(ref).__name__
    for k in interop._FEATURE_STATE[type(ref).__name__]:
        want, have = getattr(ref, k), getattr(got, k)
        if isinstance(want, np.ndarray) and want.dtype.kind == "f":
            np.testing.assert_allclose(have, want, rtol=rtol, atol=0,
                                       err_msg=k)
        elif isinstance(want, np.ndarray):
            np.testing.assert_array_equal(have, want, err_msg=k)
        else:
            assert have == want, k
    _same_outputs(_outputs(got.transform(pframe), pframe.columns),
                  _outputs(ref.transform(rframe), rframe.columns), rtol)


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_models_the_reference_saved_load_in_the_port(ctx, pctx, spec,
                                                     tmp_path):
    ref, _, rframe, pframe, _ = _fit_both(ctx, pctx, spec)
    path = str(tmp_path / spec[0])
    ref.save(path)
    back = util_io.load_instance(path)
    assert type(back).__module__.startswith("cycloneml_tpu_torch.")
    _same_outputs(_outputs(back.transform(pframe), pframe.columns),
                  _outputs(ref.transform(rframe), rframe.columns), 0)


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_feature_models_carry_across_by_interop(ctx, pctx, spec):
    ref, _, rframe, pframe, _ = _fit_both(ctx, pctx, spec)
    name = type(ref).__name__
    state = {k: getattr(ref, k) for k in interop._FEATURE_STATE[name]}
    params = {p.name: ref.get(p.name) for p in ref.params
              if ref.is_defined(p)}
    got = interop.feature_model_from_reference(name, state, **params)
    _same_outputs(_outputs(got.transform(pframe), pframe.columns),
                  _outputs(ref.transform(rframe), rframe.columns), 0)


def test_quantile_discretizer_and_stateless_transforms_match(ctx, pctx):
    """The transformers with no fitted state: the same columns out of
    both packages."""
    rng = np.random.RandomState(12)
    cols = {"v": rng.randn(80), "features": rng.randn(80, 3),
            "text": np.array(["The quick fox %d jumps" % i
                              for i in range(80)], dtype=object)}
    r = _ref()
    import cycloneml_tpu_torch.ml.feature as feat
    cases = [
        ("QuantileDiscretizer", dict(numBuckets=4, inputCol="v",
                                     outputCol="o"), True),
        ("Binarizer", dict(threshold=0.1, inputCol="v", outputCol="o"),
         False),
        ("PolynomialExpansion", dict(degree=3, inputCol="features",
                                     outputCol="o"), False),
        ("Normalizer", dict(p=3.0, inputCol="features", outputCol="o"),
         False),
        ("DCT", dict(inputCol="features", outputCol="o", inverse=True),
         False),
        ("RegexTokenizer", dict(pattern=r"\s+", inputCol="text",
                                outputCol="o", minTokenLength=2), False),
        ("Tokenizer", dict(inputCol="text", outputCol="o"), False),
    ]
    for est, kw, fitted in cases:
        rs, ps = getattr(r.feature, est)(**kw), getattr(feat, est)(**kw)
        rf, pf = r.MLFrame(ctx, dict(cols)), MLFrame(pctx, dict(cols))
        if fitted:
            rs, ps = rs.fit(rf), ps.fit(pf)
        _same_outputs(_outputs(ps.transform(pf), pf.columns),
                      _outputs(rs.transform(rf), rf.columns), 0)
    rf, pf = r.MLFrame(ctx, dict(cols)), MLFrame(pctx, dict(cols))
    toks_r = r.feature.Tokenizer(inputCol="text").transform(rf)
    toks_p = feat.Tokenizer(inputCol="text").transform(pf)
    for est, kw in (("HashingTF", dict(numFeatures=64)),
                    ("NGram", dict(n=3)), ("StopWordsRemover", {})):
        _same_outputs(
            _outputs(getattr(feat, est)(**kw).transform(toks_p),
                     toks_p.columns),
            _outputs(getattr(r.feature, est)(**kw).transform(toks_r),
                     toks_r.columns), 0)


def test_interop_refuses_what_is_not_a_feature_model():
    with pytest.raises(ValueError, match="not a fitted feature model"):
        interop.feature_model_from_reference("KMeansModel", {})
    with pytest.raises(ValueError, match="needs"):
        interop.feature_model_from_reference("StandardScalerModel",
                                             {"mean": np.zeros(2)})


def test_feature_modules_persist_in_a_pipeline(pctx, tmp_path):
    """StringIndexer, OneHotEncoder, VectorAssembler, StandardScaler and a
    selector in one saved Pipeline: the reloaded model transforms the
    same."""
    from cycloneml_tpu_torch.ml.base import Pipeline, PipelineModel
    rng = np.random.RandomState(2)
    frame = MLFrame(pctx, {
        "cat": np.array(["abc"[j] for j in rng.randint(0, 3, 60)],
                        dtype=object),
        "x": rng.randn(60), "label": rng.randint(0, 2, 60).astype(float)})
    pipe = Pipeline(stages=[
        StringIndexer(inputCol="cat", outputCol="ci"),
        OneHotEncoder(input_cols=["ci"], output_cols=["co"]),
        VectorAssembler(input_cols=["co", "x"], output_col="raw"),
        StandardScaler(inputCol="raw", outputCol="scaled"),
        UnivariateFeatureSelector(featureType="continuous",
                                  labelType="categorical",
                                  numTopFeatures=2, inputCol="scaled",
                                  outputCol="sel")])
    model = pipe.fit(frame)
    path = str(tmp_path / "p")
    model.save(path)
    np.testing.assert_array_equal(
        PipelineModel.load(path).transform(frame)["sel"],
        model.transform(frame)["sel"])
    assert os.path.isdir(os.path.join(path, "stages"))
