"""Word2Vec in the port against the JAX package's and against the numpy
oracle (``tests/ref_parity/w2v_oracle.py``), on the same seeded corpora.

- The (center, context) pairs, built by numpy over whole sentences
  (``word2vec.skipgram_pairs``), equal the reference's Python loops (the
  oracle's ``build_pipeline`` mirrors them) on the reference's corpora and
  on a seeded corpus with out-of-vocabulary words and truncated sentences.
- Negative sampling with the reference's ``jax.random`` draws fed in
  (``Word2Vec._feed_negatives``): vectors within atol 1e-5 of the
  reference's (both float32; the port adds each word's updates in float64
  rounded once, the reference in float32 one row at a time) and within the
  reference's own 2e-4 of the float64 oracle.
- Hierarchical softmax: the loss curve within rtol 1e-6 and the vectors
  within atol 1e-5 of the reference's, and within the reference's 1e-4 /
  2e-4 of the oracle's.
- The port's own negatives (a ``torch.Generator`` seeded from ``seed``):
  one seed replays a fit bitwise, another seed gives another fit.

The ``gpu`` tests fit both solvers on the card through
``csrc/segment_reduce.cu`` (three accumulate launches a negative-sampling
step, two a hierarchical-softmax step), refits bitwise equal, against the
plain route's fit. The card's machine has no jax, so the reference is
imported inside the tests that use it:

    python -m pytest --noconftest -m gpu tests/test_torch_word2vec.py
"""

import numpy as np
import pytest
import torch

from cycloneml_tpu_torch import CycloneConf, CycloneContext
from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.feature import Word2Vec
from cycloneml_tpu_torch.ml.feature import word2vec as w2v
from cycloneml_tpu_torch.ops import kernels

REF_ATOL = 1e-5       # the port's float32 vectors against the reference's
ORACLE_ATOL = 2e-4    # the reference's own bound against the f64 oracle


@pytest.fixture
def pctx():
    c = CycloneContext(CycloneConf().set("cyclone.master", "cpu")
                       .set("cyclone.compute.dtype", "float64"))
    yield c
    c.stop()


def _oracle():
    from tests.ref_parity import w2v_oracle
    return w2v_oracle


def _topics_corpus(seed=0, n=120):
    rng = np.random.RandomState(seed)
    topics = [["cat", "dog", "pet", "fur", "paw"],
              ["car", "road", "wheel", "fuel", "drive"],
              ["sun", "moon", "star", "sky", "orbit"]]
    out = []
    for _ in range(n):
        t = topics[rng.randint(3)]
        out.append([t[rng.randint(5)] for _ in range(8)])
    return out


def _words_corpus(seed=1):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(30)]
    return [[words[rng.randint(30)] for _ in range(10)] for _ in range(80)]


def _frame(ctx, sentences, frame_cls=MLFrame):
    return frame_cls(ctx, {"text": np.array(
        [list(s) for s in sentences], dtype=object)})


def _port_pairs(sentences, min_count, window, max_len=1000):
    sents = [list(map(str, s))[:max_len] for s in sentences]
    vocab, counts = w2v.build_vocab(sents, min_count)
    index = {w: i for i, w in enumerate(vocab)}
    c, o = w2v.skipgram_pairs([[index[w] for w in s if w in index]
                               for s in sents], window)
    return vocab, counts, c, o


@pytest.mark.parametrize("corpus,min_count,window,max_len", [
    ("topics", 1, 2, 1000), ("words", 1, 2, 1000), ("words", 3, 5, 7),
    ("zipf", 4, 3, 1000), ("zipf", 2, 1, 13)])
def test_pairs_equal_the_references(corpus, min_count, window, max_len):
    if corpus == "topics":
        sentences = _topics_corpus()
    elif corpus == "words":
        sentences = _words_corpus()
    else:   # a seeded Zipf corpus: rare words fall under minCount
        rng = np.random.RandomState(5)
        lens = rng.randint(1, 40, 60)
        ranks = np.minimum(rng.zipf(1.3, lens.sum()), 500)
        toks = [f"t{r}" for r in ranks]
        sentences, at = [], 0
        for ln in lens:
            sentences.append(toks[at:at + ln])
            at += ln
    vocab, counts, c, o = _port_pairs(sentences, min_count, window, max_len)
    rvocab, rcounts, rc, ro = _oracle().build_pipeline(
        sentences, min_count, window, max_len)
    assert vocab == rvocab and counts == rcounts
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(o, ro)
    assert c.dtype == np.int32 and len(c) > 0


def test_pairs_of_a_long_corpus_span_chunks(monkeypatch):
    """Positions are expanded a chunk at a time; a chunk boundary inside a
    sentence changes nothing."""
    monkeypatch.setattr(w2v, "PAIR_CHUNK", 37)
    sentences = _words_corpus(3)
    _, _, c, o = _port_pairs(sentences, 1, 4)
    _, _, rc, ro = _oracle().build_pipeline(sentences, 1, 4)
    np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(o, ro)


def _reference_draws(sentences, dim, window, epochs, seed, n_neg):
    """The reference estimator's negative draws, reconstructed as its own
    oracle test does (the same PRNG discipline)."""
    import jax
    import jax.numpy as jnp
    wo = _oracle()
    vocab, counts, centers, _ = wo.build_pipeline(sentences, 1, window)
    freq = np.array([counts[w] for w in vocab], dtype=np.float64) ** 0.75
    neg_probs = jnp.asarray(freq / freq.sum(), dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    prng = np.random.RandomState(seed)
    prng.rand(len(vocab), dim)
    draws = []
    for _ in range(epochs):
        perm = prng.permutation(len(centers))
        for s0 in range(0, len(centers), wo.BATCH):
            sel = perm[s0: s0 + wo.BATCH]
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jax.random.choice(
                sub, len(vocab), shape=(len(sel), n_neg), p=neg_probs)))
    return draws


@pytest.mark.parametrize("corpus,dim,window,epochs,seed", [
    ("topics", 12, 2, 2, 7), ("words", 10, 3, 3, 11)])
def test_ns_with_the_references_draws(ctx, pctx, corpus, dim, window,
                                      epochs, seed):
    from cycloneml_tpu.dataset.frame import MLFrame as RFrame
    from cycloneml_tpu.ml.feature import Word2Vec as RWord2Vec
    sentences = _topics_corpus() if corpus == "topics" else _words_corpus()
    n_neg, lr = 5, 0.025
    kw = dict(vectorSize=dim, windowSize=window, maxIter=epochs, seed=seed,
              minCount=1, negative=n_neg, stepSize=lr, inputCol="text")
    ref = RWord2Vec(**kw).fit(_frame(ctx, sentences, RFrame))
    draws = _reference_draws(sentences, dim, window, epochs, seed, n_neg)
    got = Word2Vec(**kw)._feed_negatives(draws).fit(_frame(pctx, sentences))
    assert got.vocabulary == ref.vocabulary
    assert got.vectors.dtype == np.float64
    np.testing.assert_allclose(got.vectors, ref.vectors, atol=REF_ATOL)
    ovocab, ovecs = _oracle().oracle_ns(
        sentences, dim=dim, window=window, lr=lr, epochs=epochs, seed=seed,
        neg_draws=draws)
    assert got.vocabulary == ovocab
    np.testing.assert_allclose(got.vectors, ovecs, atol=ORACLE_ATOL)
    for w in got.vocabulary[:3]:
        assert [x for x, _ in got.find_synonyms(w, 3)] == \
            [x for x, _ in ref.find_synonyms(w, 3)]


@pytest.mark.parametrize("corpus,dim,window,epochs,seed", [
    ("words", 10, 2, 3, 5), ("topics", 8, 3, 2, 9)])
def test_hs_matches_the_reference_and_the_oracle(ctx, pctx, corpus, dim,
                                                 window, epochs, seed):
    from cycloneml_tpu.dataset.frame import MLFrame as RFrame
    from cycloneml_tpu.ml.feature import Word2Vec as RWord2Vec
    sentences = _words_corpus() if corpus == "words" else _topics_corpus()
    lr = 0.025
    kw = dict(vectorSize=dim, windowSize=window, maxIter=epochs, seed=seed,
              minCount=1, solver="hs", stepSize=lr, inputCol="text")
    ref = RWord2Vec(**kw).fit(_frame(ctx, sentences, RFrame))
    got = Word2Vec(**kw).fit(_frame(pctx, sentences))
    assert got.vocabulary == ref.vocabulary
    np.testing.assert_allclose(got.training_loss_, ref.training_loss_,
                               rtol=1e-6)
    np.testing.assert_allclose(got.vectors, ref.vectors, atol=REF_ATOL)
    ovocab, ovecs, olosses = _oracle().oracle_hs(
        sentences, dim=dim, window=window, lr=lr, epochs=epochs, seed=seed)
    assert got.vocabulary == ovocab
    np.testing.assert_allclose(got.training_loss_, olosses, rtol=1e-4)
    np.testing.assert_allclose(got.vectors, ovecs, atol=ORACLE_ATOL)


def test_huffman_paths_are_the_references():
    from cycloneml_tpu.ml.feature.word2vec import _huffman_paths as ref_paths
    rng = np.random.RandomState(4)
    for v in (1, 2, 7, 300):
        freqs = rng.randint(1, 1000, v)
        for a, b in zip(w2v._huffman_paths(freqs), ref_paths(freqs)):
            np.testing.assert_array_equal(a, b)


def test_one_seed_replays_the_ports_negatives(pctx):
    sentences = _topics_corpus(2)
    kw = dict(vectorSize=8, windowSize=2, maxIter=2, minCount=1,
              inputCol="text")
    a = Word2Vec(seed=4, **kw).fit(_frame(pctx, sentences))
    b = Word2Vec(seed=4, **kw).fit(_frame(pctx, sentences))
    c = Word2Vec(seed=5, **kw).fit(_frame(pctx, sentences))
    np.testing.assert_array_equal(a.vectors, b.vectors)
    assert not np.array_equal(a.vectors, c.vectors)


def test_ns_step_adds_the_references_updates_from_old_rows():
    """One negative-sampling step against the reference's update written
    out in float64 numpy (every update from the step's old rows; a word
    that is both a context and a negative gets both)."""
    rng = np.random.RandomState(6)
    v, d, b, k, lr = 9, 4, 30, 3, 0.1
    w_in = rng.randn(v, d)
    w_out = rng.randn(v, d)
    c, o = rng.randint(0, v, b), rng.randint(0, v, b)
    neg = rng.randint(0, v, (b, k))
    ti, to = torch.tensor(w_in), torch.tensor(w_out)
    w2v.ns_step(ti, to, torch.tensor(c), torch.tensor(o), torch.tensor(neg),
                lr)
    sig = lambda z: 1.0 / (1.0 + np.exp(-z))
    vc, vo, vn = w_in[c], w_out[o], w_out[neg]
    g_pos = (sig((vc * vo).sum(1)) - 1.0)[:, None]
    g_neg = sig(np.einsum("bd,bkd->bk", vc, vn))[:, :, None]
    want_in, want_out = w_in.copy(), w_out.copy()
    np.add.at(want_in, c, -lr * (g_pos * vo + (g_neg * vn).sum(1)))
    np.add.at(want_out, o, -lr * g_pos * vc)
    np.add.at(want_out, neg.reshape(-1),
              (-lr * g_neg * vc[:, None, :]).reshape(-1, d))
    np.testing.assert_allclose(ti.numpy(), want_in, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(to.numpy(), want_out, rtol=1e-12, atol=1e-14)


# -- on the card ------------------------------------------------------------------

def _cuda_context(**conf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = CycloneConf().set("cyclone.master", "cuda")
    for key, v in conf.items():
        c.set(key, v)
    return CycloneContext(c)


def _zipf_corpus(n_tokens=60_000, types=2000, seed=8):
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, types + 1)
    toks = rng.choice(types, n_tokens, p=p / p.sum())
    return [[f"t{t}" for t in toks[i:i + 1000]]
            for i in range(0, n_tokens, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["ns", "hs"])
def test_cuda_word2vec_refits_bitwise_and_holds_the_plain_route(solver):
    sentences = _zipf_corpus()
    kw = dict(vectorSize=32, windowSize=3, maxIter=1, seed=2, minCount=2,
              solver=solver, inputCol="text")
    fits, launches = {}, {}
    for mode in ("auto", "false"):
        c = _cuda_context(**{"cyclone.ml.usePallasKernels": mode})
        try:
            frame = _frame(c, sentences)
            kernels.reset_launch_counts()
            fits[mode] = Word2Vec(**kw).fit(frame)
            launches[mode] = dict(kernels.segment_reduce.launches_by_instance)
            if mode == "auto":
                fits["again"] = Word2Vec(**kw).fit(frame)
        finally:
            c.stop()
    np.testing.assert_array_equal(fits["auto"].vectors, fits["again"].vectors)
    n_pairs = len(w2v.Word2Vec(**kw)._prepare(
        _frame(None, sentences))[2])
    steps = -(-n_pairs // w2v.BATCH)
    per_step = 3 if solver == "ns" else 2
    assert launches["auto"]["f32_sum_accumulate"] == per_step * steps
    assert sum(launches["false"].values()) == 0
    # the plain route draws the same negatives (one generator on the card)
    np.testing.assert_allclose(fits["auto"].vectors, fits["false"].vectors,
                               atol=1e-5)
    if solver == "hs":
        np.testing.assert_allclose(fits["auto"].training_loss_,
                                   fits["false"].training_loss_, rtol=1e-6)
