"""Word2Vec — skip-gram embeddings.

The port's counterpart of ``cycloneml_tpu/ml/feature/word2vec.py`` (ref:
mllib/feature/Word2Vec.scala:73, wrapped by ml/feature/Word2Vec.scala).
Training is skip-gram with negative sampling (the default) or hierarchical
softmax over a Huffman tree (``solver="hs"``, the reference's objective),
one batch of 8,192 (center, context) pairs a step on the context's device:

- each step's gathers and products are plain torch, in float32;
- its scatter-adds (the reference's ``.at[idx].add`` at :125-127 and
  :190-191) go through the accumulate form of ``kernels.segment_reduce``
  (``csrc/segment_reduce.cu`` on the card): the step's update rows sorted
  stably by destination word (``kernels.segment_order``) and each word's
  rows summed in a fixed order in double, then added into W in place,
  rounded once, so two fits give the same bits. All of a step's updates
  are computed from its old rows, and they are added in the reference's
  order: the centers' input vectors, then the contexts' output vectors,
  then the negatives'.

The vocabulary (count-descending, word-ascending) and the (center, context)
pairs are the reference's, the pairs built by numpy over whole sentences
(:func:`skipgram_pairs`) in the reference's order; the initial vectors and
the epochs' permutations come from ``np.random.RandomState(seed)`` as
there. The negatives are the port's own bits: uniforms from a
``torch.Generator`` on the context's device seeded from ``seed``, each
searched in the unigram^(3/4) table's float64 cumulative sums (the
reference draws ``jax.random.choice``, which no torch generator
reproduces), so one seed replays a fit. API parity:
vectorSize, windowSize, minCount, maxIter, find_synonyms, getVectors,
transform = average of word vectors (the reference's transform semantics).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cycloneml_tpu_torch.dataset.frame import MLFrame
from cycloneml_tpu_torch.ml.base import Estimator, Model
from cycloneml_tpu_torch.ml.feature.scalers import _InOutCol
from cycloneml_tpu_torch.ml.param import ParamValidators as V
from cycloneml_tpu_torch.ml.shared import HasMaxIter, HasSeed
from cycloneml_tpu_torch.ml.util_io import (MLReadable, MLWritable,
                                            load_arrays, save_arrays)
from cycloneml_tpu_torch.ops import kernels

BATCH = 8192          # pairs a step (the reference's device batch)
PAIR_CHUNK = 1 << 20  # token positions expanded at a time by skipgram_pairs


class _W2VParams(_InOutCol, HasMaxIter, HasSeed):
    def _p_w2v(self):
        self._p_in_out(in_default="tokens", out_default="vector")
        self._p_max_iter(1)
        self._p_seed(17)
        self.vectorSize = self._param("vectorSize", "embedding size (> 0)",
                                      V.gt(0), default=100)
        self.windowSize = self._param("windowSize", "context window (> 0)",
                                      V.gt(0), default=5)
        self.minCount = self._param("minCount", "min word frequency",
                                    V.gt_eq(0), default=5)
        self.stepSize = self._param("stepSize", "learning rate (> 0)",
                                    V.gt(0.0), default=0.025)
        self.negative = self._param("negative", "negative samples per pair",
                                    V.gt(0), default=5)
        self.maxSentenceLength = self._param("maxSentenceLength",
                                             "sentence truncation", V.gt(0),
                                             default=1000)
        # "ns" (default, negative sampling) or "hs" (hierarchical softmax
        # over a Huffman tree, the reference's exact objective,
        # Word2Vec.scala:73 createBinaryTree)
        self.solver = self._param("solver", "ns | hs",
                                  V.in_array(["ns", "hs"]), default="ns")


def build_vocab(sentences: Sequence[Sequence[str]], min_count: int):
    """``(vocab, counts)``: the words of count >= ``min_count`` ordered by
    count descending, then word ascending, and every word's count."""
    counts: dict = {}
    for s in sentences:
        for w in s:
            counts[w] = counts.get(w, 0) + 1
    vocab = sorted((w for w, c in counts.items() if c >= min_count),
                   key=lambda w: (-counts[w], w))
    return vocab, counts


def skipgram_pairs(sentence_ids: Sequence[np.ndarray], window: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``(centers, contexts)`` int32 of every sentence's skip-gram pairs:
    for each sentence, each position i, each j from i - window to i +
    window inside the sentence but i, the pair (ids[i], ids[j]) — the
    reference's Python loops (word2vec.py:86-93), in their order, built by
    numpy a chunk of positions at a time."""
    lens = np.array([len(s) for s in sentence_ids], dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    flat = np.concatenate([np.asarray(s, dtype=np.int64)
                           for s in sentence_ids])
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    sent = np.repeat(np.arange(len(lens)), lens)
    offs = np.array([o for o in range(-window, window + 1) if o != 0],
                    dtype=np.int64)
    centers, contexts = [], []
    for lo in range(0, total, PAIR_CHUNK):
        pos = np.arange(lo, min(lo + PAIR_CHUNK, total), dtype=np.int64)
        i = pos - starts[sent[pos]]
        j = i[:, None] + offs[None, :]
        valid = (j >= 0) & (j < lens[sent[pos]][:, None])
        pp, oo = np.nonzero(valid)          # row-major: by position, then j
        centers.append(flat[pos[pp]])
        contexts.append(flat[pos[pp] + offs[oo]])
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32))


def _scatter_add(reduce, w: torch.Tensor, idx: torch.Tensor,
                 upd: torch.Tensor) -> None:
    """``w[idx[i]] += upd[i]`` for every i, in place: the rows sorted stably
    by ``idx``, each row of w's sum taken in a fixed order
    (``kernels.segment_reduce``'s accumulate form, or its plain version)."""
    perm, offsets = kernels.segment_order(idx, w.shape[0], check=False)
    reduce(upd, offsets, kernels.SUM, rows=perm, out=w)


def ns_step(w_in: torch.Tensor, w_out: torch.Tensor, c_idx: torch.Tensor,
            o_idx: torch.Tensor, neg_idx: torch.Tensor, lr: float,
            reduce=kernels.segment_reduce) -> None:
    """One negative-sampling step in place (the reference's ``step``,
    word2vec.py:108-128): loss -log σ(v_c·v_o) - Σ_k log σ(-v_c·v_nk) over
    the batch's centers ``c_idx`` (b,), contexts ``o_idx`` (b,) and
    negatives ``neg_idx`` (b, k), every update from the step's old rows,
    added by ``reduce``'s accumulate form in the reference's order."""
    dim = w_in.shape[1]
    vc = w_in[c_idx]                                   # (b, dim)
    vo = w_out[o_idx]                                  # (b, dim)
    vn = w_out[neg_idx]                                # (b, k, dim)
    pos_score = torch.sigmoid(torch.sum(vc * vo, dim=1))
    neg_score = torch.sigmoid(torch.bmm(vn, vc[:, :, None])[:, :, 0])
    g_pos = (pos_score - 1.0)[:, None]                 # d/dvc of -log σ
    g_neg = neg_score[:, :, None]
    d_vc = g_pos * vo + torch.sum(g_neg * vn, dim=1)
    d_vo = g_pos * vc
    d_vn = g_neg * vc[:, None, :]
    _scatter_add(reduce, w_in, c_idx, -lr * d_vc)
    _scatter_add(reduce, w_out, o_idx, -lr * d_vo)
    _scatter_add(reduce, w_out, neg_idx.reshape(-1),
                 (-lr * d_vn).reshape(-1, dim))


def hs_step(w_in: torch.Tensor, w_node: torch.Tensor, c_idx: torch.Tensor,
            ctx_idx: torch.Tensor, pts: torch.Tensor, cds: torch.Tensor,
            msk: torch.Tensor, lr: float, reduce=kernels.segment_reduce
            ) -> torch.Tensor:
    """One hierarchical-softmax step in place (the reference's ``step``,
    word2vec.py:174-195): the context word's input vector against the
    center word's Huffman path (``pts``, ``cds``, ``msk`` the (V, L) inner
    nodes, branch bits and path mask). Returns the batch's loss
    -Σ mask log σ((1 - 2 code) dot), summed in float64."""
    dim = w_in.shape[1]
    vin = w_in[ctx_idx]                        # (b, dim)
    nodes = pts[c_idx]                         # (b, L)
    code = cds[c_idx]
    mask = msk[c_idx]
    vn = w_node[nodes]                         # (b, L, dim)
    dot = torch.bmm(vn, vin[:, :, None])[:, :, 0]
    score = torch.sigmoid(dot)
    # word2vec.c: g = (1 - code - sigmoid(dot)); here as the gradient of
    # -log sigma((1-2*code) * dot)
    g = (score - (1.0 - code)) * mask          # (b, L)
    d_vin = torch.bmm(g[:, None, :], vn)[:, 0, :]
    d_vn = g[:, :, None] * vin[:, None, :]
    _scatter_add(reduce, w_in, ctx_idx, -lr * d_vin)
    _scatter_add(reduce, w_node, nodes.reshape(-1),
                 (-lr * d_vn).reshape(-1, dim))
    sign = 1.0 - 2.0 * code
    return -torch.sum((mask * torch.nn.functional.logsigmoid(sign * dot))
                      .to(torch.float64))


class Word2Vec(Estimator, _W2VParams, MLWritable, MLReadable):
    def __init__(self, uid=None, **kw):
        super().__init__(uid)
        self._p_w2v()
        self._given_negatives: Optional[List] = None
        # the vectors' type: float32, the reference's; float64 gives a
        # check its twin
        self._dtype = torch.float32
        for k, v in kw.items():
            self.set(k, v)

    def set_vector_size(self, v):
        return self.set("vectorSize", v)

    def _feed_negatives(self, draws: Iterable) -> "Word2Vec":
        """Take the negative-sampling fit's negatives from ``draws`` (one
        (b, k) integer array a step, in step order) in place of the port's
        generator: a test hands in the reference's ``jax.random`` draws."""
        self._given_negatives = list(draws)
        return self

    def _prepare(self, frame):
        """The reference's host pipeline: the truncated sentences, the
        vocabulary and counts, and the (center, context) pairs."""
        sentences = [list(map(str, s))[: self.get("maxSentenceLength")]
                     for s in frame[self.get("inputCol")]]
        min_count = self.get("minCount")
        vocab, counts = build_vocab(sentences, min_count)
        if not vocab:
            raise ValueError(f"no words with count >= {min_count}")
        index = {w: i for i, w in enumerate(vocab)}
        centers, contexts = skipgram_pairs(
            [[index[w] for w in s if w in index] for s in sentences],
            self.get("windowSize"))
        if not len(centers):
            raise ValueError("no training pairs (sentences too short?)")
        return vocab, counts, centers, contexts

    def _fit(self, frame) -> "Word2VecModel":
        vocab, counts, centers, contexts = self._prepare(frame)
        dev = frame.ctx.device
        reduce = (kernels.segment_reduce_plain
                  if kernels.kernel_mode(frame.ctx) == "false"
                  else kernels.segment_reduce)
        n_vocab, dim = len(vocab), self.get("vectorSize")
        rng = np.random.RandomState(self.get("seed"))
        w_in = torch.as_tensor(((rng.rand(n_vocab, dim) - 0.5) / dim)
                               .astype(np.float32), device=dev).to(
                                   self._dtype)
        cent = torch.as_tensor(centers, dtype=torch.int64, device=dev)
        ctxs = torch.as_tensor(contexts, dtype=torch.int64, device=dev)
        if self.get("solver") == "hs":
            return self._fit_hs(vocab, counts, cent, ctxs, w_in, rng, reduce)

        # unigram^(3/4) negative-sampling table, as cumulative sums in
        # float64 made once on the host: the draws are inverse-CDF
        # searches of uniforms from the port's generator (the card's
        # torch.multinomial scans its own float cumulative sums, whose last
        # bits vary from run to run, so its draws would not replay)
        freq = np.array([counts[w] for w in vocab], dtype=np.float64) ** 0.75
        cdf = torch.as_tensor(np.cumsum(freq / freq.sum()), device=dev)
        w_out = torch.zeros((n_vocab, dim), dtype=self._dtype, device=dev)
        n_neg, lr = self.get("negative"), self.get("stepSize")
        given = iter(self._given_negatives) \
            if self._given_negatives is not None else None
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(self.get("seed")))
        n_pairs = len(centers)
        for _epoch in range(self.get("maxIter")):
            perm = torch.as_tensor(rng.permutation(n_pairs), device=dev)
            for s0 in range(0, n_pairs, BATCH):
                sel = perm[s0: s0 + BATCH]
                b = sel.shape[0]
                if given is not None:
                    negs = torch.as_tensor(np.array(next(given)),
                                           dtype=torch.int64, device=dev)
                else:
                    u = torch.rand(b * n_neg, generator=gen, device=dev,
                                   dtype=torch.float64)
                    negs = torch.searchsorted(cdf, u, right=True).clamp_(
                        max=n_vocab - 1).view(b, n_neg)
                ns_step(w_in, w_out, cent[sel], ctxs[sel], negs, lr, reduce)
        m = Word2VecModel(vocab, w_in.cpu().numpy().astype(np.float64),
                          uid=self.uid)
        self._copy_values(m)
        return m._set_parent(self)

    def _fit_hs(self, vocab, counts, cent, ctxs, w_in, rng, reduce):
        """Hierarchical-softmax skip-gram (the reference's exact objective,
        Word2Vec.scala:73): a Huffman tree over word frequencies gives each
        word a root path of inner nodes + branch bits; each (center,
        context) pair updates the CONTEXT word's input vector against the
        CENTER word's path (word2vec.c / the reference's orientation). The
        per-epoch mean loss is recorded on the model (``training_loss_``),
        the batches' losses summed on the device in float64 and read once
        an epoch."""
        dev = w_in.device
        n_vocab, dim = len(vocab), self.get("vectorSize")
        lr = self.get("stepSize")
        points, codes, lengths = _huffman_paths(
            np.array([counts[w] for w in vocab], dtype=np.int64))
        L = points.shape[1]
        pts = torch.as_tensor(points.astype(np.int64), device=dev)
        cds = torch.as_tensor(codes, dtype=self._dtype, device=dev)
        msk = torch.as_tensor(np.arange(L)[None, :] < lengths[:, None],
                              dtype=self._dtype, device=dev)
        w_node = torch.zeros((max(n_vocab - 1, 1), dim), dtype=self._dtype,
                             device=dev)
        n_pairs = cent.shape[0]
        loss_history = []
        for _epoch in range(self.get("maxIter")):
            perm = torch.as_tensor(rng.permutation(n_pairs), device=dev)
            total = torch.zeros((), dtype=torch.float64, device=dev)
            for s0 in range(0, n_pairs, BATCH):
                sel = perm[s0: s0 + BATCH]
                total += hs_step(w_in, w_node, cent[sel], ctxs[sel], pts,
                                 cds, msk, lr, reduce)
            loss_history.append(float(total) / n_pairs)

        m = Word2VecModel(vocab, w_in.cpu().numpy().astype(np.float64),
                          uid=self.uid)
        m.training_loss_ = loss_history
        self._copy_values(m)
        return m._set_parent(self)


def _huffman_paths(freqs: np.ndarray):
    """Huffman tree over word frequencies (ref createBinaryTree,
    Word2Vec.scala / word2vec.c CreateBinaryTree): returns
    ``(points (V, L) int32, codes (V, L) int8, lengths (V,))`` — for word w,
    ``points[w, :len]`` are the inner-node ids on the root→leaf path and
    ``codes[w, :len]`` the branch bits taken. Unused slots point at node 0
    with mask 0 (neutral under the masked update)."""
    import heapq
    v = len(freqs)
    if v == 1:
        return (np.zeros((1, 1), np.int32), np.zeros((1, 1), np.int8),
                np.ones(1, np.int64))
    # nodes 0..v-1 = leaves; v..2v-2 = inner nodes in creation order
    heap = [(int(f), i) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    parent = np.zeros(2 * v - 1, np.int64)
    branch = np.zeros(2 * v - 1, np.int8)
    nxt = v
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        parent[n1], parent[n2] = nxt, nxt
        branch[n2] = 1  # the heavier/second pop takes the 1-branch
        heapq.heappush(heap, (f1 + f2, nxt))
        nxt += 1
    root = nxt - 1
    lengths = np.zeros(v, np.int64)
    paths, codes_l = [], []
    for w in range(v):
        path, code = [], []
        node = w
        while node != root:
            code.append(int(branch[node]))
            node = parent[node]
            path.append(node - v)  # inner-node id in [0, v-1)
        path.reverse()
        code.reverse()
        paths.append(path)
        codes_l.append(code)
        lengths[w] = len(path)
    L = int(lengths.max())
    points = np.zeros((v, L), np.int32)
    codes = np.zeros((v, L), np.int8)
    for w in range(v):
        points[w, :lengths[w]] = paths[w]
        codes[w, :lengths[w]] = codes_l[w]
    return points, codes, lengths


class Word2VecModel(Model, _W2VParams, MLWritable, MLReadable):
    def __init__(self, vocabulary: Optional[List[str]] = None,
                 vectors: Optional[np.ndarray] = None, uid=None):
        super().__init__(uid)
        self._p_w2v()
        self.vocabulary = list(vocabulary or [])
        self.vectors = np.asarray(vectors) if vectors is not None else None
        self._index = {w: i for i, w in enumerate(self.vocabulary)}

    def get_vectors(self) -> MLFrame:
        from cycloneml_tpu_torch.context import CycloneContext
        return MLFrame(CycloneContext.get_or_create(), {
            "word": np.asarray(self.vocabulary, dtype=object),
            "vector": self.vectors})

    def _transform(self, frame):
        """Document vector = mean of word vectors (ref
        Word2VecModel.transform)."""
        dim = self.vectors.shape[1]
        col = frame[self.get("inputCol")]
        out = np.zeros((len(col), dim))
        for i, toks in enumerate(col):
            idxs = [self._index[str(t)] for t in toks if str(t) in self._index]
            if idxs:
                out[i] = self.vectors[idxs].mean(axis=0)
        return frame.with_column(self.get("outputCol"), out)

    def find_synonyms(self, word: str, num: int) -> List[Tuple[str, float]]:
        if word not in self._index:
            raise KeyError(f"word {word!r} not in vocabulary")
        v = self.vectors[self._index[word]]
        return self._find_by_vector(v, num, exclude=word)

    def find_synonyms_by_vector(self, vector: np.ndarray, num: int):
        return self._find_by_vector(np.asarray(vector), num)

    def _find_by_vector(self, v, num, exclude=None):
        norms = np.linalg.norm(self.vectors, axis=1) * max(
            np.linalg.norm(v), 1e-12)
        sims = self.vectors @ v / np.maximum(norms, 1e-12)
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocabulary[i]
            if w != exclude:
                out.append((w, float(sims[i])))
            if len(out) >= num:
                break
        return out

    def _save_data(self, path):
        import json
        import os
        save_arrays(path, vectors=self.vectors)
        with open(os.path.join(path, "vocabulary.json"), "w") as fh:
            json.dump(list(self.vocabulary), fh)

    def _load_data(self, path, meta):
        import json
        import os
        self.vectors = load_arrays(path)["vectors"]
        with open(os.path.join(path, "vocabulary.json")) as fh:
            self.vocabulary = json.load(fh)
        self._index = {w: i for i, w in enumerate(self.vocabulary)}
